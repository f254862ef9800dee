"""Atomic, resumable checkpointing — twin of `repro.train.checkpoint`.

Layout:  <dir>/step_<N>/
            manifest.json   — tree structure, leaf shapes/dtypes, metadata
            arrays.npz      — one entry per leaf (host copies)
Writes go to <dir>/.tmp_step_<N> then os.replace() — a crash mid-save never
corrupts the latest complete checkpoint (the fault-tolerance contract the
train loop's restart path relies on). Only directories whose manifest
exists count as checkpoints, and all but the newest ``keep`` are removed
after each save.

The manifest is JSON where the reference writes msgpack, so that the port
needs no package beyond torch and numpy. Restore places each tensor leaf on
the device of the matching leaf of ``like`` (the CPU where that leaf is no
tensor).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import tree_leaves, tree_structure, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "available_steps"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_MANIFEST = "manifest.json"


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    tree: Any,
    metadata: dict | None = None,
    keep: int = 3,
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_leaves(tree)
    arrays, specs = {}, []
    for i, leaf in enumerate(leaves):
        if leaf is None:
            specs.append({"kind": "none"})
            continue
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        arrays[f"leaf_{i}"] = arr
        specs.append({"kind": "array", "dtype": str(arr.dtype), "shape": list(arr.shape)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "structure": tree_structure(tree),
        "n_leaves": len(leaves),
        "specs": specs,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _cleanup(ckpt_dir, keep)
    return final


def _cleanup(ckpt_dir: str, keep: int) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: int | None = None) -> tuple[int, Any, dict]:
    """Restore into the structure of ``like`` (values replaced, structure
    kept); raises if the checkpoint's structure or shapes differ."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["structure"] != tree_structure(like):
        raise ValueError(f"checkpoint/model structure mismatch in {path}")
    like_leaves = tree_leaves(like)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, ref_leaf in enumerate(like_leaves):
            spec = manifest["specs"][i]
            if spec["kind"] == "none":
                out.append(None)
                continue
            arr = data[f"leaf_{i}"]
            if hasattr(ref_leaf, "shape") and tuple(arr.shape) != tuple(ref_leaf.shape):
                raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs model {tuple(ref_leaf.shape)}")
            device = ref_leaf.device if isinstance(ref_leaf, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(device))
    return step, tree_unflatten(like, out), manifest["metadata"]
