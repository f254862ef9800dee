"""Per-family sharding rules — twin of `repro.launch.shardings`.

The rules are the reference's, path by path over the parameter trees; a
spec is a tuple with one entry per dimension, each ``None``, an axis name
or a tuple of axis names — the entries of the reference's
``PartitionSpec``, normalized as ``PartitionSpec`` normalizes them (a
one-name tuple is the name), so that a test compares the two leaf by
leaf. The layout:

  LM     — Megatron TP over ``model`` (QKV/up column-, O/down row-parallel),
           vocab-sharded embedding/logits, expert-parallel MoE weights,
           batch over the data axes.
  GNN    — the halo policy of `repro_torch.dist.policy` (the reference's
           default full-graph schedule), or the sampled cells' batch specs.
  recsys — the embedding table row-sharded over ``model``; batch over the
           data axes; the MLP replicated.

KV caches shard over kv-heads when they divide by the model size,
otherwise over the sequence (batch 1 cells shard the sequence over every
axis). K/V projections are replicated when kv-heads do not divide.

The grid is `repro_torch.launch.mesh.Grid` (the reference's mesh: axis
names and sizes). `shard_tree` cuts a whole tree (torch tensors or the
reference's numpy arrays) into one rank's shard: with `params_from_numpy`
it carries the reference's weights onto a rank.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.dist.policy import ShardingPolicy
from repro_torch.launch.mesh import Grid, data_axes

__all__ = [
    "lm_param_specs",
    "lm_policy",
    "gnn_policy",
    "recsys_policy",
    "replicated_specs",
    "recsys_param_specs",
    "cache_spec",
    "spec",
    "shard_slices",
    "shard_tree",
]


def spec(*entries) -> tuple:
    """A spec with ``PartitionSpec``'s normalization: a one-name tuple is
    the name, an empty tuple is ``None``."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e

    return tuple(norm(e) for e in entries)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], (*path, k)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


# ------------------------------------------------------------------------ LM
def lm_param_specs(param_tree: Any, cfg, grid: Grid) -> Any:
    """The spec tree mirroring the LM's parameter tree."""
    kv_shardable = cfg.n_kv_heads % grid.shape["model"] == 0

    def rule(path, leaf) -> tuple:
        name = "/".join(str(k) for k in path)
        nd = len(leaf.shape)
        if "embed" in name or "lm_head" in name:
            return spec("model", None) if "embed" in name else spec(None, "model")
        if name.endswith("wq"):
            return spec(None, None, "model")
        if name.endswith("wk") or name.endswith("wv"):
            return spec(None, None, "model") if kv_shardable else spec(None, None, None)
        if name.endswith("wo"):
            return spec(None, "model", None)
        if "mlp" in name and name.endswith("w_down"):
            return spec(None, "model", None)
        if "mlp" in name and ("w_gate" in name or "w_up" in name):
            return spec(None, None, "model")
        if "moe" in name and "router" in name:
            return spec(None, None, None)
        if "moe" in name and nd == 4:          # (L, E, D, F): expert parallel
            return spec(None, "model", None, None)
        return spec(*([None] * nd))

    return _map_with_path(rule, param_tree)


def lm_policy(grid: Grid, cfg) -> ShardingPolicy:
    da = data_axes(grid)
    return ShardingPolicy(
        grid=grid,
        specs={
            "act": spec(da, None, None),
            "ffn_hidden": spec(da, None, "model"),
            "logits": spec(da, None, "model"),
            "dec_act": spec(da, None, None),
            "dec_logits": spec(da, "model"),
            "moe_buf": spec(da, "model", None, None),
        },
    )


def cache_spec(cfg, shape_spec, grid: Grid) -> tuple:
    """KV cache (L, B, S, Hk, Dh) spec for decode cells."""
    da = data_axes(grid)
    msize = grid.shape["model"]
    batch = shape_spec.global_batch
    n_data = math.prod(grid.shape.get(a, 1) for a in da)
    if batch is not None and batch >= n_data and batch % n_data == 0:
        if cfg.n_kv_heads % msize == 0:
            return spec(None, da, None, "model", None)
        return spec(None, da, "model", None, None)          # sequence-sharded
    # batch too small (long-context, batch 1): shard sequence over everything.
    return spec(None, None, tuple(grid.axis_names), None, None)


# ----------------------------------------------------------------------- GNN
def replicated_specs(param_tree: Any) -> Any:
    return _map_with_path(lambda path, leaf: spec(*([None] * len(leaf.shape))), param_tree)


def gnn_policy(grid: Grid, batched: bool, comm: str = "halo", halo_payload: str | None = None,
               halo_overlap: bool = True) -> ShardingPolicy:
    """The GNN policy. Batched (sampled-block) cells carry the reference's
    batch specs. Full-graph cells: ``"halo"`` (the default) is the port's
    halo policy (`repro_torch.dist.policy`), armed per rank by
    ``bind_halo`` — on a grid with a pod axis wider than one, the rank
    binds the hierarchical pair and sets ``halo_groups``
    (`repro_torch.launch.mesh.halo_groups`), the reference's
    ``halo_axes=("pod", "model")``; ``"broadcast"`` carries the
    reference's node specs, and a rank that binds it (`ShardingPolicy.bind`)
    all-gathers the node table over its model group every layer (the
    neighbor table of an unbound one is the identity)."""
    da = data_axes(grid)
    if batched:
        return ShardingPolicy(grid=grid, specs={
            "node_hidden": spec(da, None, None),
            "edge_hidden": spec(da, None, None),
            "irrep_hidden": spec(da, None, None, None),
        })
    if comm not in ("halo", "broadcast"):
        raise ValueError(f"unknown comm mode {comm!r} (expected 'halo' or 'broadcast')")
    if comm == "halo":
        return ShardingPolicy(grid=grid, comm="halo", halo_payload=halo_payload, halo_overlap=halo_overlap,
                              graph=True)
    return ShardingPolicy(grid=grid, graph=True, specs={
        "node_hidden": spec("model", None),
        "edge_hidden": spec("model", None),
        "irrep_hidden": spec("model", None, None),
    })


# -------------------------------------------------------------------- recsys
def recsys_param_specs(param_tree: Any) -> Any:
    def rule(path, leaf) -> tuple:
        name = "/".join(str(k) for k in path)
        nd = len(leaf.shape)
        if "table" in name:
            return spec("model", None)
        if "w_linear" in name:
            return spec("model")
        return spec(*([None] * nd))

    return _map_with_path(rule, param_tree)


def recsys_policy(grid: Grid) -> ShardingPolicy:
    da = data_axes(grid)
    return ShardingPolicy(grid=grid, specs={"emb": spec(da, None, None), "cand": spec(None, "model", None)})


# ------------------------------------------------------------------- shards
def shard_slices(shape, leaf_spec: tuple, coords: dict) -> tuple[slice, ...]:
    """One rank's block of an array of ``shape`` under ``leaf_spec``:
    ``coords`` maps each axis to (the rank's index, the axis size)
    (`Grid.coords`); an entry naming several axes splits over their
    product, raveled in the order named. Axes the coords lack count as
    size 1. Every split must be even."""
    out = []
    for dim, entry in zip(shape, leaf_spec, strict=True):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        idx, n = 0, 1
        for a in axes:
            i, size = coords.get(a, (0, 1))
            idx, n = idx * size + i, n * size
        if dim % n:
            raise ValueError(f"dimension {dim} does not split evenly over {axes} ({n} ranks)")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_tree(tree: Any, specs: Any, coords: dict) -> Any:
    """The rank at ``coords`` holds this block of every leaf of ``tree``
    (a copy, so that the whole tree can be freed)."""
    def cut(leaf, leaf_spec):
        block = leaf[shard_slices(leaf.shape, leaf_spec, coords)]
        return block.clone() if isinstance(block, torch.Tensor) else np.array(block)

    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], coords) for k in sorted(tree)}
    if isinstance(tree, list):
        return [shard_tree(v, s, coords) for v, s in zip(tree, specs, strict=True)]
    return cut(tree, specs)
