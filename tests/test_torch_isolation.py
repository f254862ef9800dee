"""The port stands alone: no JAX, no `repro`, no silent move to the host.

* Importing every `repro_torch` module and `chip_smoke` loads neither `jax`
  nor `repro` (whose `__init__` installs JAX shims), nor `msgpack`, which the
  card's machine lacks (the reference's checkpoints use it).
* With CUDA absent, ``device=None`` raises instead of running on the CPU,
  and so does the sharded training command before it starts a rank.
* `chip_smoke.py` exits non-zero, printing no result, without a card and
  when it is alone in a directory.
"""
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.graph.structure import blocked_adjacency, to_padded
from repro_torch.graph.generators import citation_like
from repro_torch.launch import distributed_gcn
from repro_torch.models.gcn import GCNConfig, gcn_init, params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(code: str, cwd=ROOT, env_extra=None) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(SRC), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(ROOT)!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        chip_smoke.halo_variants(), chip_smoke.halo_train_variants()   # the halo phases' imports
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "msgpack"))
        assert not bad, bad
        print("OK", len(names))
    """)
    out = _run(code)
    assert out.returncode == 0 and out.stdout.startswith("OK"), out.stderr[-3000:]
    assert int(out.stdout.split()[1]) >= 27


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = citation_like(200, 600, seed=0)
    cfg = GCNConfig(layer_dims=(4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_padded(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blocked_adjacency(200, g.edge_index).arrays()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w0": np.zeros((4, 3), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_gcn.main(["--steps", "1"])        # sharded training: before any rank starts
    assert repro_torch.device.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": ""}
    code = "import runpy, sys; sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')"
    out = _run(code, env_extra=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
