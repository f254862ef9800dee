"""The port's drivers of a served, mutating graph against the reference's,
on the CPU.

* ``repro_torch.launch.serve --arch coin-gcn --device cpu`` prints the same
  counts as ``repro.launch.serve --arch coin-gcn`` — queries,
  micro-batches, traces, nodes and edges per query, foreign rows, the
  cache's hits, misses, residents, evictions, rows and bytes saved, and
  with ``--relocalize-threshold`` the fires and the residual drift. They
  are host numbers: none depends on the parameters (each package draws
  its own) or on the clock.
* ``repro_torch.launch.train --arch coin_gcn --relocalize-threshold T``
  prints the reference's ``relocalize @ step N`` lines at the same steps.
* ``repro_torch.launch.serve_graph_queries`` prints the reference
  example's wave lines and cache accounting (latency aside).
"""
import contextlib
import io
import pathlib
import re
import runpy
import sys

import pytest
import torch

from repro_torch.launch import serve as port_serve
from repro_torch.launch import serve_graph_queries
from repro_torch.launch import train as port_train

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "serve_graph_queries.py"
TIMES = re.compile(r"in [0-9.]+ ms \([0-9]+ q/s\)|p50=[0-9.]+ ms p99=[0-9.]+ ms|dt=[0-9.]+ms")


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _counts(text: str) -> list[str]:
    """The printed lines with every time taken out."""
    return [TIMES.sub("<time>", line) for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("flags", [
    [],
    ["--no-cache"],
    ["--queries", "96", "--batch-seeds", "4", "--fanout", "3", "--cache-capacity", "16", "--parts", "2"],
    ["--parts", "0"],
    ["--relocalize-threshold", "1.01"],
    ["--queries", "80", "--relocalize-threshold", "1.2"],
])
def test_serve_coin_gcn_counts_match_reference(flags):
    from repro.launch import serve as ref_serve

    mine = _stdout(port_serve.main, ["--arch", "coin-gcn", "--device", "cpu", *flags])
    ref = _stdout(ref_serve.main, ["--arch", "coin-gcn", *flags])
    assert _counts(mine) == _counts(ref)
    assert "1 trace" in mine
    if "--relocalize-threshold" in flags:
        assert "maintenance:" in mine


def test_serve_coin_gcn_fires_at_the_cli_threshold():
    mine = _stdout(port_serve.main, ["--arch", "coin-gcn", "--device", "cpu", "--relocalize-threshold", "1.01"])
    fires = int(re.search(r"maintenance: (\d+) relocalization", mine).group(1))
    assert fires >= 1


def test_serve_coin_gcn_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--arch", "coin-gcn"])


@pytest.mark.parametrize("threshold", ["0.5", "1.0"])
def test_train_relocalize_lines_match_reference(threshold):
    from repro.launch import train as ref_train

    args = ["--arch", "coin_gcn", "--steps", "100", "--relocalize-threshold", threshold]
    mine = _stdout(port_train.main, [*args, "--device", "cpu"])
    ref = _stdout(ref_train.main, args)
    lines = [ln for ln in mine.splitlines() if "relocalize @" in ln]
    assert lines == [ln for ln in ref.splitlines() if "relocalize @" in ln]
    if threshold == "0.5":
        assert len(lines) == 2


def test_train_relocalize_threshold_is_gcn_only():
    with pytest.raises(SystemExit, match="GNN archs only"):
        port_train.main(["--arch", "deepfm", "--steps", "1", "--device", "cpu", "--relocalize-threshold", "1.1"])


def test_serve_graph_queries_twin_matches_reference_example(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_graph_queries.py"])
    ref = _stdout(runpy.run_path, str(EXAMPLE), None, "__main__")
    mine = _stdout(serve_graph_queries.main, ["--device", "cpu"])
    assert _counts(mine) == _counts(ref)
    assert any(line.startswith("wave 4:") for line in mine.splitlines())
    assert "traces still 1 (no retrace)" in mine
