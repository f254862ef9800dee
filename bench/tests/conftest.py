"""Shared pieces of the benchmark's own tests: the harness on the path, and
cells of the benchmark's configurations shrunk to a graph the CPU runs in
seconds (the card-sized cells run on the chip).

Run from the root of the repository: ``python -m pytest bench/tests``.
"""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_GRAPH = dict(n_nodes=600, n_edges=2400, n_features=300, n_labels=7)


def tiny_config(name: str) -> dict:
    """A configuration of the benchmark with its graph shrunk and its
    stated sizes dropped; everything else (hidden widths, quantization,
    dataflow, optimizer, precision) as the file states it."""
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    config["graph"].update(TINY_GRAPH)
    config["model"]["layer_dims"] = [TINY_GRAPH["n_features"], *config["model"]["layer_dims"][1:-1],
                                     TINY_GRAPH["n_labels"]]
    config.pop("derived_sizes")
    return config


def tiny_cell(workload: str):
    from benchlib import spec

    bench = spec.load_benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    config_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    cell = spec.find_cell(workload, bench=bench)
    cell.config = tiny_config(pathlib.Path(config_file).stem)
    return cell


@pytest.fixture
def cpu_cell():
    return tiny_cell


WORKLOADS = ["nell_q4.infer", "nell_fp32.infer", "nell_q4.train", "nell_fp32.train"]
