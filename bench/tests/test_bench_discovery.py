"""A configuration, a traffic mix, a cell and a metric are added as files
plus entries in `BENCHMARK.json`, with no file of the harness edited: the
harness finds them by name and runs the new cell."""
from __future__ import annotations

import json
import shutil
import time

import torch
from conftest import BENCH, ROOT, TINY_GRAPH

from benchlib import harness, spec


def test_new_files_and_entries_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    # a configuration: its file of sizes
    config = json.loads((BENCH / "configs" / "gcn-nell-fp32.json").read_text())
    config.update(name="gcn-tiny-fp32")
    config["graph"].update(TINY_GRAPH, graph_seed=5)
    config["model"]["layer_dims"] = [TINY_GRAPH["n_features"], 64, TINY_GRAPH["n_labels"]]
    config.pop("derived_sizes")
    (root / "bench" / "configs" / "gcn-tiny-fp32.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "gcn-tiny-fp32", "source": "https://arxiv.org/abs/1609.02907",
                             "file": "bench/configs/gcn-tiny-fp32.json", "reduced": ["n_nodes"], "why": "test"})
    # a traffic mix: a data file the general loop reads
    (root / "bench" / "traffic" / "infer_all.json").write_text(json.dumps(
        {"name": "infer_all", "loop": "infer", "refresh_fraction": 1.0, "warmup": 1}))
    # a cell and its limits
    bench["workloads"].append({"name": "tiny_fp32.infer_all", "config": "gcn-tiny-fp32", "traffic": "infer_all",
                               "chips": 1, "why": "test"})
    (root / "bench" / "limits" / "tiny_fp32.infer_all.json").write_text(json.dumps(
        {"layer1_gap": 1e-5, "logit_gap": 1e-5, "class_gap": 1e-5}))
    # a metric: its reader, and its entry
    (root / "bench" / "metrics" / "infer_p50_ms.py").write_text(
        "def read(ctx):\n    w = ctx.window\n    return None if w.kind != 'request' else w.percentile(50.0) * 1e3\n")
    bench["end_to_end"].append({"name": "infer_p50_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": ["tiny_fp32.infer_all"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("infer_ms", "infer_p95_ms"):
            m["workloads"].append("tiny_fp32.infer_all")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("tiny_fp32.infer_all", root=root)
    assert cell.traffic["refresh_fraction"] == 1.0 and cell.config["name"] == "gcn-tiny-fp32"
    assert [m["name"] for m in cell.end_to_end] == ["infer_ms", "infer_p95_ms", "setup_s", "infer_p50_ms"]
    result = harness.run_cell(cell, 99, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"infer_ms", "infer_p95_ms", "setup_s", "infer_p50_ms"}
    # the cells that were there before are found as they were
    assert spec.find_cell("nell_q4.infer", root=root).config["model"]["quant"]["weight_bits"] == 4
