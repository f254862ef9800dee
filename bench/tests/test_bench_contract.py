"""`BENCHMARK.json`'s shape, the result line's contract, and what a run may
load: no module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package; top-level names compared whole, as ``repro_torch`` begins with
``repro``), and nothing of the program in the reference."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT, tiny_cell

from benchlib import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"] == ["python3", "bench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
    names = [w["name"] for w in b["workloads"]]
    assert names == ["nell_q4.infer", "nell_fp32.infer", "nell_q4.train", "nell_fp32.train"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        cell = spec.find_cell(w["name"], bench=b)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.metric_file(m["name"]).is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert len(json.dumps(b)) < 64 * 1024


def test_result_line_contract():
    result = harness.run_cell(tiny_cell("nell_fp32.infer"), 5, 0.2, False, torch.device("cpu"),
                              time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"infer_ms", "infer_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "nell_fp32.infer", "--seed", "1",
                           "--seconds", "1", "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bench_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_nothing_of_jax_is_loaded():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(ROOT / 'src')!r}]\n"
        "from conftest import tiny_cell, WORKLOADS\n"
        "from benchlib import harness\n"
        "for w in WORKLOADS:\n"
        "    harness.run_cell(tiny_cell(w), 1, 0.1, False, torch.device('cpu'), time.perf_counter())\n"
        "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] True"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "inputs.py"):
        tree = ast.parse((BENCH / "families" / "gcn" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert all(m.split(".")[0] in ("__future__", "math", "numpy", "torch") for m in mods), (name, mods)
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "import families.gcn.reference, families.gcn.inputs\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


@pytest.mark.cuda
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "nell_fp32.infer", "--seed", "3",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["metrics"]["infer_ms"]["value"] > 0
