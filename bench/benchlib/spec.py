"""`BENCHMARK.json` and the files it names, found by name.

* a configuration: its entry's ``file`` (under ``bench/configs/``);
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a cell's limits of the comparison: ``bench/limits/<workload>.json``;
* a metric, end-to-end or per-layer: ``bench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the value or None where it finds nothing to read;
  a metric split by the end-to-end metric it moves (``<quantity>.<part>``)
  is read by ``bench/metrics/<quantity>.py`` where the part has no file of
  its own.

Adding a configuration, a mix, a cell or a metric is adding such files and
entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: pathlib.Path = BENCH


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)], bench_dir=bench_dir)


def metric_file(metric: str, bench_dir: pathlib.Path = BENCH) -> pathlib.Path:
    own = bench_dir / "metrics" / f"{metric}.py"
    if own.is_file() or "." not in metric:
        return own
    return bench_dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def reader(metric: str, bench_dir: pathlib.Path = BENCH):
    """The ``read`` function of the metric's file (`metric_file`)."""
    path = metric_file(metric, bench_dir)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
