"""The port's telemetry bridges (`repro_torch.obs.instrument`, the launch
flags of `repro_torch.launch.obsflags`, `torch_profiler_trace`) against the
JAX package's, on the CPU.

* The delta, relocalize and compact recorders take plain dicts; fed the
  very reports the reference's `DeltaPlanner` returns (apply with drift
  measured, as tests/test_obs_integration.py:172, then a relocalize and a
  compact), their metric snapshots equal the reference recorders'.
* `obs_session` writes both files; a registry and a recorder survive a
  pickle (a rank process hands them to the process that exports them).
* The launcher twin of ``examples/train_distributed_gcn.py`` run with
  ``--pods 2 --trace --metrics`` (4 gloo ranks, 2 pods × 2): its trace has
  a ``halo.exchange.boundary_collective`` span on the ``wire`` track that
  encloses an ``overlap.interior_compute`` span, and its snapshot has the
  wire-bytes identity of tests/test_obs_integration.py:203-240.
* `torch_profiler_trace` writes a trace file into its directory.
"""
import argparse
import json
import pickle

import numpy as np
import pytest
import torch

from repro.core.partition import partition_graph as j_partition_graph
from repro.dist.delta import DeltaPlanner, GraphDelta
from repro.graph.generators import citation_like as j_citation_like
from repro.obs import instrument as j_instrument
from repro.obs import metrics as j_metrics
from repro_torch.launch.obsflags import add_obs_args, obs_session
from repro_torch.obs import instrument, metrics, trace


def _snapshot(metrics_mod, fn, *reports):
    """``fn`` over ``reports`` into a fresh registry of ``metrics_mod``."""
    old = metrics_mod.set_default_registry(metrics_mod.MetricsRegistry())
    was = metrics_mod.enabled()
    metrics_mod.enable()
    try:
        for rep in reports:
            fn(rep)
        return metrics_mod.snapshot()
    finally:
        metrics_mod.disable()
        metrics_mod.set_default_registry(old)
        if was:
            metrics_mod.enable()


@pytest.fixture(scope="module")
def reports():
    """The reference planner's own reports (metrics off while it runs):
    an apply that measured drift, a relocalize and a compact."""
    g = j_citation_like(256, 1500, seed=7)
    part = j_partition_graph(256, g.edge_index, 4, method="bfs", seed=7, refine=True)
    pl = DeltaPlanner(part, g.edge_index, np.ones(g.n_edges, np.float32))
    pl.plan()
    rng = np.random.default_rng(0)
    ins = np.stack([rng.integers(0, 256, 12), rng.integers(0, 256, 12)]).astype(np.int64)
    apply = pl.apply(GraphDelta(edge_inserts=ins), measure_drift=True, drift_block=64)
    dels = g.edge_index[:, :20].astype(np.int64)
    apply2 = pl.apply(GraphDelta(edge_deletes=dels))
    reloc = pl.relocalize(block=64)
    compact = pl.compact()
    return {"apply": apply, "apply2": apply2, "relocalize": reloc, "compact": compact}


def _plain(rep: dict) -> dict:
    """The report as the plain dict the port's recorders read (its numbers
    as Python/numpy scalars, no reference objects)."""
    keep = ("inserts", "deletes", "senders_remapped", "blocked_patched", "dirty_devices", "structural",
            "apply_ms", "drift", "relocalize_ms", "executed_tiles_before", "executed_tiles_after",
            "bytes_reclaimed", "pad_occupancy", "compact_ms")
    return {k: rep[k] for k in keep if k in rep}


@pytest.mark.parametrize("name,kinds", [
    ("record_delta_report", ("apply", "apply2")),
    ("record_relocalize_report", ("relocalize",)),
    ("record_compact_report", ("compact",)),
])
def test_report_recorders_match_jax(reports, name, kinds):
    """Identical dicts in, identical snapshots out (the apply recorder twice:
    its counters add up)."""
    reps = [_plain(reports[k]) for k in kinds]
    ours = _snapshot(metrics, getattr(instrument, name), *reps)
    theirs = _snapshot(j_metrics, getattr(j_instrument, name), *reps)
    assert ours == theirs and ours


def test_delta_report_gauges_and_drift(reports):
    """tests/test_obs_integration.py:172's pins on the port's snapshot."""
    rep = reports["apply"]
    snap = _snapshot(metrics, instrument.record_delta_report, _plain(rep))
    assert snap["delta.applies"]["value"] == 1.0
    assert snap["delta.inserts"]["value"] == rep["inserts"] == 12
    assert snap["delta.dirty_devices"]["value"] == len(rep["dirty_devices"])
    assert snap["delta.structural"]["value"] == float(bool(rep["structural"]))
    assert snap["delta.apply_ms"]["count"] == 1 and snap["delta.apply_ms"]["sum"] == rep["apply_ms"]
    d = rep["drift"]
    assert snap["delta.drift_ratio"]["value"] == d["drift_ratio"]
    assert snap["delta.executed_tiles_current"]["value"] == d["executed_tiles_current"]
    assert snap["delta.executed_tiles_reordered"]["value"] == d["executed_tiles_reordered"]


def test_recorders_do_nothing_while_disabled():
    assert not metrics.enabled()
    before = len(metrics.default_registry())
    instrument.record_delta_report({"inserts": 3})
    instrument.record_relocalize_report({})
    instrument.record_compact_report({"bytes_reclaimed": 5})
    assert len(metrics.default_registry()) == before


def test_obs_session_writes_both_files(tmp_path, capsys):
    ap = argparse.ArgumentParser()
    add_obs_args(ap)
    args = ap.parse_args(["--metrics", str(tmp_path / "m.json"), "--trace", str(tmp_path / "t.json")])
    old_reg, old_tr = metrics.default_registry(), trace.default_tracer()
    try:
        with obs_session(args):
            metrics.inc("unit.events", 2)
            with trace.span("unit.span"):
                pass
    finally:
        metrics.disable()
        metrics.set_default_registry(old_reg)
        trace.set_default_tracer(old_tr)
    assert json.loads((tmp_path / "m.json").read_text())["unit.events"]["value"] == 2.0
    names = [e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]]
    assert "unit.span" in names
    out = capsys.readouterr().out
    assert "metrics snapshot →" in out and "chrome trace →" in out


def test_registry_and_recorder_pickle():
    reg = metrics.MetricsRegistry()
    reg.counter("a", (("phase", "x"),)).inc(3)
    reg.histogram("h").observe(2.5)
    assert pickle.loads(pickle.dumps(reg)).snapshot() == reg.snapshot()
    rec = trace.TraceRecorder()
    with rec.span("s", track="wire"):
        pass
    back = pickle.loads(pickle.dumps(rec))
    assert back.events() == rec.events() and back.track_tid("wire") == rec.track_tid("wire")
    with back.span("after"):
        pass


def test_torch_profiler_trace_writes_a_trace(tmp_path):
    with trace.torch_profiler_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.fixture(scope="module")
def traced_launch(tmp_path_factory):
    """The launcher twin, 4 CPU ranks as 2 pods × 2, 12 steps, traced."""
    from repro_torch.launch.distributed_gcn import main

    work = tmp_path_factory.mktemp("traced")
    old_reg, old_tr = metrics.default_registry(), trace.default_tracer()
    try:
        run = main(["--device", "cpu", "--pods", "2", "--steps", "12", "--ckpt-dir", str(work / "ckpt"),
                    "--trace", str(work / "trace.json"), "--metrics", str(work / "metrics.json")])
    finally:
        metrics.disable()
        metrics.set_default_registry(old_reg)
        trace.set_default_tracer(old_tr)
    return run, json.loads((work / "trace.json").read_text()), json.loads((work / "metrics.json").read_text())


def test_traced_launch_shows_overlap(traced_launch):
    """The wire span encloses an interior span, and every wire span lives on
    the ``wire`` track (the reference's check, on the port's artifact)."""
    run, doc, _ = traced_launch
    assert run["plan"].is_hierarchical
    ev = doc["traceEvents"]
    wire = [e for e in ev if e.get("name") == "halo.exchange.boundary_collective"]
    interior = [e for e in ev if e.get("name") == "overlap.interior_compute"]
    assert wire and interior
    assert any(w["ts"] <= i["ts"] and i["ts"] + i["dur"] <= w["ts"] + w["dur"] for w in wire for i in interior)
    tracks = {e["tid"]: e["args"]["name"] for e in ev if e["ph"] == "M" and e["name"] == "thread_name"}
    assert all(tracks.get(e["tid"]) == "wire" for e in wire)
    assert sum(e.get("name") == "train.step" for e in ev) == 12


def test_traced_launch_metrics_mirror_the_plan(traced_launch):
    """The snapshot's wire bytes per exchange are the plan's rows × the
    64-wide input features × 4 bytes; the hierarchical tiers are the plan's;
    the 12 steps are counted; the plan cache saw a hit and a miss."""
    run, _, snap = traced_launch
    plan = run["plan"]
    rows = snap["halo.rows_per_device{tier=total}"]["value"]
    assert rows == plan.halo_rows_per_device
    assert snap["halo.wire_bytes_per_exchange"]["value"] == rows * 64 * 4
    assert snap["halo.rows_per_device{tier=inter_pod_crossing}"]["value"] == plan.inter_pod_rows_crossing
    assert snap["halo.rows_per_device{tier=intra_pod}"]["value"] == plan.intra_pod_rows_per_device
    assert snap["train.steps"]["value"] == 12.0 and snap["train.step_ms"]["count"] == 12
    assert snap["plan_cache.hits"]["value"] >= 1 and snap["plan_cache.misses"]["value"] >= 1
    # Rank 0's wire: the first gradient and the 12 steps (2 layers, each
    # exchange forward and backward), then the trained forward; the phase
    # series count the forward exchanges' rows.
    forwards = 1 + 12 + 1
    assert snap["halo.wire_rows"]["value"] == (13 * 4 + 2) * plan.halo_rows_per_device
    assert snap["halo.wire_rows{phase=inter_pod}"]["value"] == forwards * 2 * plan.inter_pod_rows_per_device
    assert snap["halo.wire_rows{phase=intra_pod}"]["value"] == forwards * 2 * plan.intra_pod_rows_per_device
