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
* `trace.span` with no listener is the shared no-op context and allocates
  nothing; under a running `torch.profiler` the program's spans
  (``quant.fake_quant``, ``kernels.pad_rows``, ``sync.*``,
  ``train.backward``, ``train.optimizer``) are profiler events around the
  aten ops they enclose; with the recorder on as well, its Chrome export
  holds the same names.
"""
import argparse
import dataclasses
import json
import pickle
import tracemalloc

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


# ------------------------------------------------ spans on the profiler's clock
FORWARD_SPANS = {"quant.fake_quant", "kernels.pad_rows", "sync.nnz_blocks"}
STEP_SPANS = FORWARD_SPANS | {"train.step", "train.backward", "train.optimizer", "sync.tile_index"}


@pytest.fixture
def no_recorder():
    old = trace.set_default_tracer(None)
    yield
    trace.set_default_tracer(old)


@pytest.fixture(scope="module")
def tiny_gcn():
    """The reduced 4-bit coin_gcn (64 → 16 → 7, activations calibrated at
    the 99.9th percentile, so through `torch.topk`) on 300 nodes with the
    bsr backend, the tile tables handed over as tensors (whose tile count
    the forward reads back): X's 300 rows are padded to the 128-row grid by
    a copy.
    Returns ``(loss_fn, forward, params, batch)``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.generators import citation_like
    from repro_torch.graph.structure import blocked_adjacency
    from repro_torch.models.gcn import gcn_forward, gcn_init, gcn_loss

    cfg = dataclasses.replace(get_arch("coin_gcn").make_reduced(), backend="bsr")
    g = citation_like(300, 1200, seed=0)
    ones = np.ones(g.n_edges, np.float32)
    adj = blocked_adjacency(g.n_nodes, g.edge_index, ones).arrays(device="cpu")   # (vals, cols, lens), as served
    senders, receivers = (torch.from_numpy(g.edge_index[i]) for i in range(2))
    weight = torch.from_numpy(ones)
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = dict(x=torch.randn(g.n_nodes, 64, generator=torch.Generator().manual_seed(1)),
                 labels=torch.from_numpy(g.labels), mask=torch.ones(g.n_nodes))

    def loss_fn(p, b):
        return gcn_loss(p, b["x"], senders, receivers, weight, b["labels"], b["mask"], cfg, adjacency=adj)

    def forward(p, b):
        return gcn_forward(p, b["x"], senders, receivers, weight, cfg, adjacency=adj)

    return loss_fn, forward, params, batch


def _profiled(fn):
    """``fn()`` under a CPU `torch.profiler`; its events by name, each
    ``(start, end)`` on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out: dict[str, list] = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(a, spans) -> bool:
    return any(s[0] <= a[0] and a[1] <= s[1] for s in spans)


def _one_step(loss_fn, params, batch):
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import adamw

    tr = Trainer(loss_fn, adamw(1e-3), params, TrainerConfig(log_every=1 << 30))
    return tr.fit(iter(lambda: batch, None), max_steps=1)


def test_span_with_no_listener_is_the_shared_null_span(no_recorder):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("quant.fake_quant") is trace._NULL_SPAN
    names = ["quant.fake_quant"] * 10_000
    for name in names[:100]:
        with trace.span(name):
            pass
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for name in names:
            with trace.span(name) as h:
                h.sync = None
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    # A few hundred bytes of fixed cost; one small object a call would be ≥ 160 KB.
    assert peak - base < 1024, f"the idle span path allocated {peak - base} bytes over 10,000 calls"


def test_forward_spans_under_the_profiler(no_recorder, tiny_gcn):
    _, forward, params, batch = tiny_gcn
    with torch.no_grad():
        ev = _profiled(lambda: forward(params, batch))
    assert FORWARD_SPANS <= set(ev)
    assert len(ev["quant.fake_quant"]) == 4           # w and h of each layer
    assert ev["aten::topk"] and all(_inside(t, ev["quant.fake_quant"]) for t in ev["aten::topk"])
    assert all(_inside(c, ev["kernels.pad_rows"]) for c in ev["aten::cat"])
    assert any(_inside(s, ev["sync.nnz_blocks"]) for s in ev["aten::sum"])


def test_step_spans_under_the_profiler(no_recorder, tiny_gcn):
    loss_fn, _, params, batch = tiny_gcn
    ev = _profiled(lambda: _one_step(loss_fn, params, batch))
    assert STEP_SPANS <= set(ev)
    (step,), (bwd,), (opt,) = ev["train.step"], ev["train.backward"], ev["train.optimizer"]
    assert _inside(bwd, [step]) and _inside(opt, [step]) and bwd[1] <= opt[0]
    assert ev["sync.tile_index"] and all(_inside(s, [bwd]) for s in ev["sync.tile_index"])
    assert all(_inside(q, [step]) and q[1] <= bwd[0] for q in ev["quant.fake_quant"])


def test_recorder_and_profiler_see_the_same_spans(tiny_gcn):
    loss_fn, _, params, batch = tiny_gcn
    rec = trace.TraceRecorder()
    old = trace.set_default_tracer(rec)
    try:
        ev = _profiled(lambda: _one_step(loss_fn, params, batch))
    finally:
        trace.set_default_tracer(old)
    exported = {e["name"] for e in rec.to_chrome()["traceEvents"] if e["ph"] == "X"}
    assert exported == STEP_SPANS
    assert STEP_SPANS <= set(ev)


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
