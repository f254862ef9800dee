"""The port's halo host side against the JAX package's: array-equal.

Plans (flat and hierarchical, with and without a pod map, k ∈ {2, 4, 8}),
their wire and interior/boundary accounting, the blocked tables (combined
and split, and one rank's slice built alone), their statistics, the plan
cache, the node relayout helpers, the wire payload codecs, the exchange
cost model and the obs gauges that mirror them. All host numpy or
elementwise torch, compared exactly (the int8 scale to the last bit).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as j_dataflow
from repro.core import quant as j_quant
from repro.core.partition import partition_graph as j_partition_graph
from repro.dist import halo as j_halo
from repro.obs import instrument as j_instrument
from repro.obs import metrics as j_metrics
from repro_torch.core import dataflow, quant
from repro_torch.core.partition import partition_graph
from repro_torch.dist import halo
from repro_torch.graph.generators import citation_like
from repro_torch.obs import instrument, metrics

PLAN_FIELDS = ("k", "n_local", "s_max", "e_local", "n_nodes", "perm", "send_idx", "senders_l",
               "receivers_l", "edge_w", "part_sizes", "axes", "n_pods", "s_loc", "s_rem",
               "send_loc", "send_rem")
PLAN_PROPS = ("is_hierarchical", "k_model", "block_rows", "neighbor_table_rows",
              "halo_rows_per_device", "broadcast_rows_per_device", "inter_pod_rows_per_device",
              "intra_pod_rows_per_device", "inter_pod_rows_crossing",
              "flat_inter_pod_rows_crossing", "interior_edges", "boundary_edges")


def _graph(n=600, e=3600, seed=3):
    g = citation_like(n, e, seed=seed)
    w = (np.abs(np.random.default_rng(seed).standard_normal(g.n_edges)) + 0.1).astype(np.float32)
    return g, w


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _plans(k, pods, pod_map, seed=3):
    g, w = _graph(seed=seed)
    part = partition_graph(g.n_nodes, g.edge_index, k, method="bfs", seed=0, refine=True)
    j_part = j_partition_graph(g.n_nodes, g.edge_index, k, method="bfs", seed=0, refine=True)
    np.testing.assert_array_equal(part.assignment, j_part.assignment)
    kw = {} if pods == 1 else {"axes": ("pod", "model"), "pods": pods, "pod_map": pod_map}
    return halo.build_halo_plan(part, g.edge_index, w, **kw), j_halo.build_halo_plan(j_part, g.edge_index, w, **kw)


CASES = [(2, 1, None), (4, 1, None), (8, 1, None), (4, 2, None), (8, 2, None), (8, 4, None),
         (8, 2, np.array([1, 0, 1, 0, 0, 1, 1, 0]))]


@pytest.mark.parametrize("k,pods,pod_map", CASES, ids=lambda c: str(c) if not isinstance(c, np.ndarray) else "map")
def test_plan_equals_reference(k, pods, pod_map):
    ours, theirs = _plans(k, pods, pod_map)
    for f in PLAN_FIELDS:
        _eq(getattr(ours, f), getattr(theirs, f), f)
    for p in PLAN_PROPS:
        _eq(getattr(ours, p), getattr(theirs, p), p)
    assert ours.wire_fraction() == theirs.wire_fraction()
    assert ours.overlap_fraction() == theirs.overlap_fraction()
    for m in ("boundary_row_mask", "interior_row_mask", "boundary_rows_per_device", "interior_rows_per_device"):
        _eq(getattr(ours, m)(), np.asarray(getattr(theirs, m)()), m)


@pytest.mark.parametrize("k,pods,pod_map", CASES, ids=lambda c: str(c) if not isinstance(c, np.ndarray) else "map")
def test_blocked_tables_and_stats_equal_reference(k, pods, pod_map):
    """Combined and split tables, their stats and shapes (block 128 and a
    smaller block, so several block-rows and tile columns appear)."""
    ours, theirs = _plans(k, pods, pod_map)
    for block in (128, 32):
        a, b = halo.plan_blocked_adjacency(ours, block), j_halo.plan_blocked_adjacency(theirs, block)
        pairs = [(a, b), *zip(halo.plan_split_blocked_adjacency(ours, block),
                              j_halo.plan_split_blocked_adjacency(theirs, block))]
        for x, y in pairs:
            for f in ("vals", "cols", "lens"):
                _eq(getattr(x, f), getattr(y, f), f)
            assert (x.block, x.n_rows, x.n_cols) == (y.block, y.n_rows, y.n_cols)
            assert x.stats() == y.stats()
        assert halo.plan_blocked_shape(ours, block) == j_halo.plan_blocked_shape(theirs, block)
        assert halo.plan_split_blocked_shape(ours, block) == j_halo.plan_split_blocked_shape(theirs, block)
        assert halo.plan_blocked_adjacency(ours, block) is a           # memoized


@pytest.mark.parametrize("part", ["combined", "interior", "boundary"])
def test_one_rank_slice_built_alone_equals_the_all_rank_table(part):
    """`plan_blocked_rank` with the shared width is slice ``rank`` of the
    all-rank table, and its tensors are that slice."""
    ours, _ = _plans(4, 1, None)
    block = 32
    full = (halo.plan_blocked_adjacency(ours, block) if part == "combined"
            else halo.plan_split_blocked_adjacency(ours, block)[part == "boundary"])
    width = (halo.plan_blocked_shape(ours, block) if part == "combined"
             else halo.plan_split_blocked_shape(ours, block)[part])["max_nnzb"]
    assert width == full.max_nnzb
    for r in range(ours.k):
        ba = halo.plan_blocked_rank(ours, r, block, part=part, max_nnzb=width)
        np.testing.assert_array_equal(ba.block_vals, full.vals[r])
        np.testing.assert_array_equal(ba.block_cols, full.cols[r])
        np.testing.assert_array_equal(ba.row_nnzb, full.lens[r])
        assert ba.n_col_nodes == full.n_cols
        for t, a in zip(ba.arrays("cpu"), (full.vals[r], full.cols[r], full.lens[r])):
            np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="narrower"):
        halo.plan_blocked_rank(ours, 0, block, part=part, max_nnzb=0)
    with pytest.raises(ValueError, match="unknown blocked table form"):
        halo.plan_blocked_rank(ours, 0, block, part="sideways")


@pytest.mark.parametrize("k,pods", [(4, 1), (8, 2)])
def test_rank_arrays_equal_reference_device_arrays(k, pods):
    ours, theirs = _plans(k, pods, None)
    ref = [np.asarray(a) for a in theirs.device_arrays()]
    for r in range(k):
        got = ours.rank_arrays(r, "cpu")
        assert len(got) == len(ref)
        for t, a in zip(got, ref):
            assert t.dtype in (torch.int32, torch.float32)
            np.testing.assert_array_equal(t.numpy(), a[r])


def test_relayout_helpers_equal_reference():
    ours, theirs = _plans(4, 1, None)
    x = np.random.default_rng(0).standard_normal((ours.n_nodes, 5)).astype(np.float32)
    xb = halo.relocate_node_array(ours, x)
    _eq(xb, j_halo.relocate_node_array(theirs, x), "relocate")
    np.testing.assert_array_equal(halo.restore_node_array(ours, xb), x)
    _eq(halo.node_mask(ours), j_halo.node_mask(theirs), "node_mask")
    lay, j_lay = halo.plan_layout(ours), j_halo.plan_layout(theirs)
    for f in ("k", "n_local", "n_nodes", "perm", "part_sizes"):
        _eq(getattr(lay, f), getattr(j_lay, f), f)
    np.testing.assert_array_equal(halo.restore_node_array(lay, xb), x)


def test_pod_map_helpers_equal_reference():
    pm = np.array([1, 0, 1, 0, 0, 1, 1, 0])
    _eq(halo.validate_pod_map(pm, 8, 2), j_halo.validate_pod_map(pm, 8, 2), "validate")
    _eq(halo.pod_map_order(pm, 8, 2), j_halo.pod_map_order(pm, 8, 2), "order")
    assert halo.pod_map_fingerprint(pm) == j_halo.pod_map_fingerprint(pm)
    assert halo.pod_map_fingerprint(None) == "contig"
    for bad in (np.array([0, 0, 0, 0, 0, 1, 1, 1]), np.array([0, 1]), np.array([0, 1, 2, 0, 1, 0, 1, 0])):
        with pytest.raises(ValueError) as ours:
            halo.validate_pod_map(bad, 8, 2)
        with pytest.raises(ValueError) as theirs:
            j_halo.validate_pod_map(bad, 8, 2)
        assert str(ours.value) == str(theirs.value)


def test_builder_errors_equal_reference():
    g, w = _graph()
    part = partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0)
    j_part = j_partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0)
    for kw in ({"axes": ("a", "b", "c")}, {"axes": ("pod", "pod")}, {"pods": 2},
               {"axes": ("pod", "model"), "pods": 3}, {"pod_map": np.array([0, 0, 1, 1])}):
        with pytest.raises(ValueError) as ours:
            halo.build_halo_plan(part, g.edge_index, w, **kw)
        with pytest.raises(ValueError) as theirs:
            j_halo.build_halo_plan(j_part, g.edge_index, w, **kw)
        assert str(ours.value) == str(theirs.value)


def test_plan_cache_matches_reference_behaviour():
    """Hits, misses, evictions, scoped invalidation and the key flavours
    (flat, hierarchical, pod map) move as the reference's do, with the same
    graph fingerprints."""
    g, w = _graph(n=300, e=1500, seed=11)
    part = partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0)
    j_part = j_partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0)
    assert (halo.graph_fingerprint(part.n_nodes, g.edge_index, w, part.assignment)
            == j_halo.graph_fingerprint(j_part.n_nodes, g.edge_index, w, j_part.assignment))
    trace = []
    for mod, p in ((halo, part), (j_halo, j_part)):
        mod.invalidate_halo_plans()
        mod.reset_plan_cache_stats()
        plan = mod.get_halo_plan(p, g.edge_index, w)
        steps = [mod.get_halo_plan(p, g.edge_index, w) is plan, mod.plan_cache_stats()]
        hier = mod.get_halo_plan(p, g.edge_index, w, pods=2)
        steps += [hier.is_hierarchical, mod.get_halo_plan(p, g.edge_index, w, mesh_axis=("pod", "model"), pods=2) is hier]
        mod.get_halo_plan(p, g.edge_index, w, pods=2, pod_map=np.array([1, 0, 0, 1]))
        steps.append(mod.plan_cache_stats())
        key = mod.graph_fingerprint(p.n_nodes, g.edge_index, w, p.assignment)
        steps += [mod.invalidate_halo_plans(key), mod.plan_cache_stats()]
        mod.register_halo_plan("v1", 4, plan=plan)
        steps += [mod.cached_halo_plan("v1", 4, builder=lambda: None) is plan,
                  mod.invalidate_halo_plans(), mod.plan_cache_stats()]
        with pytest.raises(ValueError, match="require pods"):
            mod.get_halo_plan(p, g.edge_index, w, mesh_axis=("pod", "model"))
        mod.reset_plan_cache_stats()
        trace.append(steps)
    assert trace[0] == trace[1]


# ------------------------------------------------------------- wire payloads
def _payload_inputs():
    r = np.random.default_rng(4)
    x = r.standard_normal((37, 9)).astype(np.float32)
    x[3, 2] = 41.5
    x[5, 5] = -0.0
    return {"normal": x, "ties": (np.arange(-64, 65, dtype=np.float32) * 0.5 / 127).reshape(-1, 1),
            "zeros": np.zeros((4, 3), np.float32), "empty": np.zeros((0, 3), np.float32)}


@pytest.mark.parametrize("payload", [None, "fp32", "bf16", "int8"])
@pytest.mark.parametrize("which", list(_payload_inputs()))
def test_payload_codecs_equal_reference(payload, which):
    """Wire codes and the (1, 1) scale equal JAX's bit for bit; bf16 rounds
    to nearest even in both; the decode of k gathered blocks with their own
    scales equals too."""
    x = _payload_inputs()[which]
    wire, scale = quant.quantize_payload(torch.from_numpy(x), payload)
    j_wire, j_scale = j_quant.quantize_payload(jnp.asarray(x), payload)
    np.testing.assert_array_equal(wire.float().numpy(), np.asarray(j_wire, np.float32))
    assert str(wire.dtype).removeprefix("torch.") == str(j_wire.dtype)
    assert (scale is None) == (j_scale is None)
    if scale is not None:
        np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
        # Four senders' blocks gathered, each decoded with its own scale.
        blocks = [x * f for f in (1.0, 0.5, 3.0, 0.0)]
        enc = [quant.quantize_payload(torch.from_numpy(b.astype(np.float32)), payload) for b in blocks]
        j_enc = [j_quant.quantize_payload(jnp.asarray(b.astype(np.float32)), payload) for b in blocks]
        got = quant.dequantize_payload(torch.cat([e[0] for e in enc]), torch.cat([e[1] for e in enc]))
        want = j_quant.dequantize_payload(jnp.concatenate([e[0] for e in j_enc]),
                                          jnp.concatenate([e[1] for e in j_enc]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert quant.payload_bits(payload) == j_quant.payload_bits(payload)


def test_payload_errors_and_bits_equal_reference():
    assert quant.PAYLOAD_BITS == j_quant.PAYLOAD_BITS
    for bad in ("fp8", "int4"):
        with pytest.raises(ValueError) as ours:
            quant.payload_bits(bad)
        with pytest.raises(ValueError) as theirs:
            j_quant.payload_bits(bad)
        assert str(ours.value) == str(theirs.value)
        with pytest.raises(ValueError, match="unknown halo payload"):
            quant.quantize_payload(torch.ones(2, 2), bad)


# --------------------------------------------------------------- cost model
@pytest.mark.parametrize("rows,d,bits,ov", [(280, 16, 32, 0.0), (37360, 16, 16, 0.805), (5, 210, 8, 1.0)])
def test_exchange_cost_equals_reference(rows, d, bits, ov):
    ours, theirs = dataflow.exchange_cost(rows, d, bits, ov), j_dataflow.exchange_cost(rows, d, bits, ov)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for p in ("wire_bytes", "exposed_bytes", "compression"):
        assert getattr(ours, p) == getattr(theirs, p)


# ---------------------------------------------------------------- obs gauges
@pytest.fixture
def registries():
    ours, theirs = metrics.MetricsRegistry(), j_metrics.MetricsRegistry()
    o_old, t_old = metrics.set_default_registry(ours), j_metrics.set_default_registry(theirs)
    o_on, t_on = metrics.enabled(), j_metrics.enabled()
    metrics.enable()
    j_metrics.enable()
    yield ours, theirs
    metrics.set_default_registry(o_old)
    j_metrics.set_default_registry(t_old)
    if not o_on:
        metrics.disable()
    if not t_on:
        j_metrics.disable()


@pytest.mark.parametrize("payload", [None, "bf16", "int8"])
@pytest.mark.parametrize("pods", [1, 2])
def test_instrument_gauges_equal_reference(registries, payload, pods):
    """record_exchange, record_blocked and observe_plan_cache write the
    reference's series with the reference's values."""
    ours_reg, theirs_reg = registries
    ours, theirs = _plans(8, pods, None)
    instrument.record_exchange(ours, 16, payload)
    j_instrument.record_exchange(theirs, 16, payload)
    instrument.record_blocked(halo.plan_blocked_shape(ours), scope="plan")
    j_instrument.record_blocked(j_halo.plan_blocked_shape(theirs), scope="plan")
    a, b = halo.plan_split_blocked_adjacency(ours)[1], j_halo.plan_split_blocked_adjacency(theirs)[1]
    instrument.record_blocked(a, scope="boundary")
    j_instrument.record_blocked(b, scope="boundary")
    instrument.observe_plan_cache()
    j_instrument.observe_plan_cache()
    snap, j_snap = ours_reg.snapshot(), theirs_reg.snapshot()
    cache_keys = [key for key in j_snap if key.startswith("plan_cache.")]
    assert set(snap) == set(j_snap) and cache_keys
    for key in j_snap:
        if key not in cache_keys:      # cache counters depend on each package's history
            assert snap[key] == j_snap[key], key


def test_device_time_summary_of_a_host_only_profile():
    """The profiler summary the card's runs print (per training step and per
    halo rank): a window with no device event reports its idle share as not
    measured instead of inventing one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import device_time_summary

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    out = device_time_summary(list(prof.events()), steps=2)
    assert out["device_kernel_events"] == 0 and out["device_busy_ms_per_step"] == 0.0
    assert out["device_idle_share"] == "not measured" and out["top_kernels"] == []
    assert out["window_ms_per_step"] > 0
    empty = device_time_summary([])
    assert empty["window_ms_per_step"] == 0.0 and empty["device_idle_share"] == "not measured"


def test_device_time_summary_merges_kernels_and_skips_step_marks():
    """Busy time is the union of kernel intervals; the ProfilerStep mark a
    scheduled profile puts on the device timeline is not a kernel."""
    import types

    from repro_torch.obs.trace import device_time_summary

    class Span:
        def __init__(self, start, end):
            self.start, self.end = start, end

        def elapsed_us(self):
            return self.end - self.start

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device, start, end):
        return types.SimpleNamespace(name=name, device_type=device, time_range=Span(start, end))

    events = [ev("forward", cpu, 0, 10_000), ev("ProfilerStep#1", cuda, 0, 10_000),
              ev("k1", cuda, 1_000, 3_000), ev("k2", cuda, 2_000, 4_000), ev("k1", cuda, 6_000, 7_000)]
    out = device_time_summary(events)
    assert out["device_kernel_events"] == 3
    assert out["window_ms_per_step"] == 10.0 and out["device_busy_ms_per_step"] == 4.0
    assert out["device_idle_share"] == 0.6
    assert [(t["name"], t["ms_per_step"], t["launches_per_step"]) for t in out["top_kernels"]] == [
        ("k1", 3.0, 2), ("k2", 2.0, 1)]
