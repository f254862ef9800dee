"""The port's placement autotuner against the JAX package's, on the CPU —
the twin of tests/test_autotune.py.

The same numpy graphs (``citation_like`` from a seed, array-equal in both
packages) and partitions go through `repro.core.autotune` and
`repro_torch.core.autotune`:

* `quotient_graph`, `BoundaryIndex` (every field, `tier_sizes` with and
  without a pod map), `map_parts_to_pods` and `refine_pod_map` are
  array-equal; the pinned benchmark graph gives the reference's
  ``(s_rem_default, s_rem_tuned) == (30, 21)``.
* With the port's H100 constants (`PEAK_FLOPS`, `ICI_BYTES_PER_S`,
  `BACKEND_EFFICIENCY`) set to the reference's, `predict_config_cost` is
  equal key by key, `autotune_config` gives the same config, history and
  breakdowns, and `run_autotune` the same record. Under the port's own
  constants the search keeps its invariants: objective ≤ baseline, a
  balanced map, calibration ``{}``.
* `exchange_accounting` on the documented 2 × 4 worked example: the pinned
  geometry (263, 40, 31, 25) and 374 rows, every predicted field equal to
  its measured twin and to the reference's prediction.
* One 4-rank gloo group (2 pods × 2, `halo_ranks`) runs the segment and
  bsr forwards on the default and the autotuned plan of a graph whose
  tuned map is not the contiguous one: logits equal within 1e-5, and
  within 1e-5 of the unsharded forward; wire rows per phase equal to each
  plan's.
"""
import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.autotune as ra
import repro.launch.autotune as rla
import repro_torch.core.autotune as ta
import repro_torch.launch.autotune as tla
from repro.core.energy import model_from_gcn as r_model_from_gcn
from repro.core.noc import MeshNoC as RMeshNoC
from repro.core.partition import partition_graph as r_partition_graph, quotient_graph as r_quotient_graph
from repro.dist.halo import build_halo_plan as r_build_halo_plan, plan_blocked_shape as r_plan_blocked_shape
from repro.obs import metrics as r_metrics
from repro_torch.core.energy import model_from_gcn
from repro_torch.core.noc import MeshNoC
from repro_torch.core.partition import partition_graph, quotient_graph
from repro_torch.dist.halo import build_halo_plan, plan_blocked_shape, restore_node_array
from repro_torch.graph.generators import citation_like
from repro_torch.graph.structure import GraphData, to_padded
from repro_torch.launch.distributed_gcn import HaloVariant, halo_ranks, rank_jobs
from repro_torch.launch.dryrun import exchange_accounting
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init
from repro_torch.obs import metrics, trace

CONSTANTS = ("PEAK_FLOPS", "ICI_BYTES_PER_S", "ENERGY_WEIGHT_S_PER_J", "BACKEND_EFFICIENCY", "BLOCK_GRID")
FIELDS = ("halo_rows_per_device", "broadcast_rows_per_device", "wire_fraction", "halo_bytes_per_exchange",
          "payload", "payload_bits", "payload_compression", "overlap", "overlap_fraction",
          "halo_wire_bytes_per_exchange", "halo_exposed_bytes_per_exchange", "pods", "intra_pod_rows_per_device",
          "inter_pod_rows_per_device", "inter_pod_rows_crossing", "flat_inter_pod_rows_crossing",
          "inter_pod_bytes_crossing", "flat_inter_pod_bytes_crossing")
LOGIT_TOL = 1e-5


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's objective constants set to the reference's values."""
    for name in CONSTANTS:
        monkeypatch.setattr(ta, name, getattr(ra, name))


def _graph(n, e, seed, shuffle=None):
    ei = citation_like(n, e, seed=seed).edge_index
    return ei if shuffle is None else np.random.default_rng(shuffle).permutation(n)[ei]


def _parts(n, ei, k, method="bfs", refine=False):
    part = partition_graph(n, ei, k, method=method, seed=0, refine=refine)
    rpart = r_partition_graph(n, ei, k, method=method, seed=0, refine=refine)
    np.testing.assert_array_equal(part.assignment, rpart.assignment)
    return part, rpart


def _worked_example():
    ei = _graph(2000, 12000, 1)
    return ei, *_parts(2000, ei, 8, refine=True)


def test_constants_are_the_h100s_not_the_references():
    assert ta.PEAK_FLOPS == 33.5e12 != ra.PEAK_FLOPS
    assert ta.ICI_BYTES_PER_S == 450e9 != ra.ICI_BYTES_PER_S
    assert ta.BACKEND_EFFICIENCY != ra.BACKEND_EFFICIENCY
    assert set(ta.BACKEND_EFFICIENCY) == set(ra.BACKEND_EFFICIENCY)
    assert (ta.ENERGY_WEIGHT_S_PER_J, ta.BLOCK_GRID) == (ra.ENERGY_WEIGHT_S_PER_J, ra.BLOCK_GRID)


# ---------------------------------------------------------- quotient graph
@settings(max_examples=15, deadline=None)
@given(n=st.integers(60, 300), k=st.sampled_from([4, 8]), seed=st.integers(0, 5))
def test_quotient_graph_equals_reference(n, k, seed):
    ei = _graph(n, 5 * n, seed)
    part, rpart = _parts(n, ei, k)
    q_ei, q_w = quotient_graph(part, ei)
    r_ei, r_w = r_quotient_graph(rpart, ei)
    np.testing.assert_array_equal(q_ei, r_ei)
    np.testing.assert_array_equal(q_w, r_w)
    assert q_ei.dtype == q_w.dtype == np.int64
    index = ta.BoundaryIndex(part, ei)
    assert int(q_w.sum()) == index.pair_node.size
    dense = np.zeros((k, k), np.int64)
    dense[q_ei[0], q_ei[1]] = q_w
    np.testing.assert_array_equal(dense, index.row_traffic)
    assert not np.any(q_ei[0] == q_ei[1]) and np.all(q_w > 0)


# ----------------------------------------------------------- BoundaryIndex
@settings(max_examples=10, deadline=None)
@given(n=st.integers(100, 300), seed=st.integers(0, 4), pods=st.sampled_from([1, 2, 4]), tuned=st.booleans())
def test_boundary_index_equals_reference_and_built_plan(n, seed, pods, tuned):
    k = 8
    ei = _graph(n, 6 * n, seed)
    part, rpart = _parts(n, ei, k, refine=True)
    index, rindex = ta.BoundaryIndex(part, ei), ra.BoundaryIndex(rpart, ei)
    for name in ("k", "n_nodes", "n_edges", "cut_edges", "interior_edges", "n_local", "s_max", "overlap_fraction"):
        assert getattr(index, name) == getattr(rindex, name), name
    for name in ("pair_node", "pair_dst", "pair_src", "part_sizes", "row_traffic"):
        np.testing.assert_array_equal(getattr(index, name), getattr(rindex, name), err_msg=name)
    pm = ta.map_parts_to_pods(part, ei, pods, index=index) if tuned and pods > 1 else None
    assert index.tier_sizes(pods, pm) == rindex.tier_sizes(pods, pm)
    assert index.tier_sizes(pods, None) == rindex.tier_sizes(pods, None)
    stats = index.comm_stats(pods, pm)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rindex.comm_stats(pods, pm))
    axes = ("pod", "model") if pods > 1 else ("model",)
    plan = build_halo_plan(part, ei, axes=axes, pods=pods, pod_map=pm)
    assert stats == ta.comm_stats_from_plan(plan)


# ---------------------------------------------------------- the pod mapper
@settings(max_examples=10, deadline=None)
@given(n=st.integers(80, 300), pods=st.sampled_from([2, 4]), seed=st.integers(0, 4),
       map_seed=st.integers(0, 50), shuffle=st.sampled_from([None, 7]))
def test_map_and_refine_pod_map_equal_reference(n, pods, seed, map_seed, shuffle):
    k = 8
    ei = _graph(n, 5 * n, seed, shuffle)
    part, rpart = _parts(n, ei, k)
    index, rindex = ta.BoundaryIndex(part, ei), ra.BoundaryIndex(rpart, ei)
    pm = ta.map_parts_to_pods(part, ei, pods)
    np.testing.assert_array_equal(pm, ra.map_parts_to_pods(rpart, ei, pods))
    np.testing.assert_array_equal(np.bincount(pm, minlength=pods), k // pods)
    start = np.repeat(np.arange(pods), k // pods)
    np.random.default_rng(map_seed).shuffle(start)
    refined = ta.refine_pod_map(start, pods, index)
    np.testing.assert_array_equal(refined, ra.refine_pod_map(start, pods, rindex))
    assert ta._crossing_objective(refined, pods, index) == ra._crossing_objective(refined, pods, rindex)
    assert ta._crossing_objective(refined, pods, index) <= ta._crossing_objective(start, pods, index)
    unbalanced = np.zeros(k, np.int64)
    np.testing.assert_array_equal(ta._balance_pod_map(unbalanced, k, pods, index),
                                  ra._balance_pod_map(unbalanced, k, pods, rindex))
    np.testing.assert_array_equal(ta._device_order(pm, k, pods), ra._device_order(pm, k, pods))
    with pytest.raises(ValueError):
        ta.map_parts_to_pods(part, ei, 3)


def test_pod_mapper_beats_contiguous_on_benchmark_graph():
    """The reference's pinned BENCH_autotune case (16384 n / 65536 e, shuffled
    node ids, k = 32, 2 pods): the port reproduces (30, 21) exactly."""
    ei = np.random.default_rng(7).permutation(16384)[
        citation_like(16384, 65536, n_labels=128, homophily=0.9, seed=1).edge_index]
    part = partition_graph(16384, ei, 32, method="bfs", seed=0, refine=True)
    index = ta.BoundaryIndex(part, ei)
    _, s_rem_default = index.tier_sizes(2, None)
    _, s_rem_tuned = index.tier_sizes(2, ta.map_parts_to_pods(part, ei, 2, index=index))
    assert (s_rem_default, s_rem_tuned) == (30, 21)


# ------------------------------------------------------------ the objective
CONFIGS = (ta.CandidateConfig(pods=2), ta.CandidateConfig(pods=2, backend="segment", payload="int8"),
           ta.CandidateConfig(pods=2, pod_map=(1, 0, 0, 1, 1, 0, 0, 1), order="aggregation_first", payload="bf16",
                              overlap=False, block=64))


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "segment_int8", "tuned_af_bf16"])
def test_predict_config_cost_equals_reference(reference_constants, cfg):
    ei, part, rpart = _worked_example()
    index, rindex = ta.BoundaryIndex(part, ei), ra.BoundaryIndex(rpart, ei)
    pm = cfg.pod_map_array()
    order = ta._device_order(pm, 8, 2)
    kw = dict(d_feat=64, n_nodes=2000, layer_dims=(64, 32, 7), nnz_blocks=300, n_edges=index.n_edges,
              row_traffic=index.row_traffic[np.ix_(order, order)])
    got = ta.predict_config_cost(cfg, index.comm_stats(2, pm), noc=MeshNoC.square(8),
                                 energy_model=model_from_gcn(2000, (64, 32, 7)), **kw)
    ref = ra.predict_config_cost(ra.CandidateConfig(**dataclasses.asdict(cfg)), rindex.comm_stats(2, pm),
                                 noc=RMeshNoC.square(8), energy_model=r_model_from_gcn(2000, (64, 32, 7)), **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    with pytest.raises(ValueError):
        ta.predict_config_cost(ta.CandidateConfig(pods=1), index.comm_stats(2), d_feat=64)


def _autotune_both(part, rpart, ei, **kw):
    nnz = {b: plan_blocked_shape(build_halo_plan(part, ei, axes=("pod", "model"), pods=2), block=b)["nnz_blocks"]
           for b in ta.BLOCK_GRID}
    got = ta.autotune_config(part, ei, pods=2, nnz_blocks_for=nnz, energy_model=model_from_gcn(part.n_nodes, kw["layer_dims"]),
                             **kw)
    ref = ra.autotune_config(rpart, ei, pods=2, nnz_blocks_for=nnz,
                             energy_model=r_model_from_gcn(rpart.n_nodes, kw["layer_dims"]), **kw)
    return got, ref


def test_autotune_config_equals_reference(reference_constants):
    ei, part, rpart = _worked_example()
    got, ref = _autotune_both(part, rpart, ei, d_feat=64, layer_dims=(64, 32, 7))
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    assert got.history == ref.history and len(got.history) >= 2
    assert got.predicted == ref.predicted and got.baseline == ref.baseline
    assert got.predicted_improvement == ref.predicted_improvement


def test_autotune_obs_equals_reference(reference_constants):
    """The ``autotune.candidate`` spans and ``autotune.*`` metrics: as many
    candidates as the reference evaluates, the best objective its own."""
    ei, part, rpart = _worked_example()
    registry, rregistry = metrics.MetricsRegistry(), r_metrics.MetricsRegistry()
    metrics.enable(registry)
    r_metrics.enable(rregistry)
    tracer = trace.set_default_tracer(trace.TraceRecorder()) or trace.default_tracer()
    try:
        got = ta.autotune_config(part, ei, pods=2, d_feat=64, layer_dims=(64, 32, 7))
        ra.autotune_config(rpart, ei, pods=2, d_feat=64, layer_dims=(64, 32, 7))
    finally:
        metrics.disable()
        r_metrics.disable()
        trace.set_default_tracer(None)
    snap = registry.snapshot()
    assert snap == rregistry.snapshot()
    assert snap["autotune.objective_best_s"]["value"] == got.predicted["objective_s"]
    spans = [e for e in tracer.events() if e.get("name") == "autotune.candidate"]
    assert len(spans) == snap["autotune.candidates"]["value"] == snap["autotune.objective_s"]["count"] > 2
    assert {e["args"]["payload"] for e in spans} == {"fp32", "bf16", "int8"}


@pytest.mark.parametrize("graph", [(2000, 12000, 1, None, 8), (3000, 18000, 2, 7, 8), (2400, 14400, 3, 5, 4)])
def test_autotune_invariants_under_h100_constants(graph):
    n, e, seed, shuffle, k = graph
    ei = _graph(n, e, seed, shuffle)
    part, rpart = _parts(n, ei, k, refine=True)
    got, _ = _autotune_both(part, rpart, ei, d_feat=16, layer_dims=(16, 32, 7))
    assert got.predicted["objective_s"] <= got.baseline["objective_s"]
    assert got.history[0][0] == "seed defaults"
    assert [h[1] for h in got.history] == sorted((h[1] for h in got.history), reverse=True)
    if got.config.pod_map is not None:
        np.testing.assert_array_equal(np.bincount(got.config.pod_map, minlength=2), k // 2)
        plan = build_halo_plan(part, ei, axes=("pod", "model"), pods=2, pod_map=got.config.pod_map_array())
        assert plan.inter_pod_rows_crossing <= build_halo_plan(part, ei, axes=("pod", "model"),
                                                                pods=2).inter_pod_rows_crossing


# ------------------------------------------------------------------ the CLI
RUN = dict(n=2000, e=12000, k=8, pods=2, d_feat=64, layer_dims=(64, 32, 7), shuffle_seed=None, rounds=2)


def test_run_autotune_record_equals_reference(reference_constants):
    got = tla.run_autotune(**RUN)
    ref = rla.run_autotune(**RUN)
    assert got == ref
    assert got["calibration_mismatches"] == {}


@pytest.mark.parametrize("run", [RUN, dict(RUN, shuffle_seed=7, n=3000, e=18000, pods=4)], ids=["n2000", "shuffled"])
def test_run_autotune_calibrated_under_h100_constants(run):
    rec = tla.run_autotune(**run)
    assert rec["calibration_mismatches"] == {}
    md, mt = rec["measured"]["default"], rec["measured"]["autotuned"]
    assert mt["inter_pod_rows_crossing"] <= md["inter_pod_rows_crossing"]
    assert rec["improvement"]["crossing_improvement"] >= 1.0
    if rec["config"]["pod_map"] is not None:
        assert np.bincount(rec["config"]["pod_map"], minlength=run["pods"]).tolist() == [8 // run["pods"]] * run["pods"]


def test_cli_main_prints_the_ports_commands_and_exits_on_a_mismatch(monkeypatch, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tla.main(["--n", "600", "--e", "3600", "--k", "4", "--shuffle-seed", "-1", "--rounds", "1",
                       "--out", str(tmp_path / "cfg.json")])
    text = out.getvalue()
    assert rc == 0 and "calibration: every shared predicted field matches measured exactly" in text
    assert "python -m repro_torch.launch.distributed_gcn --pods 2" in text and "repro.launch" not in text
    assert "dryrun" not in text and (tmp_path / "cfg.json").is_file()
    real = tla.run_autotune
    monkeypatch.setattr(tla, "run_autotune", lambda **kw: {**real(**kw), "calibration_mismatches": {"x": (1, 2)}})
    with contextlib.redirect_stdout(io.StringIO()):
        assert tla.main(["--n", "600", "--e", "3600", "--k", "4", "--rounds", "1"]) == 1


# --------------------------------------------------- the worked example (dry run)
def test_exchange_accounting_worked_example(reference_constants):
    """The documented 2 × 4 geometry and the calibration contract."""
    ei, part, rpart = _worked_example()
    plan = build_halo_plan(part, ei, axes=("pod", "model"), pods=2)
    rplan = r_build_halo_plan(rpart, ei, axes=("pod", "model"), pods=2)
    assert (plan.n_local, plan.s_max, plan.s_loc, plan.s_rem) == (263, 40, 31, 25)
    assert plan.halo_rows_per_device == 374          # 2·25 + 4·(31 + 2·25)
    assert (plan.inter_pod_rows_crossing, plan.flat_inter_pod_rows_crossing) == (25, 160)
    assert plan.overlap_fraction() == 0.6869166666666666
    shape = types.SimpleNamespace(d_feat=64)
    for payload, overlap, bsr in ((None, False, False), ("int8", True, False), ("bf16", True, True)):
        stats = plan_blocked_shape(plan) if bsr else None
        cell = types.SimpleNamespace(comm="halo", halo_plan=plan, halo_payload=payload, halo_overlap=overlap,
                                     bsr_stats=stats)
        acc = exchange_accounting(cell, shape)
        pred = acc["predicted"]
        for f in FIELDS:
            assert pred[f] == acc[f], (payload, overlap, f, pred[f], acc[f])
        ref = ra.predict_config_cost(
            ra.CandidateConfig(pods=2, backend="bsr" if bsr else "segment", payload=payload, overlap=overlap),
            ra.comm_stats_from_plan(rplan), d_feat=64, n_nodes=rplan.n_nodes,
            nnz_blocks=r_plan_blocked_shape(rplan)["nnz_blocks"] if bsr else None,
            n_edges=int((rplan.edge_w > 0).sum()))
        assert pred == ref
        assert acc["boundary_rows_max_device"] > 0 and acc["comm"] == "halo"
    cell = types.SimpleNamespace(comm="halo", halo_plan=plan)
    acc = exchange_accounting(cell, shape)
    assert acc["predicted"]["halo_wire_bytes_per_exchange"] == 374 * 64 * 4
    assert acc["predicted"]["halo_exposed_bytes_per_exchange"] == 374 * 64 * 4
    assert exchange_accounting(types.SimpleNamespace(comm="broadcast"), shape) == {"comm": "broadcast"}
    assert exchange_accounting(types.SimpleNamespace(), shape) is None


def test_exchange_accounting_records_its_prediction_when_metrics_are_on():
    ei, part, _ = _worked_example()
    plan = build_halo_plan(part, ei, axes=("pod", "model"), pods=2)
    registry = metrics.enable(metrics.MetricsRegistry())
    try:
        exchange_accounting(types.SimpleNamespace(comm="halo", halo_plan=plan, halo_payload="int8",
                                                  bsr_stats=plan_blocked_shape(plan)),
                            types.SimpleNamespace(d_feat=64))
    finally:
        metrics.disable()
    snap = {k: v["value"] for k, v in registry.snapshot().items()}
    assert snap["halo.payload_bits"] == 8 and snap["halo.rows_per_device{tier=total}"] == 374
    assert snap["bsr.executed_tiles{scope=dryrun}"] == plan_blocked_shape(plan)["nnz_blocks"]


# ---------------------------------------------- the tuned map on a 2 × 2 group
def test_tuned_pod_map_logits_equal_default_on_a_group():
    """2 pods × 2 ranks (gloo, CPU): the autotuned pod map moves rows
    between tiers and changes no logit — segment and bsr, both within
    LOGIT_TOL of the default plan's and of the unsharded forward — and each
    rank counts each plan's rows per phase."""
    n, dims = 400, (16, 32, 7)
    gs = citation_like(n, 6 * n, seed=0).symmetrized().with_self_loops()
    ei, w = gs.edge_index, gs.sym_normalized_weights()
    part = partition_graph(n, ei, 4, method="bfs", seed=0, refine=True)
    pm = ta.map_parts_to_pods(part, ei, 2)
    assert pm.tolist() != [0, 0, 1, 1]                       # the tuned map is not the contiguous one
    default = build_halo_plan(part, ei, w, axes=("pod", "model"), pods=2)
    tuned = build_halo_plan(part, ei, w, axes=("pod", "model"), pods=2, pod_map=pm)
    assert tuned.inter_pod_rows_crossing < default.inter_pod_rows_crossing
    x = np.random.default_rng(1).standard_normal((n, dims[0])).astype(np.float32)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(0), GCNConfig(layer_dims=dims),
                                                device="cpu").items()}
    variants = (HaloVariant("seg", backend="segment"), HaloVariant("bsr"))
    jobs = [rank_jobs(plan, x, params, dims, variants) for plan in (default, tuned)]
    ranks = run_group(GroupSpec(k=4, backend="gloo", devices=("cpu",), timeout_s=300), halo_ranks,
                      list(zip(*jobs)))
    pg = to_padded(GraphData(n, ei), weights=w, device="cpu")
    with torch.inference_mode():
        ref = gcn_forward({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x), pg.senders,
                          pg.receivers, pg.edge_weight, GCNConfig(layer_dims=dims, backend="segment")).numpy()
    for v in variants:
        logits = [restore_node_array(plan, np.stack([r[i]["variants"][v.name]["logits"] for r in ranks]))
                  for i, plan in enumerate((default, tuned))]
        assert np.abs(logits[1] - logits[0]).max() <= LOGIT_TOL, v.name
        assert np.abs(logits[1] - ref).max() <= LOGIT_TOL, v.name
        for i, plan in enumerate((default, tuned)):
            for r in ranks:
                rec = r[i]["variants"][v.name]
                assert rec["wire_rows_inter_pod"] == 2 * plan.inter_pod_rows_per_device
                assert rec["wire_rows_intra_pod"] == 2 * plan.intra_pod_rows_per_device
