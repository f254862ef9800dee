"""Online locality maintenance in `repro_torch.dist.delta` against the JAX
package's `repro.dist.delta`, on the CPU — the counterparts of
tests/test_relocalize.py.

The policy's hysteresis step for step; drift exactly 1.0 right after a
re-localization; `relocalize` and `compact` bit-identical to the reference
(every report field but the timings, every plan array) and to a fresh
`build_halo_plan`; the drift memo's one BFS per structural era; live state
carried by `relocate_state_tree` bit-exactly; the obs recorders; and the
serving engine's cache-on logits equal to a fresh cache-less engine's (and
to the reference engine's) across a re-localization.
"""
import numpy as np
import pytest
import torch

import _delta_oracle as O
from repro.core.partition import partition_from_assignment as ref_partition_from_assignment
from repro.dist import delta as R
from repro.dist.halo import build_halo_plan as ref_build_halo_plan
from repro.graph.generators import citation_like
from repro_torch.core.partition import partition_from_assignment
from repro_torch.dist import delta as D
from repro_torch.dist import halo as H
from repro_torch.train.elastic import relocate_state_tree
from test_torch_graph_delta import Pair, _boom, _mk, compact_reports_equal, plans_equal, port_delta, \
    relocalize_reports_equal


def _churn(pairs, rng, n, rounds=6, frac=0.02, members=20):
    """The reference's severed-ties churn, applied to every planner in
    ``pairs`` (reference planners take reference deltas, port planners the
    port's)."""
    ref = pairs[0]
    for _ in range(rounds):
        ei = ref.edge_index()
        m = max(int(ei.shape[1] * frac), 2)
        mem = rng.choice(n, members, replace=False)
        inc = np.flatnonzero(np.isin(ei[0], mem) | np.isin(ei[1], mem))[:m]
        if inc.size == 0:
            continue
        s = mem[rng.integers(0, mem.size, inc.size)]
        d = mem[rng.integers(0, mem.size, inc.size)]
        bad = s == d
        d[bad] = mem[(np.searchsorted(np.sort(mem), d[bad]) + 1) % mem.size]
        delta = R.GraphDelta(edge_inserts=np.stack([s, d]), edge_deletes=ei[:, inc],
                             insert_w=np.full(inc.size, 0.5, np.float32))
        for pl in pairs:
            pl.apply(delta if isinstance(pl, R.DeltaPlanner) else port_delta(delta))


def _planners(n, e, k, seed, **kw):
    g, w, part, rpart = _mk(n, e, k, seed)
    return g, w, part, R.DeltaPlanner(rpart, g.edge_index, w, **kw), D.DeltaPlanner(part, g.edge_index, w, **kw)


# -------------------------------------------------------------- hysteresis
@pytest.mark.parametrize("kw,readings", [
    (dict(threshold=1.5, patience=2, cooldown=3), [0.9, 1.0, 1.4, 1.5, 1.49] * 4),
    (dict(threshold=1.2, patience=3, cooldown=0), [1.3, 1.3, 1.1, 1.3, 1.3, 1.3]),
    (dict(threshold=1.0, patience=1, cooldown=3), [9.0] * 6),
    (dict(threshold=1.1, patience=2, cooldown=2), [1.2, 1.0, 1.2, 1.3, 1.4, 1.5, 1.6, 1.05, 1.2, 1.3]),
])
def test_policy_hysteresis_step_for_step(kw, readings):
    mine, ref = D.RelocalizePolicy(**kw), R.RelocalizePolicy(**kw)
    got = [mine.observe(r) for r in readings]
    assert got == [ref.observe(r) for r in readings]
    assert (mine.streak, mine.cooldown_left) == (ref.streak, ref.cooldown_left)


# ----------------------------------------------- drift == 1.0 after reorder
def test_drift_ratio_exactly_one_after_relocalize():
    g, w, part, ref, pl = _planners(300, 1800, 4, 6)
    pl.plan(), ref.plan()
    _churn([ref, pl], np.random.default_rng(0), g.n_nodes, rounds=5)
    assert pl.locality_drift(32) == ref.locality_drift(32)
    assert pl.locality_drift(32)["drift_ratio"] > 1.0
    rep = pl.relocalize(block=32)
    relocalize_reports_equal(rep, ref.relocalize(block=32))
    assert rep["executed_tiles_after"] <= rep["executed_tiles_before"]
    assert pl.locality_drift(32)["drift_ratio"] == 1.0
    ei = pl.edge_index()
    shuf = ei[:, np.random.default_rng(1).permutation(ei.shape[1])]
    a = D._relocalized_assignment(pl.n, ei, pl.k, block=32)
    assert np.array_equal(a, D._relocalized_assignment(pl.n, shuf, pl.k, block=32))
    assert np.array_equal(a, R._relocalized_assignment(pl.n, ei, pl.k, block=32))


def test_partition_from_assignment_matches_reference():
    g = citation_like(200, 900, seed=4)
    a = np.random.default_rng(0).integers(0, 4, g.n_nodes)
    mine, ref = partition_from_assignment(a, 4, g.edge_index), ref_partition_from_assignment(a, 4, g.edge_index)
    for f in ("assignment", "part_sizes", "edge_counts"):
        assert np.array_equal(getattr(mine, f), getattr(ref, f)), f
    assert (mine.k, mine.n_nodes, mine.n_edges) == (ref.k, ref.n_nodes, ref.n_edges)
    assert mine.assignment.dtype == np.int32


def test_relocalize_bit_identical_to_fresh_build_and_rekeys():
    g, w, part, ref, pl = _planners(256, 1500, 4, 8)
    H.invalidate_halo_plans()
    p, h = pl.plan(), pl.plan(axes=("pod", "model"), pods=2)
    rp, rh = ref.plan(), ref.plan(axes=("pod", "model"), pods=2)
    _churn([ref, pl], np.random.default_rng(2), g.n_nodes, rounds=4)
    key0, v0 = pl.graph_key, pl.version
    relocalize_reports_equal(pl.relocalize(block=64), ref.relocalize(block=64))
    assert pl.version == v0 + 1 and pl.graph_key != key0
    ei, ww = pl.edge_index(), pl.edge_weights()
    plans_equal(p, H.build_halo_plan(pl.part, ei, ww))
    plans_equal(h, H.build_halo_plan(pl.part, ei, ww, axes=("pod", "model"), pods=2))
    plans_equal(p, rp)
    plans_equal(h, rh)
    plans_equal(p, ref_build_halo_plan(ref.part, ei, ww))
    for q in (p, h):
        O.assert_plan_matches_rebuild(q, pl.part, ei, ww)
    assert H.cached_halo_plan(pl.graph_key, 4, "model", builder=_boom) is p
    with pytest.raises(RuntimeError):
        H.cached_halo_plan(key0, 4, "model", builder=_boom)
    H.invalidate_halo_plans()


def test_policy_fires_through_apply_and_reports():
    pol = dict(threshold=1.01, patience=2, cooldown=2, block=32)
    g, w, part, ref, pl = _planners(300, 1800, 4, 9, relocalize_policy=None)
    ref.relocalize_policy, pl.relocalize_policy = R.RelocalizePolicy(**pol), D.RelocalizePolicy(**pol)
    pl.plan(), ref.plan()
    fired = 0
    rng = np.random.default_rng(3)
    for _ in range(12):
        before = pl.version
        _churn([ref, pl], rng, g.n_nodes, rounds=1, frac=0.03)
        assert pl.version == ref.version and np.array_equal(pl.assignment, ref.assignment)
        if pl.version > before + 1:
            fired += 1
    assert fired >= 1
    pl2 = D.DeltaPlanner(part, g.edge_index, w, relocalize_policy=D.RelocalizePolicy(
        threshold=0.0, patience=1, cooldown=0, block=32))
    ei = pl2.edge_index()
    rep = pl2.apply(D.GraphDelta(edge_deletes=ei[:, :1]))
    r = rep["relocalized"]
    assert r is not None and r["version"] == pl2.version
    assert rep["graph_key"] == pl2.graph_key == r["graph_key"]
    assert pl2.locality_drift(32)["drift_ratio"] == 1.0


# ------------------------------------------------------------------ compact
def test_compact_on_v0_planner_is_noop():
    g, w, part, ref, pl = _planners(128, 700, 4, 3)
    p, h = pl.plan(), pl.plan(axes=("pod", "model"), pods=2)
    ref.plan(), ref.plan(axes=("pod", "model"), pods=2)
    H.plan_blocked_adjacency(p, 32)
    pl.rank_table(p, 0, 32)
    key0, v0 = pl.graph_key, pl.version
    rep = pl.compact()
    assert not rep["changed"] and not rep["rebuilt"] and rep["bytes_reclaimed"] == 0
    assert not any(rep["pad_rows_reclaimed"].values())
    assert (pl.graph_key, pl.version) == (key0, v0)
    assert rep["pad_occupancy"] == ref.compact()["pad_occupancy"]
    plans_equal(p, H.build_halo_plan(part, g.edge_index, w))
    plans_equal(h, H.build_halo_plan(part, g.edge_index, w, axes=("pod", "model"), pods=2))


def test_compact_after_churn_reclaims_and_matches_builder():
    g, w, part, ref, pl = _planners(256, 1500, 4, 11)
    p = pl.plan()
    ref.plan()
    a = pl.part.assignment
    src = np.flatnonzero(a == 0)[:40].astype(np.int64)
    dst = np.full(src.size, int(np.flatnonzero(a == 1)[0]), np.int64)
    for d in (R.GraphDelta(edge_inserts=np.stack([src, dst])),
              R.GraphDelta(edge_deletes=np.stack([src, dst])[:, :36])):
        ref.apply(d)
        pl.apply(port_delta(d))
    ei, ww = pl.edge_index(), pl.edge_weights()
    occ_loose = pl.pad_occupancy()
    assert occ_loose == ref.pad_occupancy()
    rep = pl.compact()
    compact_reports_equal(rep, ref.compact())
    assert rep["changed"] and rep["rebuilt"] and rep["bytes_reclaimed"] > 0
    assert sum(rep["pad_rows_reclaimed"].values()) > 0
    assert pl.pad_occupancy()["frac"] >= occ_loose["frac"]
    plans_equal(p, H.build_halo_plan(pl.part, ei, ww))
    O.assert_plan_matches_rebuild(p, pl.part, ei, ww)
    assert not pl.compact()["changed"]


def test_compact_rebuilds_loose_rank_tables_tight():
    """A rank table whose width outgrew its rows' live tiles is loose:
    `compact` rebuilds it at the tight shared width (and counts it as a
    dropped blocked entry), exactly as the all-rank table is dropped and
    rebuilt tight."""
    pair = Pair(256, 900, 4, 3, schedules=[(("model",), 1)])
    rt = pair.port.rank_table(pair.plans[0], 2, 16)
    H.plan_blocked_adjacency(pair.plans[0], 16)
    target = np.flatnonzero(pair.part.assignment == 0)[:16]
    rng = np.random.default_rng(4)
    ins = np.stack([rng.integers(0, 256, 48), target[rng.integers(0, target.size, 48)]])
    pair.port.apply(D.GraphDelta(edge_inserts=ins))
    pair.port.apply(D.GraphDelta(edge_deletes=ins))
    assert rt.max_nnzb > max(int(rt.lens.max()), 1), "the setup must leave slack"
    rep = pair.port.compact()
    assert rep["changed"] and rep["blocked_entries_dropped"] >= 1
    fresh = H.plan_blocked_rank(pair.plans[0], 2, 16, max_nnzb=H.plan_blocked_shape(pair.plans[0], 16)["max_nnzb"])
    assert rt.last == "rebuilt" and rt.max_nnzb == fresh.max_nnzb
    assert np.array_equal(rt.vals, fresh.block_vals) and np.array_equal(rt.cols[2], fresh.block_cols)


# ------------------------------------------------------- drift memo (fix)
def test_drift_fresh_reorder_memoized_per_structural_era(monkeypatch):
    import repro_torch.graph.structure as S

    g, w, part, _ = _mk(192, 1100, 4, seed=21)
    pl = D.DeltaPlanner(part, g.edge_index, w)
    pl.plan()
    calls = {"n": 0}
    orig = S.locality_block_order

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(S, "locality_block_order", counting)
    ei = pl.edge_index()
    for i in range(4):
        rep = pl.apply(D.GraphDelta(edge_deletes=ei[:, [i]]), measure_drift=True)
        assert not rep["pads_grown"] and rep["drift"] is not None
    assert calls["n"] == 1
    a = pl.part.assignment
    src = np.flatnonzero(a == 0).astype(np.int64)
    dst = np.full(src.size, int(np.flatnonzero(a == 1)[0]), np.int64)
    rep = pl.apply(D.GraphDelta(edge_inserts=np.stack([src, dst])), measure_drift=True)
    assert rep["pads_grown"] and calls["n"] == 2
    pl.apply(D.GraphDelta(edge_deletes=np.stack([src, dst])[:, :1]), measure_drift=True)
    assert calls["n"] == 2
    pl.relocalize()
    n_after = calls["n"]
    pl.apply(D.GraphDelta(edge_deletes=pl.edge_index()[:, :1]), measure_drift=True)
    assert calls["n"] == n_after


# ------------------------------------------------------ live-state carry
def test_relocate_state_tree_round_trip_exact():
    g, w, part, ref, pl = _planners(300, 1800, 4, 13)
    pl.plan(), ref.plan()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((pl.n, 8)).astype(np.float32)
    old = H.plan_layout(pl)
    tree = {"m": np.asarray(O.relocate(old, x)), "v": np.asarray(O.relocate(old, x * 2.0)),
            "dense": np.full((3, 3), 7.0, np.float32), "none": None}
    _churn([ref, pl], rng, g.n_nodes, rounds=4)
    rep = pl.relocalize(block=64)
    ref.relocalize(block=64)
    new = H.plan_layout(pl)
    for f in ("perm", "part_sizes"):
        assert np.array_equal(getattr(rep["old_layout"], f), getattr(old, f))
        assert np.array_equal(getattr(new, f), np.asarray(getattr(ref, f if f == "perm" else "part_sizes")))
    moved = relocate_state_tree(old, new, tree)
    np.testing.assert_array_equal(H.restore_node_array(new, moved["m"]), x)
    np.testing.assert_array_equal(H.restore_node_array(new, moved["v"]), x * 2.0)
    assert moved["dense"] is tree["dense"] and moved["none"] is None


def test_relocalize_metrics_and_span_recorded():
    from repro_torch.obs import metrics, trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import TraceRecorder

    rec = TraceRecorder()
    old_reg = metrics.set_default_registry(MetricsRegistry())
    old_tracer = trace.set_default_tracer(rec)
    metrics.enable()
    try:
        g, w, part, _ = _mk(192, 1100, 4, seed=15)
        pl = D.DeltaPlanner(part, g.edge_index, w)
        _churn([pl], np.random.default_rng(6), g.n_nodes, rounds=3)
        pl.relocalize(block=64)
        pl.compact()
        snap = metrics.snapshot()
        assert snap["delta.applies"]["value"] == 3.0
        assert snap["delta.relocalizes"]["value"] == 1.0
        assert snap["delta.relocalize_ms"]["count"] == 1
        assert snap["delta.compacts"]["value"] == 1.0
        assert 0.0 < snap["delta.pad_occupancy"]["value"] <= 1.0
        names = {ev.get("name") for ev in rec._events}
        assert {"delta.relocalize", "delta.apply"} <= names
    finally:
        metrics.disable()
        metrics.set_default_registry(old_reg)
        trace.set_default_tracer(old_tracer)


# ----------------------------------------------- serve engine across reorder
def test_serve_cache_on_equals_off_across_relocalization():
    import jax

    from repro.core.partition import partition_graph as ref_partition_graph
    from repro.models.gcn import GCNConfig as RefConfig
    from repro.models.gcn import gcn_init
    from repro.serve.graph import GraphBatcher as RefBatcher
    from repro_torch.core.partition import partition_graph
    from repro_torch.models.gcn import GCNConfig, params_from_numpy
    from repro_torch.serve.graph import GraphBatcher, hot_query_stream

    g = citation_like(300, 2400, 16, 4, seed=0)
    dims = (16, 8, 4)
    params = {k: np.asarray(v) for k, v in gcn_init(jax.random.PRNGKey(0), RefConfig(layer_dims=dims)).items()}
    part = partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0, refine=True)
    rpart = ref_partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0, refine=True)
    tparams = params_from_numpy(params, device="cpu")
    eng = GraphBatcher(tparams, g, GCNConfig(layer_dims=dims), batch_seeds=4, fanout=4, cache_capacity=64,
                       partition=part, seed=0, device="cpu")
    ref = RefBatcher(params, g, RefConfig(layer_dims=dims), batch_seeds=4, fanout=4, cache_capacity=64,
                     partition=rpart, seed=0)
    pol = dict(threshold=0.5, patience=1, cooldown=0, block=32)
    pl = D.DeltaPlanner(part, g.edge_index, graph_key="serve-reloc", relocalize_policy=D.RelocalizePolicy(**pol))
    rpl = R.DeltaPlanner(rpart, g.edge_index, graph_key="serve-reloc", relocalize_policy=R.RelocalizePolicy(**pol))
    nodes = hot_query_stream(g, 40)
    for e in (eng, ref):
        for _ in range(2):
            for v in nodes:
                e.submit(int(v))
            e.run_until_drained()
    rng = np.random.default_rng(7)
    fired = 0
    for _ in range(3):
        ei = pl.edge_index()
        drop = rng.choice(ei.shape[1], 20, replace=False)
        mem = rng.choice(g.n_nodes, 16, replace=False)
        s = mem[rng.integers(0, mem.size, 20)]
        d = mem[rng.integers(0, mem.size, 20)]
        bad = s == d
        d[bad] = mem[(np.searchsorted(np.sort(mem), d[bad]) + 1) % mem.size]
        delta = R.GraphDelta(edge_inserts=np.stack([s, d]), edge_deletes=ei[:, drop])
        assert eng.apply_graph_delta(port_delta(delta)) == ref.apply_graph_delta(delta)
        rep, rrep = pl.apply(port_delta(delta)), rpl.apply(delta)
        assert (rep["relocalized"] is None) == (rrep["relocalized"] is None)
        if rep["relocalized"] is not None:
            fired += 1
            eng.adopt_partition(pl.part)
            ref.adopt_partition(rpl.part)
            assert np.array_equal(pl.part.assignment, rpl.part.assignment)
    assert fired >= 1
    oracle = GraphBatcher(tparams, eng.graph, GCNConfig(layer_dims=dims), batch_seeds=4, fanout=4,
                          cache_capacity=0, seed=0, device="cpu")
    got = {}
    for name, e in (("eng", eng), ("oracle", oracle), ("ref", ref)):
        start = len(e.finished)
        for v in nodes:
            e.submit(int(v))
        e.run_until_drained()
        done = e.finished[start:]
        base = min(q.qid for q in done)
        got[name] = {q.qid - base: q.logits for q in done}
    for k in got["oracle"]:
        np.testing.assert_allclose(got["eng"][k], got["oracle"][k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["eng"][k], got["ref"][k], rtol=1e-5, atol=1e-5)
    assert eng.cache.hits > 0 and eng.cache.stats() == ref.cache.stats()
    assert eng.foreign_rows == ref.foreign_rows


# ------------------------------------------------ maintained vs plain planner
def test_maintained_planner_loss_matches_plain_twin():
    """The single-process twin of the reference's 8-device maintenance run:
    a planner under the policy and a plain twin take the same rewiring
    deltas; the port's unsharded loss on their edges agrees to 1e-4 at
    every step, executed tiles drop at each fire, and a per-node state
    carried through every fire by `relocate_state_tree` comes back
    bit-exact."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.launch.distributed_gcn import rewire_delta
    from repro_torch.models.gcn import GCNConfig, gcn_init, gcn_loss

    g = citation_like(400, 2400, seed=5)
    ei = g.edge_index.astype(np.int64)
    part = partition_graph(g.n_nodes, ei, 8, method="bfs", seed=0, refine=True)
    w = (0.1 + (ei[0] * 131 + ei[1] * 17) % 97 / 97.0).astype(np.float32)
    A = D.DeltaPlanner(part, ei, w, graph_key="maint", relocalize_policy=D.RelocalizePolicy(
        threshold=1.02, patience=2, cooldown=4, block=32))
    B = D.DeltaPlanner(part, ei, w, graph_key="plain")
    A.plan(), B.plan()
    cfg = GCNConfig(layer_dims=(16, 32, 7), dataflow="feature_first")
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((g.n_nodes, 16)).astype(np.float32))
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 7, g.n_nodes))
    ones = torch.ones(g.n_nodes)

    def loss(pl):
        e = torch.from_numpy(pl.edge_index())
        return float(gcn_loss(params, x, e[0], e[1], torch.from_numpy(pl.edge_weights()), labels, ones, cfg))

    state = {"m": H.relocate_node_array(H.plan_layout(A), x.numpy())}
    rng = np.random.default_rng(7)
    fired = 0
    for _ in range(30):
        delta = rewire_delta(A, rng, members=20, max_edges=24)
        rep = A.apply(delta)
        B.apply(delta)
        r = rep["relocalized"]
        if r is not None:
            fired += 1
            assert r["executed_tiles_after"] < r["executed_tiles_before"]
            state = relocate_state_tree(r["old_layout"], H.plan_layout(A), state)
        assert abs(loss(A) - loss(B)) < 1e-4
    assert fired >= 1
    assert np.array_equal(H.restore_node_array(H.plan_layout(A), state["m"]), x.numpy())
