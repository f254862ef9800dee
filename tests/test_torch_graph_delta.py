"""`repro_torch.dist.delta` against the JAX package's `repro.dist.delta`, on
the CPU — the counterparts of tests/test_graph_delta.py.

Both packages' `DeltaPlanner`s start from the same partition and edges and
take the same deltas (the port's `GraphDelta` built from the oracle's
numpy arrays, tests/_delta_oracle.py), step by step:

* every plan array (flat and hierarchical) and every report field but
  ``apply_ms`` are equal, and the port's plans also pass the reference's
  delta-vs-rebuild oracle;
* the memoized blocked tables (combined and the interior/boundary pair)
  are bit-equal to the reference's patched tables, growth included, and
  every rank's `RankTable` equals slice b of the all-rank table;
* the standalone `delta_update_blocked_adjacency` patch is bit-equal too;
* the port's plain K1/K2 paths give finite results on poisoned patched
  tables, equal to the clean ones;
* validation raises the same exception types with the same messages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _delta_oracle as O
from repro.core.partition import partition_graph as ref_partition_graph
from repro.dist import delta as R
from repro.dist import halo as RH
from repro.graph.generators import citation_like
from repro.graph.structure import blocked_adjacency as ref_blocked_adjacency
from repro_torch.core.partition import partition_graph
from repro_torch.dist import delta as D
from repro_torch.dist import halo as H
from repro_torch.graph.structure import blocked_adjacency
from repro_torch.kernels import fused_gcn as fg
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
from repro_torch.kernels.ref import poison_padding
from repro_torch.train.elastic import elastic_replan

PLAN_FIELDS = ("send_idx", "senders_l", "receivers_l", "edge_w", "perm", "part_sizes", "send_loc", "send_rem")


def _mk(n, e, k, seed, *, refine=False):
    g = citation_like(n, e, seed=seed)
    w = (0.1 + np.random.default_rng(seed).random(g.n_edges)).astype(np.float32)
    part = partition_graph(n, g.edge_index, k, method="bfs", seed=seed, refine=refine)
    rpart = ref_partition_graph(n, g.edge_index, k, method="bfs", seed=seed, refine=refine)
    assert np.array_equal(part.assignment, rpart.assignment)
    return g, w, part, rpart


def port_delta(d) -> D.GraphDelta:
    return D.GraphDelta(edge_inserts=d.edge_inserts, edge_deletes=d.edge_deletes, insert_w=d.insert_w,
                        feature_touches=d.feature_touches, feature_values=d.feature_values)


def plans_equal(a, b):
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        assert np.array_equal(x, y), f
    assert (a.s_max, a.s_loc, a.s_rem, a.e_local, a.n_local, tuple(a.axes), a.n_pods) == \
        (b.s_max, b.s_loc, b.s_rem, b.e_local, b.n_local, tuple(b.axes), b.n_pods)


def reports_equal(mine: dict, ref: dict):
    skip = {"apply_ms", "relocalized", "drift"}
    assert set(mine) == set(ref)
    assert {k: v for k, v in mine.items() if k not in skip} == {k: v for k, v in ref.items() if k not in skip}
    assert (mine["drift"] is None) == (ref["drift"] is None)
    if mine["drift"] is not None:
        assert mine["drift"] == ref["drift"]
    assert (mine["relocalized"] is None) == (ref["relocalized"] is None)
    if mine["relocalized"] is not None:
        relocalize_reports_equal(mine["relocalized"], ref["relocalized"])


def relocalize_reports_equal(mine: dict, ref: dict):
    skip = {"relocalize_ms", "old_layout"}
    assert {k: v for k, v in mine.items() if k not in skip} == {k: v for k, v in ref.items() if k not in skip}
    for f in ("k", "n_local", "n_nodes", "perm", "part_sizes"):
        assert np.array_equal(getattr(mine["old_layout"], f), getattr(ref["old_layout"], f))


def compact_reports_equal(mine: dict, ref: dict):
    skip = {"compact_ms"}
    assert {k: v for k, v in mine.items() if k not in skip} == {k: v for k, v in ref.items() if k not in skip}


def tables_equal(a, b):
    assert np.array_equal(a.vals, b.vals) and np.array_equal(a.cols, b.cols) and np.array_equal(a.lens, b.lens)
    assert (a.block, a.n_rows, a.n_cols) == (b.block, b.n_rows, b.n_cols)


class Pair:
    """The reference planner and the port's, in lockstep."""

    def __init__(self, n, e, k, seed, *, schedules, policy=None, refine=False, w_fn=None):
        self.policy = policy
        self.g, self.w, self.part, self.rpart = _mk(n, e, k, seed, refine=refine)
        if w_fn is not None:
            self.w = w_fn(self.g.edge_index)
        rp = None if policy is None else R.RelocalizePolicy(**policy)
        tp = None if policy is None else D.RelocalizePolicy(**policy)
        self.ref = R.DeltaPlanner(self.rpart, self.g.edge_index, self.w, relocalize_policy=rp)
        self.port = D.DeltaPlanner(self.part, self.g.edge_index, self.w, relocalize_policy=tp)
        self.rplans = [self.ref.plan(axes=a, pods=p) for a, p in schedules]
        self.plans = [self.port.plan(axes=a, pods=p) for a, p in schedules]
        self.ei, self.ww = self.g.edge_index.astype(np.int64), self.w

    def apply(self, d, **kw):
        rr, rp = self.ref.apply(d, **kw), self.port.apply(port_delta(d), **kw)
        reports_equal(rp, rr)
        self.ei, self.ww = O.apply_delta_to_edges(self.ei, self.ww, d)
        self.check()
        return rp

    def check(self):
        assert self.port.n_edges == self.ref.n_edges == self.ei.shape[1]
        assert self.port.graph_key.endswith(self.ref.graph_key[len(self.ref.base_key):])
        assert np.array_equal(self.port.edge_index(), self.ref.edge_index())
        assert np.array_equal(self.port.edge_weights(), self.ref.edge_weights())
        assert np.array_equal(self.port.assignment, self.ref.assignment)
        for a, b in zip(self.plans, self.rplans):
            plans_equal(a, b)
            O.assert_plan_matches_rebuild(a, self.port.part, self.ei, self.ww)


# ---------------------------------------------------------- v0 == build_halo
def test_v0_plans_bit_identical_to_builder():
    g, w, part, rpart = _mk(128, 700, 4, seed=3)
    pl = D.DeltaPlanner(part, g.edge_index, w)
    plans_equal(pl.plan(), H.build_halo_plan(part, g.edge_index, w))
    plans_equal(pl.plan(), RH.build_halo_plan(rpart, g.edge_index, w))
    hier = pl.plan(axes=("pod", "model"), pods=2)
    plans_equal(hier, H.build_halo_plan(part, g.edge_index, w, axes=("pod", "model"), pods=2))
    plans_equal(hier, RH.build_halo_plan(rpart, g.edge_index, w, axes=("pod", "model"), pods=2))
    assert pl.base_key == R.DeltaPlanner(rpart, g.edge_index, w).base_key


# ------------------------------------------------- random-mutation sequences
@pytest.mark.parametrize("n,e,k,seed", [(48, 120, 2, 0), (90, 400, 4, 7), (140, 600, 4, 19), (64, 300, 2, 30),
                                        (120, 500, 4, 11)])
def test_delta_vs_reference_flat_random_sequences(n, e, k, seed):
    pair = Pair(n, e, k, seed, schedules=[(("model",), 1)])
    rng = np.random.default_rng(seed + 1)
    for _ in range(6):
        pair.apply(O.random_delta(rng, n, pair.ei, max_ops=8))


@pytest.mark.parametrize("n,e,seed", [(64, 200, 0), (100, 450, 5), (160, 700, 23), (80, 300, 30), (150, 600, 12)])
def test_delta_vs_reference_hier_random_sequences(n, e, seed):
    pair = Pair(n, e, 4, seed, schedules=[(("pod", "model"), 2)])
    rng = np.random.default_rng(seed + 1)
    for _ in range(6):
        pair.apply(O.random_delta(rng, n, pair.ei, max_ops=8))


def _materialize(pair, blk):
    """Both packages' all-rank tables, built where a structural apply
    dropped them (the rank tables are rebuilt at once, so the two forms
    stay slice-equal only if the all-rank ones are rebuilt at the same
    points)."""
    for a, b in zip(pair.plans, pair.rplans):
        H.plan_blocked_adjacency(a, blk)
        H.plan_split_blocked_adjacency(a, blk)
        RH.plan_blocked_adjacency(b, blk)
        RH.plan_split_blocked_adjacency(b, blk)


def _with_tables(pair, blk, ranks=True):
    _materialize(pair, blk)
    if not ranks:
        return []
    # one replica per rank holding only that rank's tables
    reps = []
    for r in range(pair.port.k):
        rp = D.DeltaPlanner(pair.part, pair.g.edge_index, pair.w, relocalize_policy=None if pair.policy is None
                            else D.RelocalizePolicy(**pair.policy))
        plans = [rp.plan(axes=p.axes, pods=p.n_pods) for p in pair.plans]
        reps.append((rp, [[rp.rank_table(p, r, blk, part) for part in ("combined", "interior", "boundary")]
                          for p in plans]))
    return reps


def _check_tables(pair, blk, reps):
    for i, (a, b) in enumerate(zip(pair.plans, pair.rplans)):
        comb = H.plan_blocked_adjacency(a, blk)
        tables_equal(comb, RH.plan_blocked_adjacency(b, blk))
        split = H.plan_split_blocked_adjacency(a, blk)
        for x, y in zip(split, RH.plan_split_blocked_adjacency(b, blk)):
            tables_equal(x, y)
        whole = {"combined": comb, "interior": split[0], "boundary": split[1]}
        for r, (_, tables) in enumerate(reps):
            for rt in tables[i]:
                full = whole[rt.part]
                assert np.array_equal(rt.vals, full.vals[r]), (r, rt.part)
                assert np.array_equal(rt.cols, full.cols) and np.array_equal(rt.lens, full.lens)
                ba = rt.blocked()
                assert np.array_equal(ba.block_cols, full.cols[r]) and np.array_equal(ba.row_nnzb, full.lens[r])


def test_delta_200_step_acceptance(delta_seed):
    """200 random mutation steps on one planner pair holding a flat and a
    hierarchical plan: every step's plans and reports equal the
    reference's, the patched tables (all-rank and each rank's) bit-equal
    at checkpoints."""
    seed = 1000 + delta_seed
    n, e, k, blk = 192, 1200, 4, 32
    pair = Pair(n, e, k, seed % 97, schedules=[(("model",), 1), (("pod", "model"), 2)])
    reps = _with_tables(pair, blk)
    rng = np.random.default_rng(seed)
    patched = grown = 0
    for step in range(200):
        d = O.random_delta(rng, n, pair.ei, max_ops=10)
        rep = pair.apply(d)
        for rp, _ in reps:
            rp.apply(port_delta(d))
        _materialize(pair, blk)
        patched += rep["blocked_patched"]
        grown += rep["blocked_grown"]
        if step % 25 == 24:
            _check_tables(pair, blk, reps)
    assert patched > 0, "no blocked table was ever tile-patched"
    assert grown > 0, "no table ever grew"
    assert pair.port.version == 200 and pair.port.graph_key.endswith("@d200")


def _w_of(ei):
    ei = np.asarray(ei, np.int64)
    return (0.1 + (ei[0] * 131 + ei[1] * 17) % 97 / 97.0).astype(np.float32)


def _maintenance_delta(rng, n, ei, max_ops=8):
    d = O.random_delta(rng, n, ei, max_ops=max_ops)
    return dataclasses.replace(d, insert_w=_w_of(d.edge_inserts))


@pytest.mark.parametrize("n,e,seed", [(140, 500, 0), (180, 800, 9), (220, 1000, 21), (200, 700, 30)])
def test_soak_interleaved_maintenance_random_sequences(n, e, seed):
    policy = dict(threshold=1.01, patience=2, cooldown=2, block=32)
    pair = Pair(n, e, 4, seed, schedules=[(("model",), 1), (("pod", "model"), 2)], policy=policy, w_fn=_w_of)
    reps = _with_tables(pair, 32)
    rng = np.random.default_rng(seed + 17)
    for step in range(12):
        act = step % 6
        if act == 4:
            compact_reports_equal(pair.port.compact(), pair.ref.compact())
            for rp, _ in reps:
                rp.compact()
            pair.check()
            _materialize(pair, 32)
        elif act == 5:
            relocalize_reports_equal(pair.port.relocalize(block=32), pair.ref.relocalize(block=32))
            for rp, _ in reps:
                rp.relocalize(block=32)
            assert pair.port.locality_drift(32)["drift_ratio"] == 1.0
            pair.check()
            _materialize(pair, 32)
        else:
            d = _maintenance_delta(rng, n, pair.ei)
            pair.apply(d)
            for rp, _ in reps:
                rp.apply(port_delta(d))
            _materialize(pair, 32)
        _check_tables(pair, 32, reps)


def test_delta_200_step_acceptance_with_maintenance(delta_seed):
    seed = 2000 + delta_seed
    n, e, k, blk = 192, 1200, 4, 32
    policy = dict(threshold=1.02, patience=3, cooldown=8, block=blk)
    pair = Pair(n, e, k, seed % 97, schedules=[(("model",), 1), (("pod", "model"), 2)], policy=policy,
                w_fn=_w_of)
    rng = np.random.default_rng(seed)
    fired = compacts = 0
    for step in range(200):
        if step % 50 == 49:
            mine, ref = pair.port.compact(), pair.ref.compact()
            compact_reports_equal(mine, ref)
            compacts += bool(mine["changed"])
        rep = pair.apply(_maintenance_delta(rng, n, pair.ei, max_ops=10))
        if rep["relocalized"] is not None:
            fired += 1
            assert pair.port.locality_drift(blk)["drift_ratio"] == 1.0
    assert fired >= 1
    assert pair.port.version == pair.ref.version >= 200 + fired


# ------------------------------------------------------ blocked tables (bsr)
def test_patched_plan_blocked_tables_bit_equal_and_poison(delta_seed):
    """Patched per-shard tables equal the reference's patched tables and a
    re-block; the port's plain K1 and K2 aggregations over each rank's
    patched table equal the re-blocked table's, and on a NaN-poisoned copy
    stay finite and equal (padding is never read)."""
    n, e, k = 256, 1600, 4
    pair = Pair(n, e, k, 5, schedules=[(("model",), 1)])
    _with_tables(pair, 128, ranks=False)
    rng = np.random.default_rng(200 + delta_seed)
    for _ in range(8):
        pair.apply(O.random_delta(rng, n, pair.ei, max_ops=12))
    plan, rplan = pair.plans[0], pair.rplans[0]
    mine = H.plan_blocked_adjacency(plan, 128)
    tables_equal(mine, RH.plan_blocked_adjacency(rplan, 128))
    ref = H.plan_blocked_adjacency(dataclasses.replace(plan), 128)
    O.assert_blocked_matches(mine, ref)
    z = torch.from_numpy(rng.standard_normal((-(-mine.n_cols // 128) * 128, 16)).astype(np.float32))
    b = torch.zeros(16)
    for r in range(k):
        vals, cols, lens = (torch.from_numpy(a[r]) for a in (mine.vals, mine.cols, mine.lens))
        rv, rc, rl = (torch.from_numpy(a[r]) for a in (ref.vals, ref.cols, ref.lens))
        poisoned = poison_padding(vals, lens)
        for fn in (lambda v, c, l: bsr_spmm_plain(v, c, l, z),
                   lambda v, c, l: fg.ff_aggregate_plain(v, c, l, z, b, True)):
            out, out_ref = fn(vals, cols, lens), fn(rv, rc, rl)
            assert float((out - out_ref).abs().max()) < 1e-4
            out_p = fn(poisoned, cols, lens)
            assert bool(torch.isfinite(out_p).all()), "a poisoned tile was read"
            assert torch.equal(out_p, out)


def test_rank_table_slice_equals_all_rank_patch_with_growth():
    """Inserts packed into one receiver block-row force the shared width T
    to grow (geometrically, ``max(need, 2·T)``): each rank's table, patched
    alone, equals slice b of the all-rank patch and of the reference's,
    its ``grown`` count matches, and no rank table holds another rank's
    tiles."""
    n, e, k, blk = 256, 900, 4, 16
    pair = Pair(n, e, k, 3, schedules=[(("model",), 1)])
    reps = _with_tables(pair, blk)
    rng = np.random.default_rng(4)
    widths = [H.plan_blocked_adjacency(pair.plans[0], blk).max_nnzb]
    target = np.flatnonzero(pair.part.assignment == 0)[:blk]
    for _ in range(4):
        src = rng.integers(0, n, 3 * blk)
        dst = target[rng.integers(0, target.size, src.size)]
        rep = pair.apply(R.GraphDelta(edge_inserts=np.stack([src, dst])))
        for rp, _ in reps:
            rp.apply(port_delta(R.GraphDelta(edge_inserts=np.stack([src, dst]))))
        _materialize(pair, blk)
        widths.append(H.plan_blocked_adjacency(pair.plans[0], blk).max_nnzb)
        if not rep["structural"]:
            _check_tables(pair, blk, reps)
    _check_tables(pair, blk, reps)
    assert widths[-1] > widths[0]
    assert any(rt.grown for _, tables in reps for rt in tables[0])
    for r, (_, tables) in enumerate(reps):
        assert all(rt.vals.shape[:2] == rt.cols.shape[1:] for rt in tables[0])
        assert all(rt.rank == r for rt in tables[0])


def test_rank_table_paths_and_errors():
    """A rank table is patched by a non-structural apply (counted in the
    report as the all-rank table would be), rebuilt by a structural one
    (the caller's handle stays valid) into a fresh build at the shared
    width, and belongs to its planner's plans only."""
    g, w, part, _ = _mk(128, 700, 4, seed=2)
    pl = D.DeltaPlanner(part, g.edge_index, w)
    plan = pl.plan()
    rt = pl.rank_table(plan, 1, 32)
    assert rt.last == "built" and pl.rank_table(plan, 1, 32) is rt
    rep = pl.apply(D.GraphDelta(edge_deletes=g.edge_index[:, :3]))
    assert not rep["structural"] and rt.last in ("patched", "unchanged")
    assert rep["blocked_patched"] == (rt.last == "patched")
    a = part.assignment
    src = np.flatnonzero(a == 0).astype(np.int64)
    dst = np.full(src.size, int(np.flatnonzero(a == 1)[0]), np.int64)
    rep = pl.apply(D.GraphDelta(edge_inserts=np.stack([src, dst])))
    assert rep["structural"] and rt.last == "rebuilt" and rep["blocked_dropped"] == 1
    assert pl.rank_table(plan, 1, 32) is rt
    fresh = H.plan_blocked_rank(plan, 1, 32, max_nnzb=H.plan_blocked_shape(plan, 32)["max_nnzb"])
    assert np.array_equal(rt.vals, fresh.block_vals) and np.array_equal(rt.cols[1], fresh.block_cols)
    assert np.array_equal(rt.lens[1], fresh.row_nnzb)
    other = D.DeltaPlanner(part, g.edge_index, w)
    with pytest.raises(ValueError, match="not one of this planner's"):
        other.rank_table(plan, 0)


def test_delta_update_global_blocked_adjacency(delta_seed):
    g = citation_like(200, 900, seed=2)
    w = (0.1 + np.random.default_rng(1).random(g.n_edges)).astype(np.float32)
    g = dataclasses.replace(g, edge_weight=w)
    blk = 16
    ba = blocked_adjacency(g.n_nodes, g.edge_index, g.edge_weight, blk)
    rba = ref_blocked_adjacency(g.n_nodes, g.edge_index, g.edge_weight, blk)
    rng = np.random.default_rng(9 + delta_seed)
    t_hist = [ba.max_nnzb]
    rg = g
    for _ in range(30):
        d = O.random_delta(rng, g.n_nodes, g.edge_index, max_ops=10)
        g = D.apply_delta_to_graph(g, port_delta(d))
        rg = R.apply_delta_to_graph(rg, d)
        assert np.array_equal(g.edge_index, rg.edge_index) and np.array_equal(g.edge_weight, rg.edge_weight)
        ba = D.delta_update_blocked_adjacency(ba, g.edge_index, g.edge_weight, port_delta(d))
        rba = R.delta_update_blocked_adjacency(rba, rg.edge_index, rg.edge_weight, d)
        assert np.array_equal(ba.block_vals, rba.block_vals) and np.array_equal(ba.block_cols, rba.block_cols)
        assert np.array_equal(ba.row_nnzb, rba.row_nnzb)
        t_hist.append(ba.max_nnzb)
        fresh = blocked_adjacency(g.n_nodes, g.edge_index, g.edge_weight, blk)
        dm = O.densify(ba.block_vals, ba.block_cols, ba.row_nnzb, g.n_nodes, ba.n_col_nodes)
        dr = O.densify(fresh.block_vals, fresh.block_cols, fresh.row_nnzb, g.n_nodes, fresh.n_col_nodes)
        assert np.abs(dm - dr).max() < 1e-5
    assert all(b >= a for a, b in zip(t_hist, t_hist[1:])), "T shrank"


@pytest.mark.parametrize("case", ["tombstone", "append_into_full_row"])
def test_tombstone_and_full_row_cases_match(case):
    if case == "tombstone":
        ei = np.asarray([[0, 1, 40], [0, 0, 0]], np.int64)
        n, d = 64, dict(edge_deletes=np.asarray([[40], [0]]))
    else:
        ei = np.asarray([[0, 40], [0, 0]], np.int64)
        n, d = 96, dict(edge_deletes=np.asarray([[40], [0]]), edge_inserts=np.asarray([[70], [0]]))
    ba = blocked_adjacency(n, ei, None, 32, n_col_nodes=n)
    rba = ref_blocked_adjacency(n, ei, None, 32, n_col_nodes=n)
    g = dataclasses.replace(citation_like(n, 4, seed=0), edge_index=ei, edge_weight=None)
    g2 = D.apply_delta_to_graph(g, D.GraphDelta(**d))
    ba = D.delta_update_blocked_adjacency(ba, g2.edge_index, g2.edge_weight, D.GraphDelta(**d))
    rba = R.delta_update_blocked_adjacency(rba, g2.edge_index, g2.edge_weight, R.GraphDelta(**d))
    assert np.array_equal(ba.block_vals, rba.block_vals) and np.array_equal(ba.block_cols, rba.block_cols)
    assert np.array_equal(ba.row_nnzb, rba.row_nnzb)
    if case == "tombstone":
        assert int(ba.row_nnzb[0]) == 1 and not ba.block_vals[0, 1:].any()
        pz = poison_padding(torch.from_numpy(ba.block_vals), torch.from_numpy(ba.row_nnzb))
        assert torch.isnan(pz[0, 1]).all() and not torch.isnan(pz[0, 0]).any()
    else:
        assert ba.max_nnzb == 2 and int(ba.row_nnzb[0]) == 2


# -------------------------------------------------------- plan-cache re-key
def _boom():
    raise RuntimeError("builder re-ran on what should be a cache hit (rebuilt)")


def test_versioned_rekey_old_key_misses_new_key_hits():
    g, w, part, _ = _mk(96, 500, 4, seed=7)
    H.invalidate_halo_plans()
    H.reset_plan_cache_stats()
    pl = D.DeltaPlanner(part, g.edge_index, w)
    p = pl.plan()
    key0 = pl.graph_key
    assert H.cached_halo_plan(key0, 4, "model", builder=_boom) is p
    rep = pl.apply(D.GraphDelta(edge_inserts=np.asarray([[1], [90]])))
    assert rep["stale_keys_evicted"] == 1
    key1 = pl.graph_key
    assert key1 != key0 and key1.endswith("@d1")
    assert H.cached_halo_plan(key1, 4, "model", builder=_boom) is p
    with pytest.raises(RuntimeError, match="rebuilt"):
        H.cached_halo_plan(key0, 4, "model", builder=_boom)
    assert H.plan_cache_stats()["evictions"] >= 1
    H.invalidate_halo_plans()


def test_rekey_covers_every_schedule_flavor():
    g, w, part, _ = _mk(96, 500, 4, seed=8)
    H.invalidate_halo_plans()
    pl = D.DeltaPlanner(part, g.edge_index, w)
    flat = pl.plan()
    hier = pl.plan(axes=("pod", "model"), pods=2)
    key0 = pl.graph_key
    rep = pl.apply(D.GraphDelta(edge_deletes=g.edge_index[:, :1]))
    assert rep["stale_keys_evicted"] == 2
    key1 = pl.graph_key
    assert H.cached_halo_plan(key1, 4, "model", builder=_boom) is flat
    assert H.cached_halo_plan(key1, 4, ("pod", "model"), pods=2, builder=_boom) is hier
    for axes, pods in (("model", 1), (("pod", "model"), 2)):
        with pytest.raises(RuntimeError):
            H.cached_halo_plan(key0, 4, axes, pods=pods, builder=_boom)
    H.invalidate_halo_plans()


def test_bad_schedules_raise_like_the_reference():
    g, w, part, rpart = _mk(96, 500, 4, seed=8)
    pl, rpl = D.DeltaPlanner(part, g.edge_index, w), R.DeltaPlanner(rpart, g.edge_index, w)
    for kw in (dict(axes=("model",), pods=2), dict(axes=("pod", "model"), pods=3), dict(axes=("a", "b", "c"))):
        with pytest.raises(ValueError) as mine:
            pl.plan(**kw)
        with pytest.raises(ValueError) as ref:
            rpl.plan(**kw)
        assert str(mine.value) == str(ref.value)


# ------------------------------------------------------------------ elastic
def test_elastic_pure_resize_keeps_delta_plans():
    g, w, part, _ = _mk(96, 500, 4, seed=11)
    H.invalidate_halo_plans()
    H.reset_plan_cache_stats()
    pl = D.DeltaPlanner(part, g.edge_index, w, graph_key="elastic-g")
    p = pl.plan()
    pl.apply(D.GraphDelta(edge_deletes=g.edge_index[:, :2]))
    before = H.plan_cache_stats()
    plan = elastic_replan(12, 4, graph_key=pl.graph_key)
    assert plan.shape == (3, 4)
    assert H.plan_cache_stats()["evictions"] == before["evictions"]
    assert H.cached_halo_plan(pl.graph_key, 4, "model", builder=_boom) is p
    elastic_replan(3, 4, graph_key=pl.graph_key)       # m 4 → 2: the repaired plan goes too
    with pytest.raises(RuntimeError):
        H.cached_halo_plan(pl.graph_key, 4, "model", builder=_boom)
    H.invalidate_halo_plans()


# --------------------------------------------------------------- validation
def _raises_same(fn_mine, fn_ref):
    with pytest.raises(Exception) as mine:
        fn_mine()
    with pytest.raises(Exception) as ref:
        fn_ref()
    assert type(mine.value) is type(ref.value) and str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw,n", [
    (dict(edge_inserts=np.asarray([[5], [99]])), 50),
    (dict(edge_inserts=np.asarray([[1], [2]]), insert_w=np.asarray([1.0, 2.0])), 10),
    (dict(edge_inserts=np.asarray([[1], [2]]), insert_w=np.asarray([0.0])), 10),
    (dict(feature_touches=np.asarray([1, 2]), feature_values=np.zeros((1, 4), np.float32)), 10),
    (dict(feature_touches=np.asarray([-1])), 10),
])
def test_graph_delta_validation_errors(kw, n):
    _raises_same(lambda: D.GraphDelta(**kw).validate(n), lambda: R.GraphDelta(**kw).validate(n))


def test_graph_delta_shape_and_properties():
    _raises_same(lambda: D.GraphDelta(edge_inserts=np.zeros((3, 2))),
                 lambda: R.GraphDelta(edge_inserts=np.zeros((3, 2))))
    assert D.GraphDelta.empty().is_empty
    d = dict(edge_inserts=np.asarray([[1, 4], [2, 2]]), edge_deletes=np.asarray([[7], [1]]),
             feature_touches=np.asarray([9, 3]))
    a, b = D.GraphDelta(**d), R.GraphDelta(**d)
    assert a.n_ops == b.n_ops == 5
    assert np.array_equal(a.edge_nodes(), b.edge_nodes()) and np.array_equal(a.touched_nodes(), b.touched_nodes())
    _raises_same(lambda: D.GraphDelta(feature_touches=np.asarray([1]), feature_values=np.zeros((1, 3))).validate(
        5, feat_dim=4), lambda: R.GraphDelta(feature_touches=np.asarray([1]),
                                            feature_values=np.zeros((1, 3))).validate(5, feat_dim=4))


def test_absent_delete_raises_everywhere():
    g, w, part, rpart = _mk(64, 300, 2, seed=14)
    d = dict(edge_deletes=np.asarray([[63], [62]]))
    assert not ((g.edge_index[0] == 63) & (g.edge_index[1] == 62)).any()
    _raises_same(lambda: D.apply_delta_to_graph(g, D.GraphDelta(**d)),
                 lambda: R.apply_delta_to_graph(g, R.GraphDelta(**d)))
    _raises_same(lambda: D.DeltaPlanner(part, g.edge_index, w).apply(D.GraphDelta(**d)),
                 lambda: R.DeltaPlanner(rpart, g.edge_index, w).apply(R.GraphDelta(**d)))


def test_apply_delta_to_graph_is_order_preserving():
    g = citation_like(30, 60, 8, 3, seed=1)
    keep_before = [tuple(c) for c in g.edge_index.T.tolist()]
    victim = keep_before[10]
    d = dict(edge_deletes=np.asarray([[victim[0]], [victim[1]]]), edge_inserts=np.asarray([[3], [4]]),
             feature_touches=np.asarray([7]), feature_values=np.full((1, 8), 5.0, np.float32))
    g2, r2 = D.apply_delta_to_graph(g, D.GraphDelta(**d)), R.apply_delta_to_graph(g, R.GraphDelta(**d))
    after = [tuple(c) for c in g2.edge_index.T.tolist()]
    assert after == [c for i, c in enumerate(keep_before) if i != 10] + [(3, 4)]
    assert np.array_equal(g2.edge_index, r2.edge_index) and np.array_equal(g2.features, r2.features)
    assert (g2.edge_weight is None) == (r2.edge_weight is None)
    assert np.allclose(g2.features[7], 5.0) and g2.features is not g.features
