"""`repro_torch.serve.graph` and `repro_torch.graph.sampler` against the
JAX package's `repro.serve.graph` / `repro.graph.sampler`, on the CPU.

One counterpart for each test of tests/test_serve_graph.py, run on the same
seeded inputs through both packages: the sampler's blocks (node ids,
senders, receivers, injections, harvests) are `np.array_equal` and their
edge weights equal; the engine's logits are within the reference's 1e-5
of the reference engine's (parameters carried across by
`params_from_numpy`); every host count — micro-batches, traces, nodes and
edges sampled, hits, misses, evictions, rows and bytes saved, foreign rows,
residents dropped — equals the reference's. The reference's property test
over interleaved mutations never runs its body here (``@given`` over a
function-scoped fixture fails its health check); its counterpart is a
deterministic loop over seeds 0–40 against both the reference engine and a
fresh cache-less port engine.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _delta_oracle import random_delta
from repro.core.partition import partition_graph as ref_partition_graph
from repro.dist.delta import GraphDelta as RefDelta
from repro.graph.generators import citation_like
from repro.graph.sampler import NeighborSampler as RefNeighborSampler
from repro.models.gcn import GCNConfig as RefConfig
from repro.models.gcn import gcn_init
from repro.serve import graph as ref_serve
from repro_torch.core.partition import partition_graph
from repro_torch.dist.delta import GraphDelta
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.models.gcn import GCNConfig, params_from_numpy
from repro_torch.serve import graph as port_serve
from repro_torch.serve.graph import GraphBatcher, HotNeighborCache, ServeSampler, hot_query_stream

TOL = 1e-5


def _setup(seed=0, n=300, e=2400, f=16, c=4, hidden=8, dims=None):
    g = citation_like(n, e, f, c, seed=seed)
    dims = dims or (f, hidden, c)
    params = {k: np.asarray(v) for k, v in gcn_init(jax.random.PRNGKey(seed), RefConfig(layer_dims=dims)).items()}
    return g, dims, params


def _engines(g, dims, params, **kw):
    """The reference engine and the port's, on the same graph, parameters
    and options."""
    ref = ref_serve.GraphBatcher(params, g, RefConfig(layer_dims=dims), **kw)
    port = GraphBatcher(params_from_numpy(params, device="cpu"), g, GCNConfig(layer_dims=dims),
                        device="cpu", **kw)
    return ref, port


def _port_delta(d: RefDelta) -> GraphDelta:
    return GraphDelta(edge_inserts=d.edge_inserts, edge_deletes=d.edge_deletes, insert_w=d.insert_w,
                      feature_touches=d.feature_touches, feature_values=d.feature_values)


def _serve(eng, waves):
    for wave in waves:
        for v in wave:
            eng.submit(int(v))
        eng.run_until_drained()
    return eng


def _assert_same_counts(ref, port):
    a, b = ref.stats(), port.stats()
    for k in ("queries", "micro_batches", "traces", "nodes_per_query", "edges_per_query", "foreign_rows"):
        assert a[k] == b[k], k
    assert a.get("cache") == b.get("cache")
    assert (ref.nodes_sampled, ref.edges_sampled) == (port.nodes_sampled, port.edges_sampled)


def _assert_same_logits(ref, port):
    assert [q.qid for q in ref.finished] == [q.qid for q in port.finished]
    for qa, qb in zip(ref.finished, port.finished):
        np.testing.assert_allclose(qb.logits, qa.logits, rtol=TOL, atol=TOL)
        assert qa.micro_batch == qb.micro_batch


def _assert_blocks_equal(a, b):
    for f in ("node_ids", "senders", "receivers"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(a.edge_weight, b.edge_weight)
    assert (a.n_seeds, a.n_nodes, a.n_edges, a.max_nodes, a.max_edges) == \
        (b.n_seeds, b.n_nodes, b.n_edges, b.max_nodes, b.max_edges)
    assert a.inject == b.inject and a.harvest == b.harvest
    assert (a.cache_hits, a.cache_misses) == (b.cache_hits, b.cache_misses)


# ---------------------------------------------------------------- host pieces
def test_hot_query_stream_and_mix64_match():
    g, _, _ = _setup()
    for seed in (0, 1, 7):
        assert np.array_equal(hot_query_stream(g, 50, seed=seed), ref_serve.hot_query_stream(g, 50, seed=seed))
    x = np.arange(-5, 1000, 7, dtype=np.int64)
    assert np.array_equal(port_serve._mix64(x), ref_serve._mix64(x))


@pytest.mark.parametrize("fanout", [(3,), (4, 2), (5, 3, 2)])
def test_neighbor_sampler_matches_reference(fanout):
    g, _, _ = _setup()
    a, b = RefNeighborSampler(g, fanout, seed=3), NeighborSampler(g, fanout, seed=3)
    assert a.max_shapes(6) == b.max_shapes(6)
    for blk_a, blk_b in zip(a.epoch(6, 4), b.epoch(6, 4)):
        for f in ("node_ids", "senders", "receivers"):
            assert np.array_equal(getattr(blk_a, f), getattr(blk_b, f)), f
        assert (blk_a.n_nodes, blk_a.n_edges) == (blk_b.n_nodes, blk_b.n_edges)
        assert np.array_equal(blk_a.edge_mask, blk_b.edge_mask)
    with pytest.raises(ValueError, match="duplicate"):
        b.sample(np.asarray([1, 1]))


# ------------------------------------------------------------------- sampler
def test_serve_sampler_deterministic_and_pure():
    g, _, _ = _setup()
    s1 = ServeSampler(g, fanout=4, n_layers=2, seed=7)
    ref = ref_serve.ServeSampler(g, fanout=4, n_layers=2, seed=7)
    nodes = np.arange(50)
    assert np.array_equal(s1.neighbors(nodes), ref.neighbors(nodes))
    assert np.array_equal(s1.in_deg, ref.in_deg)
    np.testing.assert_array_equal(s1.edge_w(nodes, nodes[::-1]), ref.edge_w(nodes, nodes[::-1]))
    np.testing.assert_array_equal(
        s1.neighbors(np.asarray([3])), s1.neighbors(np.asarray([9, 3, 40]))[1:2])
    s3 = ServeSampler(g, fanout=4, n_layers=2, seed=8)
    assert not np.array_equal(s1.neighbors(nodes), s3.neighbors(nodes))
    assert s1.max_shapes(4) == ref.max_shapes(4) and s1.subtree_counts(2) == ref.subtree_counts(2)


def test_serve_sampler_block_replay_identical():
    g, _, _ = _setup()
    gl = g.with_self_loops()
    s = ServeSampler(gl, fanout=3, n_layers=2, seed=0)
    ref = ref_serve.ServeSampler(gl, fanout=3, n_layers=2, seed=0)
    seeds = np.asarray([5, 17, 100])
    a, b = s.sample_block(seeds, batch_seeds=4), s.sample_block(seeds, batch_seeds=4)
    _assert_blocks_equal(a, b)
    _assert_blocks_equal(a, ref.sample_block(seeds, batch_seeds=4))
    assert np.all(a.node_ids[a.n_nodes:] == -1)
    assert np.all(a.senders[a.n_edges:] == a.max_nodes)
    assert np.all(a.edge_weight[a.n_edges:] == 0.0)
    assert a.senders[: a.n_edges].max() < a.n_nodes


def test_serve_sampler_blocks_with_cache_match():
    """With a warm cache the truncated blocks — injections and harvests
    included — are the reference's, lookup for lookup."""
    g, dims, _ = _setup()
    gl = g.with_self_loops()
    s, ref = ServeSampler(gl, 3, 2, seed=0), ref_serve.ServeSampler(gl, 3, 2, seed=0)
    c = HotNeighborCache(64, s.in_deg)
    rc = ref_serve.HotNeighborCache(64, ref.in_deg)
    for v in range(0, 300, 7):
        c.admit(v, 1, np.ones(dims[1], np.float32))
        rc.admit(v, 1, np.ones(dims[1], np.float32))
    for seeds in ([5, 17], [0, 7, 14, 21], [299]):
        _assert_blocks_equal(s.sample_block(np.asarray(seeds), 4, c), ref.sample_block(np.asarray(seeds), 4, rc))
    assert c.stats() == rc.stats()


# -------------------------------------------------------------- compile once
def test_compile_once_across_live_sizes():
    g, dims, params = _setup()
    ref, eng = _engines(g, dims, params, batch_seeds=4, fanout=3, seed=0)
    for e in (ref, eng):
        for wave in ([1, 2, 3, 4], [5, 6], [7]):       # live sizes 4, 2, 1
            for v in wave:
                e.submit(v)
            e.step()
    assert eng.micro_batches == 3
    assert eng.traces == 1 == ref.traces, "fixed-shape micro-batches must build one forward shape"
    assert all(q.logits is not None for q in eng.finished)
    _assert_same_logits(ref, eng)


# ------------------------------------------------------- cache == no cache
@pytest.mark.parametrize("capacity", [0, 64])
def test_cache_on_matches_cache_off_with_fewer_samples(capacity):
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 40)
    ref, eng = (_serve(e, (nodes, nodes)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                              cache_capacity=capacity, seed=0))
    _assert_same_counts(ref, eng)
    _assert_same_logits(ref, eng)
    if capacity:
        _, off = _engines(g, dims, params, batch_seeds=4, fanout=4, cache_capacity=0, seed=0)
        _serve(off, (nodes, nodes))
        for qa, qb in zip(off.finished, eng.finished):
            np.testing.assert_allclose(qb.logits, qa.logits, rtol=TOL, atol=TOL)
        assert eng.cache.hits > 0
        assert (eng.nodes_sampled + eng.edges_sampled) < (off.nodes_sampled + off.edges_sampled)
        s = eng.stats()["cache"]
        assert s["rows_saved"] > 0 and s["bytes_saved"] > 0


def test_cache_exactness_three_layer_gcn():
    g, dims, params = _setup(dims=(16, 8, 8, 4))
    nodes = hot_query_stream(g, 40)
    ref, on = (_serve(e, (nodes, nodes)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                             cache_capacity=64, seed=0))
    _, off = _engines(g, dims, params, batch_seeds=4, fanout=4, cache_capacity=0, seed=0)
    _serve(off, (nodes, nodes))
    assert on.cache.hits > 0
    _assert_same_counts(ref, on)
    _assert_same_logits(ref, on)
    lo = {q.qid: q.logits for q in off.finished}
    for q in on.finished:
        np.testing.assert_allclose(q.logits, lo[q.qid], rtol=TOL, atol=TOL)
    assert (on.nodes_sampled + on.edges_sampled) < (off.nodes_sampled + off.edges_sampled)


def test_eviction_under_tiny_capacity():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 48)
    ref, on = (_serve(e, (nodes, nodes)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                             cache_capacity=2, seed=0))
    assert len(on.cache) <= 2 and on.cache.evictions > 0
    assert on.cache.evictions == ref.cache.evictions
    _assert_same_counts(ref, on)
    _assert_same_logits(ref, on)


def test_cache_hits_counted_exactly_once_hand_counted():
    g, dims, _ = _setup()
    s = ServeSampler(g, fanout=3, n_layers=2, seed=0)
    c = HotNeighborCache(capacity=64, degree=s.in_deg)
    seeds = np.asarray([5, 17])
    blk = s.sample_block(seeds, batch_seeds=2, cache=c)
    assert blk.cache_hits == 0 and c.hits == 0
    assert blk.cache_misses > 0 and c.misses == blk.cache_misses
    for v in blk.node_ids[: blk.n_nodes]:
        c.admit(int(v), 1, np.ones(dims[1], np.float32))
    h0, m0 = c.hits, c.misses
    blk2 = s.sample_block(seeds, batch_seeds=2, cache=c)
    assert blk2.cache_hits > 0
    assert c.hits - h0 == blk2.cache_hits
    assert c.misses - m0 == blk2.cache_misses
    assert c.stats()["hits"] == c.hits
    assert c.stats()["hit_rate"] == pytest.approx(c.hits / (c.hits + c.misses))


def test_engine_hits_match_lookup_tally():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 40)
    ref, eng = _engines(g, dims, params, batch_seeds=4, fanout=4, cache_capacity=64, seed=0)
    calls = {"hit": 0, "miss": 0}
    orig_lookup = eng.cache.lookup

    def counting_lookup(node, layer):
        val = orig_lookup(node, layer)
        calls["hit" if val is not None else "miss"] += 1
        return val

    eng.cache.lookup = counting_lookup
    _serve(eng, (nodes, nodes))
    _serve(ref, (nodes, nodes))
    s = eng.stats()["cache"]
    assert calls["hit"] > 0
    assert s["hits"] == calls["hit"] == ref.stats()["cache"]["hits"]
    assert s["misses"] == calls["miss"] == ref.stats()["cache"]["misses"]


def test_bytes_saved_dtype_aware_formula():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 32)
    ref, on = (_serve(e, (nodes, nodes)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                             cache_capacity=64, seed=0))
    s = on.stats()["cache"]
    assert s == ref.stats()["cache"]
    feat_bytes = on.features.dtype.itemsize * on.features.shape[1]
    row_bytes = on.features.dtype.itemsize * dims[1]
    rows_per = on.sampler.subtree_counts(1)[0]
    assert s["rows_saved"] > 0 and s["rows_saved"] % rows_per == 0
    n_inj = s["rows_saved"] // rows_per
    assert s["bytes_saved"] == pytest.approx(s["rows_saved"] * feat_bytes - n_inj * row_bytes)
    assert s["bytes_saved"] < s["rows_saved"] * feat_bytes


def test_degree_ranked_admission():
    deg = np.asarray([10, 1, 5, 7])
    c, rc = HotNeighborCache(capacity=2, degree=deg), ref_serve.HotNeighborCache(capacity=2, degree=deg)
    v = np.ones(4, np.float32)
    for cache in (c, rc):
        assert cache.admit(1, 1, v)
        assert cache.admit(2, 1, v)
        assert cache.admit(0, 1, v)
        assert cache.lookup(1, 1) is None and cache.lookup(0, 1) is not None
        assert not cache.admit(1, 1, v)
        assert cache.evictions == 1
    assert c.stats() == rc.stats() and c.resident_depths() == rc.resident_depths()


# ------------------------------------------------------------- invalidation
def test_cache_invalidated_on_weight_and_feature_update():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 24)
    ref, eng = (_serve(e, (nodes,)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                        cache_capacity=64, seed=0))
    assert len(eng.cache) > 0
    new_params = {k: np.asarray(v) for k, v in gcn_init(jax.random.PRNGKey(99), RefConfig(layer_dims=dims)).items()}
    eng.update_params(params_from_numpy(new_params, device="cpu"))
    ref.update_params(new_params)
    assert len(eng.cache) == 0 and eng.cache.invalidations == 1
    _serve(eng, (nodes,))
    _serve(ref, (nodes,))
    _assert_same_logits(ref, eng)
    _, fresh = _engines(g, dims, new_params, batch_seeds=4, fanout=4, seed=0)
    _serve(fresh, (nodes,))
    for qa, qb in zip(eng.finished[len(nodes):], fresh.finished):
        np.testing.assert_allclose(qa.logits, qb.logits, rtol=TOL, atol=TOL)
    eng.update_features(np.asarray(g.features))
    assert eng.cache.invalidations == 2


# ------------------------------------------------------- partition packing
def test_partition_aligned_packing_groups_parts():
    g, dims, params = _setup()
    part = partition_graph(g.n_nodes, g.edge_index, 2, method="block")
    rpart = ref_partition_graph(g.n_nodes, g.edge_index, 2, method="block")
    assert np.array_equal(part.assignment, rpart.assignment)
    eng = GraphBatcher(params_from_numpy(params, device="cpu"), g, GCNConfig(layer_dims=dims), batch_seeds=4,
                       fanout=3, partition=part, seed=0, device="cpu")
    ref = ref_serve.GraphBatcher(params, g, RefConfig(layer_dims=dims), batch_seeds=4, fanout=3,
                                 partition=rpart, seed=0)
    lo, hi = [1, 2, 3, 4], [290, 291, 292, 293]
    for e in (eng, ref):
        for a, b in zip(lo, hi):
            e.submit(a)
            e.submit(b)
    first, second = eng.step(), eng.step()
    rfirst, rsecond = ref.step(), ref.step()
    assert [q.node for q in first] == [q.node for q in rfirst]
    assert [q.node for q in second] == [q.node for q in rsecond]
    p_first = {int(part.assignment[q.node]) for q in first}
    p_second = {int(part.assignment[q.node]) for q in second}
    assert len(p_first) == 1 and len(p_second) == 1 and p_first != p_second
    assert eng.foreign_rows == ref.foreign_rows


def test_partition_packing_foreign_rows_match():
    g, dims, params = _setup()
    part = partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0, refine=True)
    rpart = ref_partition_graph(g.n_nodes, g.edge_index, 4, method="bfs", seed=0, refine=True)
    nodes = hot_query_stream(g, 40)
    ref = ref_serve.GraphBatcher(params, g, RefConfig(layer_dims=dims), batch_seeds=4, fanout=4,
                                 cache_capacity=32, partition=rpart, seed=0)
    eng = GraphBatcher(params_from_numpy(params, device="cpu"), g, GCNConfig(layer_dims=dims), batch_seeds=4,
                       fanout=4, cache_capacity=32, partition=part, seed=0, device="cpu")
    _serve(ref, (nodes, nodes))
    _serve(eng, (nodes, nodes))
    assert eng.foreign_rows == ref.foreign_rows > 0
    _assert_same_counts(ref, eng)
    _assert_same_logits(ref, eng)
    assert eng.export_metrics() == eng.stats()


# ------------------------------------------------------------ other models
def _gnn_engines(model, **kw):
    """The reference's and the port's PNA or EGNN engines on one graph with
    positions, with the reference's parameters (the twin of
    tests/test_serve_graph.py's smoke test, which also serves both)."""
    from repro.models.egnn import EGNNConfig as RefEGNN
    from repro.models.egnn import egnn_init
    from repro.models.pna import PNAConfig as RefPNA
    from repro.models.pna import pna_init
    from repro_torch.models import egnn, pna

    g = citation_like(120, 900, 8, 3, seed=0, with_positions=True)
    if model == "pna":
        rcfg, cfg = RefPNA(n_layers=2, d_hidden=12, d_in=8, d_out=3), pna.PNAConfig(n_layers=2, d_hidden=12, d_in=8, d_out=3)
        params = pna_init(jax.random.PRNGKey(0), rcfg)
    else:
        rcfg, cfg = RefEGNN(n_layers=2, d_hidden=12, d_in=8, d_out=2), egnn.EGNNConfig(n_layers=2, d_hidden=12, d_in=8, d_out=2)
        params = egnn_init(jax.random.PRNGKey(0), rcfg)
    ref = ref_serve.GraphBatcher(params, g, rcfg, model=model, **kw)
    port = GraphBatcher(pna.params_from_numpy(params, device="cpu"), g, cfg, model=model, device="cpu", **kw)
    return g, ref, port


def _recording(ref):
    """Wrap the reference engine's compiled forward so that every call's
    inputs and fp32 output are kept (for a float64 rerun)."""
    calls, fwd = [], ref._fwd

    def rec(params, *args):
        out = fwd(params, *args)
        calls.append((args, np.asarray(out[0])))
        return out

    ref._fwd = rec
    return calls


def _float64_rows(ref, calls):
    """Each finished query's logits from the reference's own serve forward
    rerun in float64 (``jax.enable_x64``) on the same packed micro-batch:
    the row of the fp32 output equal to the query's logits, in the float64
    output."""
    import jax.numpy as jnp

    with jax.enable_x64(True):
        fwd = ref._build_forward()
        p64 = jax.tree.map(lambda v: jnp.asarray(np.asarray(v), jnp.float64), ref.params)
        outs = []
        for (x, s, r, w, masks, vals), out32 in calls:
            out64 = np.asarray(fwd(p64, jnp.asarray(np.asarray(x), jnp.float64), s, r,
                                   jnp.asarray(np.asarray(w), jnp.float64), masks, vals)[0])
            outs.append((out32, out64))
    rows = []
    for q in ref.finished:
        out32, out64 = outs[q.micro_batch]
        (hit,) = np.flatnonzero((out32 == q.logits).all(axis=1))[:1]
        rows.append(out64[hit])
    return rows


@pytest.mark.parametrize("model", ["pna", "egnn"])
def test_pna_and_egnn_serve_raise_naming_their_slice(model):
    """PNA and EGNN serve (cache-off) through the port's batcher: the same
    counts as the reference's engine on the same queries, one trace, and
    the same logits — within 1e-5 for EGNN; PNA's std aggregator is
    ill-conditioned in fp32 on blocks whose sampled messages repeat (a
    segment of equal messages has variance 0 ± rounding, and its std's
    derivative is 1/(2·1e-4)), so there the port's logits (the worst over
    all queries) hold to the reference's serve forward rerun in float64
    within 4× the reference's own fp32 error (or 1e-5). Both refuse the hot-neighbor cache, and an
    unknown model stays a ValueError."""
    g, ref, port = _gnn_engines(model, batch_seeds=3, fanout=3, seed=0)
    calls = _recording(ref)
    waves = ((4, 9, 40, 80), hot_query_stream(g, 30))
    _serve(ref, waves)
    _serve(port, waves)
    _assert_same_counts(ref, port)
    if model == "egnn":
        _assert_same_logits(ref, port)
    else:
        assert [(q.qid, q.micro_batch) for q in ref.finished] == [(q.qid, q.micro_batch) for q in port.finished]
        rows64 = np.stack(_float64_rows(ref, calls))
        intrinsic = float(np.abs(np.stack([q.logits for q in ref.finished]) - rows64).max())
        err = float(np.abs(np.stack([q.logits for q in port.finished]) - rows64).max())
        assert err <= max(4 * intrinsic, TOL * np.abs(rows64).max()), (err, intrinsic)
    assert port.traces == 1 and all(np.isfinite(q.logits).all() for q in port.finished)
    with pytest.raises(ValueError, match="only the GCN serve forward"):
        _gnn_engines(model, cache_capacity=8)
    gd, dims, params = _setup()
    with pytest.raises(ValueError, match="unknown serve model"):
        GraphBatcher(params, gd, GCNConfig(layer_dims=dims), model="gat", device="cpu")
    if model == "egnn":
        with pytest.raises(ValueError, match="needs graph.positions"):
            GraphBatcher(port.params, gd, port.cfg, model="egnn", device="cpu")


def test_quant_forced_off_and_device_none_raises_without_cuda(monkeypatch):
    from repro_torch.core.quant import QuantConfig

    g, dims, params = _setup()
    eng = GraphBatcher(params, g, GCNConfig(layer_dims=dims, quant=QuantConfig(4, 4, enabled=True)), device="cpu")
    assert not eng.cfg.quant.enabled
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphBatcher(params, g, GCNConfig(layer_dims=dims))


# ------------------------------------------------------- mutating the graph
def _fresh_oracle(eng):
    return GraphBatcher(eng.params, eng.graph, eng.cfg, batch_seeds=eng.batch_seeds, fanout=eng.sampler.fanout,
                        cache_capacity=0, seed=eng._seed, device="cpu")


def _serve_wave(eng, nodes):
    start = len(eng.finished)
    for v in nodes:
        eng.submit(int(v))
    eng.run_until_drained()
    done = eng.finished[start:]
    base = min(q.qid for q in done)
    return {q.qid - base: q.logits for q in done}


@pytest.mark.parametrize("seed", range(41))
def test_interleaved_mutations_match_no_cache_oracle(seed, delta_seed):
    """The reference property's body, over every seed it draws from:
    under an interleaving of serve waves, `GraphDelta`s and scoped feature
    updates the cached port engine matches a fresh cache-less port engine
    on the current graph, and the reference engine fed the same
    operations, count for count."""
    rng = np.random.default_rng((seed << 10) ^ delta_seed)
    g, dims, params = _setup(seed=seed % 5, n=40, e=160, f=8, hidden=6)
    ref, eng = _engines(g, dims, params, batch_seeds=4, fanout=2, cache_capacity=16, seed=0)
    f_dim = g.features.shape[1]
    for _ in range(8):
        op = rng.random()
        if op < 0.30:
            d = random_delta(rng, g.n_nodes, eng.graph.edge_index, max_ops=6, feat_dim=f_dim)
            rep = eng.apply_graph_delta(_port_delta(d))
            assert rep == ref.apply_graph_delta(d)
            assert rep["residents_dropped"] <= rep["residents_before"]
            assert np.array_equal(eng.graph.edge_index, ref.graph.edge_index)
        elif op < 0.45:
            touched = np.unique(rng.integers(0, g.n_nodes, 3))
            feats = np.array(eng.features)
            feats[touched] += rng.standard_normal((touched.size, f_dim)).astype(np.float32)
            eng.update_features(feats, touched=touched)
            ref.update_features(feats, touched=touched)
        wave = rng.integers(0, 16, 4)
        got = _serve_wave(eng, wave)
        want = _serve_wave(_fresh_oracle(eng), wave)
        got_ref = _serve_wave(ref, wave)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got[k], got_ref[k], rtol=TOL, atol=TOL)
        assert eng.cache.stats() == ref.cache.stats()
    assert (eng.nodes_sampled, eng.edges_sampled) == (ref.nodes_sampled, ref.edges_sampled)


def test_interleaved_mutations_exercise_the_cache():
    """Across the seeds of the loop above the cache is hit and residents
    are dropped — the loop tests the scoped invalidation, not an idle
    cache."""
    hits = dropped = 0
    for seed in range(0, 41, 8):
        rng = np.random.default_rng(seed << 10)
        g, dims, params = _setup(seed=seed % 5, n=40, e=160, f=8, hidden=6)
        _, eng = _engines(g, dims, params, batch_seeds=4, fanout=2, cache_capacity=16, seed=0)
        for _ in range(8):
            if rng.random() < 0.5:
                eng.apply_graph_delta(_port_delta(random_delta(rng, g.n_nodes, eng.graph.edge_index, max_ops=6)))
            _serve_wave(eng, rng.integers(0, 16, 4))
        hits += eng.cache.hits
        dropped += eng.cache.nodes_dropped
    assert hits > 0 and dropped > 0


def test_scoped_invalidation_drops_strictly_fewer_than_all():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 40)
    ref, eng = (_serve(e, (nodes, nodes)) for e in _engines(g, dims, params, batch_seeds=4, fanout=4,
                                                              cache_capacity=64, seed=0))
    resident = len(eng.cache)
    assert resident > 8
    deg = eng.sampler.in_deg
    ei = eng.graph.edge_index
    quiet = int(np.argmin(deg[ei[0]] + deg[ei[1]]))
    d = RefDelta(edge_deletes=ei[:, [quiet]])
    rep = eng.apply_graph_delta(_port_delta(d))
    assert rep == ref.apply_graph_delta(d)
    assert rep["residents_before"] == resident
    assert rep["residents_dropped"] < resident
    assert len(eng.cache) == resident - rep["residents_dropped"]
    assert eng.cache.scoped_invalidations == 1 and eng.cache.invalidations == 0
    got = _serve_wave(eng, nodes)
    want = _serve_wave(_fresh_oracle(eng), nodes)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)


def test_adopt_partition_checks_node_count():
    g, dims, params = _setup()
    _, eng = _engines(g, dims, params, batch_seeds=4, fanout=3, seed=0)
    small = partition_graph(10, np.zeros((2, 0), np.int64), 2)
    with pytest.raises(ValueError, match="partition covers"):
        eng.adopt_partition(small)
    part = partition_graph(g.n_nodes, g.edge_index, 2)
    eng.adopt_partition(part)
    assert eng.partition is part
    eng.adopt_partition(None)
    assert eng.partition is None


def test_stats_keys_match_reference():
    g, dims, params = _setup()
    nodes = hot_query_stream(g, 12)
    ref, eng = (_serve(e, (nodes,)) for e in _engines(g, dims, params, batch_seeds=4, fanout=3,
                                                        cache_capacity=8, seed=0))
    assert set(eng.stats()) == set(ref.stats())
    assert set(eng.stats()["cache"]) == set(ref.stats()["cache"])
    assert [f.name for f in dataclasses.fields(port_serve.GraphQuery)] == \
        [f.name for f in dataclasses.fields(ref_serve.GraphQuery)]
    assert [f.name for f in dataclasses.fields(port_serve.ServeBlock)] == \
        [f.name for f in dataclasses.fields(ref_serve.ServeBlock)]
