"""The port's segment reductions and generators against the JAX package's.

Inputs are made from a seed with numpy and go through `repro.graph.ops`
and `repro_torch.graph.ops` alike; values and gradients hold within 1e-6
(of the larger of 1 and max |reference|), generators array-equal. The
gradient cases include the trap of a zero-started ``scatter_reduce``: a
segment whose maximum is 0, shared by several entries, gets 1/n of the
cotangent in JAX — not 1/(n+1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as ref_gen
from repro.graph import ops as ref_ops
from repro_torch.graph import generators as gen
from repro_torch.graph import ops

TOL = 1e-6


def _close(ours, theirs, tol=TOL):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    fin = np.isfinite(theirs)
    assert np.array_equal(fin, np.isfinite(ours)), "non-finite entries differ"
    assert np.array_equal(ours[~fin], theirs[~fin])
    if fin.any():
        scale = max(1.0, float(np.abs(theirs[fin]).max()))
        assert float(np.abs(ours[fin] - theirs[fin]).max()) <= tol * scale


def _graph(n=40, e=160, d=6, seed=0, empty=(3, 17)):
    """Edges whose receivers avoid the ``empty`` nodes, features with
    repeated values (ties) and zeros."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e).astype(np.int32)
    recv = r.integers(0, n, e)
    for v in empty:
        recv[recv == v] = (v + 1) % n
    x = r.standard_normal((n, d)).astype(np.float32)
    x[::5] = np.round(x[::5])            # integer rows: ties under max/min
    x[1::7] = 0.0
    w = (np.abs(r.standard_normal(e)) + 0.1).astype(np.float32)
    return s, recv.astype(np.int32), x, w


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_every_reduction(reduce, weighted):
    s, r, x, w = _graph()
    n = x.shape[0]
    ew = w if weighted else None
    theirs = ref_ops.aggregate(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), n,
                               None if ew is None else jnp.asarray(ew), reduce)
    ours = ops.aggregate(_t(x), _t(s), _t(r), n, None if ew is None else _t(ew), reduce)
    _close(ours.numpy(), theirs)
    if reduce in ("max", "min"):
        assert np.isinf(ours[3].numpy()).all()          # an empty segment stays ∓inf


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_aggregate_padded_every_reduction(reduce):
    s, r, x, w = _graph()
    n = x.shape[0]
    s[-10:], r[-10:], w[-10:] = n, n, 0.0              # ghost-padded edges
    theirs = ref_ops.aggregate_padded(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), n,
                                      jnp.asarray(w), reduce)
    ours = ops.aggregate_padded(_t(x), _t(s), _t(r), n, _t(w), reduce)
    _close(ours.numpy(), theirs)


def test_aggregate_unknown_reduce_raises():
    s, r, x, _ = _graph()
    with pytest.raises(ValueError, match="unknown reduce"):
        ops.aggregate(_t(x), _t(s), _t(r), x.shape[0], reduce="median")


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_aggregate(weighted):
    s, r, x, w = _graph(seed=1)
    n = x.shape[0]
    ew = w if weighted else None
    theirs = ref_ops.multi_aggregate(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), n,
                                     None if ew is None else jnp.asarray(ew))
    ours = ops.multi_aggregate(_t(x), _t(s), _t(r), n, None if ew is None else _t(ew))
    assert set(ours) == set(theirs) == {"mean", "max", "min", "std"}
    for k in theirs:
        _close(ours[k].numpy(), theirs[k])
    assert float(ours["max"][3].abs().max()) == 0.0    # empty segments zeroed


def _edges_case(seed: int, masked: str):
    """Messages with ReLU zeros and ties; a mask (``none``, ``some``, or
    ``all`` of node 5's edges masked besides random ones)."""
    r = np.random.default_rng(seed)
    n, e, d = 30, 150, 5
    recv = r.integers(0, n, e)
    recv[recv == 9] = 10                                 # node 9: no edges at all
    msgs = np.maximum(r.standard_normal((e, d)), 0.0).astype(np.float32)
    msgs[::6] = np.round(msgs[::6])
    mask = None
    if masked != "none":
        mask = (r.random(e) > 0.3).astype(np.float32)
        if masked == "all":
            mask[recv == 5] = 0.0                        # node 5: every edge masked
    return msgs, recv.astype(np.int32), n, mask


@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_multi_aggregate_edges_values(masked):
    msgs, recv, n, mask = _edges_case(2, masked)
    theirs = ref_ops.multi_aggregate_edges(jnp.asarray(msgs), jnp.asarray(recv), n,
                                           None if mask is None else jnp.asarray(mask))
    ours = ops.multi_aggregate_edges(_t(msgs), _t(recv), n, None if mask is None else _t(mask))
    for k in theirs:
        _close(ours[k].numpy(), theirs[k])
    for k in ("max", "min"):
        assert float(ours[k][9].abs().max()) == 0.0
        if masked == "all":
            assert float(ours[k][5].abs().max()) == 0.0


def _grad_pair(jfn, tfn, inputs, ct):
    """∂⟨ct, f(inputs)⟩ of both packages, the cotangent a dict like f's
    output (or one array)."""
    def jloss(*a):
        out = jfn(*a)
        if isinstance(out, dict):
            return sum(jnp.sum(out[k] * jnp.asarray(ct[k])) for k in ct)
        return jnp.sum(out * jnp.asarray(ct))

    jg = jax.grad(jloss)(*(jnp.asarray(a) for a in inputs))
    ts = [_t(a).clone().requires_grad_(True) for a in inputs]
    out = tfn(*ts)
    loss = (sum((out[k] * _t(ct[k])).sum() for k in ct) if isinstance(out, dict)
            else (out * _t(ct)).sum())
    (tg,) = torch.autograd.grad(loss, ts)
    return tg.numpy(), np.asarray(jg)


STATS = ("mean", "max", "min", "std")


# One statistic's cotangent at a time: a one-edge segment's variance is
# exactly 0, where the std's gradient (1/(2·1e-4) on the tie) reaches the
# messages through E[x²] and E[x]² as two large terms that cancel; summed
# with the other statistics' gradients, their rounding then depends on the
# order each package accumulates in (~1e-3 at |grad| ~ 1).
@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_multi_aggregate_edges_gradient(masked, stat):
    msgs, recv, n, mask = _edges_case(3, masked)
    ct = {stat: np.random.default_rng(STATS.index(stat)).standard_normal((n, msgs.shape[1])).astype(np.float32)}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    ours, theirs = _grad_pair(lambda m: ref_ops.multi_aggregate_edges(m, jnp.asarray(recv), n, jm),
                              lambda m: ops.multi_aggregate_edges(m, _t(recv), n, tm), (msgs,), ct)
    _close(ours, theirs)


def test_max_gradient_on_an_all_zero_tie():
    """n entries of one segment tie at 0 (ReLU'd messages): each gets 1/n of
    the cotangent, as JAX's segment_max gives, both bare and through the
    PNA aggregators."""
    n_tied = 4
    msgs = np.zeros((n_tied + 2, 3), np.float32)
    msgs[n_tied:] = [[1.0, -2.0, 0.5], [3.0, 1.0, -1.0]]
    recv = np.array([0] * n_tied + [1, 1], np.int32)
    ct = np.ones((2, 3), np.float32)
    ours, theirs = _grad_pair(lambda m: jax.ops.segment_max(m, jnp.asarray(recv), num_segments=2),
                              lambda m: ops.segment_max(m, _t(recv), 2), (msgs,), ct)
    _close(ours, theirs)
    np.testing.assert_array_equal(ours[:n_tied], np.full((n_tied, 3), 1.0 / n_tied, np.float32))
    ours, theirs = _grad_pair(lambda m: jax.ops.segment_min(m, jnp.asarray(recv), num_segments=2),
                              lambda m: ops.segment_min(m, _t(recv), 2), (msgs,), ct)
    _close(ours, theirs)
    cts = {"max": np.ones((2, 3), np.float32)}
    ours, theirs = _grad_pair(lambda m: ref_ops.multi_aggregate_edges(m, jnp.asarray(recv), 2),
                              lambda m: ops.multi_aggregate_edges(m, _t(recv), 2), (msgs,), cts)
    _close(ours, theirs)
    assert ours[0, 0] == np.float32(1.0 / n_tied)


def test_std_gradient_on_a_one_edge_segment():
    """A one-edge segment's variance is exactly 0: JAX's maximum passes half
    the cotangent through the tie, and so must the port."""
    msgs = np.array([[0.7, -1.5], [2.0, 0.25], [-0.5, 1.0]], np.float32)
    recv = np.array([0, 1, 1], np.int32)
    ct = {"std": np.ones((2, 2), np.float32)}
    ours, theirs = _grad_pair(lambda m: ref_ops.multi_aggregate_edges(m, jnp.asarray(recv), 2),
                              lambda m: ops.multi_aggregate_edges(m, _t(recv), 2), (msgs,), ct)
    _close(ours, theirs)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_aggregate_gradient(reduce):
    s, r, x, w = _graph(seed=4)
    n = x.shape[0]
    ct = np.random.default_rng(5).standard_normal((n, x.shape[1])).astype(np.float32)
    ours, theirs = _grad_pair(
        lambda f: jnp.nan_to_num(ref_ops.aggregate(f, jnp.asarray(s), jnp.asarray(r), n, jnp.asarray(w), reduce),
                                 posinf=0.0, neginf=0.0),
        lambda f: torch.nan_to_num(ops.aggregate(f, _t(s), _t(r), n, _t(w), reduce), posinf=0.0, neginf=0.0),
        (x,), ct)
    _close(ours, theirs)


@pytest.mark.parametrize("stat", STATS)
def test_multi_aggregate_gradient(stat):
    s, r, x, w = _graph(seed=6)
    n = x.shape[0]
    ct = {stat: np.random.default_rng(STATS.index(stat)).standard_normal((n, x.shape[1])).astype(np.float32)}
    ours, theirs = _grad_pair(
        lambda f: ref_ops.multi_aggregate(f, jnp.asarray(s), jnp.asarray(r), n, jnp.asarray(w)),
        lambda f: ops.multi_aggregate(f, _t(s), _t(r), n, _t(w)), (x,), ct)
    _close(ours, theirs)


@pytest.mark.parametrize("n,e,seed", [(50, 300, 0), (1000, 7, 3), (40_962, 245_760, 1)])
def test_random_graph_array_equal(n, e, seed):
    ours, theirs = gen.random_graph(n, e, seed=seed), ref_gen.random_graph(n, e, seed=seed)
    assert ours.n_nodes == theirs.n_nodes
    np.testing.assert_array_equal(ours.edge_index, theirs.edge_index)
    assert ours.edge_index.dtype == theirs.edge_index.dtype


@pytest.mark.parametrize("kw", [{}, dict(n_graphs=5, nodes_per_graph=7, edges_per_graph=20, d_feat=3, seed=9)])
def test_molecule_batch_array_equal(kw):
    ours, theirs = gen.molecule_batch(**kw), ref_gen.molecule_batch(**kw)
    assert ours.n_nodes == theirs.n_nodes
    for name in ("edge_index", "features", "positions", "labels"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not (ours.edge_index[0] == ours.edge_index[1]).any()


def test_gnn_shapes_match_the_reference():
    assert gen.GNN_SHAPES == ref_gen.GNN_SHAPES


@pytest.mark.parametrize("n", [1, 7, 65_536, 232_965, 2**33])
def test_stable_order_is_the_stable_argsort(n):
    """The samplers' CSR order (two 16-bit radix passes below 2³²) equals
    ``np.argsort(kind="stable")``, ties in edge order."""
    from repro_torch.graph.sampler import stable_order

    ids = np.random.default_rng(n % 1000).integers(0, n, 50_000)
    np.testing.assert_array_equal(stable_order(ids), np.argsort(ids, kind="stable"))
