"""EquiformerV2 of the port against the JAX package's.

The same inputs, made from a seed with numpy, and the reference's own
parameters (`equiformer_init`, carried across by ``params_from_numpy``) go
through both packages:

* `segment_softmax` and its gradient (`jax.vjp` against autograd) within
  1e-6 of max, over empty segments, −1e30 (padding) logits, a segment whose
  every logit is −1e30, and ties;
* the forward within 1e-5 of max |reference|, the loss within 1e-5
  relative, and every gradient leaf within 1e-4 of that leaf's max
  |reference| (the logits' last bias, whose gradient the softmax cancels,
  within 1e-6 of the largest leaf in both), with and without an edge mask,
  at the reference test's config (tests/test_models.py:150) and at l_max 6
  with narrow channels, on graphs with self-loops (zero-length edges); the
  REDUCED config through the training CLI;
* SE(3) invariance within 2e-4 and the chunked messages equal to the
  unchunked ones within 1e-5 (tests/test_models.py:145-163; gradients
  within 1e-4 per leaf), with a last chunk shorter than the rest;
* the configs, the registry and the parameter plan's leaf shapes;
* ``launch.train --arch equiformer-v2`` against the reference's
  ``_gnn_setup`` + ``Trainer``, and ``launch.serve``'s refusal;
* a rank-3 (n, K, C) table through the halo exchange on a 4-rank gloo
  group: every wire and lowering keeps the trailing shape, the backward's
  gradient has the table's shape, and ``halo.wire_bytes`` counts whole
  rows (K·C elements each), flat and hierarchical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as ref_cfg_mod
from repro.configs.registry import get_arch as ref_get_arch
from repro.graph.ops import segment_softmax as ref_segment_softmax
from repro.models import equiformer_v2 as ref_eq
from repro_torch.configs import equiformer_v2 as cfg_mod
from repro_torch.configs.registry import get_arch
from repro_torch.graph.ops import segment_softmax
from repro_torch.models import equiformer_v2 as eq

FWD_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)
CONFIGS = {
    "reference_test": ref_eq.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4, d_in=8,
                                                d_out=2),
    "l6_narrow": ref_eq.EquiformerV2Config(n_layers=2, d_hidden=8, l_max=6, m_max=2, n_heads=4, d_in=8, d_out=2),
}


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's `equiformer_init` of CONFIGS[name] as numpy, drawn
    once (eager JAX compiles each leaf's draw)."""
    return jax.tree.map(np.asarray, ref_eq.equiformer_init(KEY, CONFIGS[name]))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_cfg(cfg):
    return eq.EquiformerV2Config(**dataclasses.asdict(cfg))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree) for k2, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _hold(ours, theirs, tol):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    err, scale = float(np.abs(ours - theirs).max()), float(np.abs(theirs).max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _hold_grads(ours: dict, theirs: dict, tol: float):
    """Every leaf within ``tol`` of its own max |theirs|; a leaf of zeros
    equal. The logits' last bias adds one constant to every logit of a head,
    which the softmax cancels: its gradient is 0 but for rounding, so in both
    it stays within 1e-6 of the largest leaf's max."""
    assert ours.keys() == theirs.keys()
    top = max(float(np.abs(g).max()) for g in theirs.values())
    for k, g in theirs.items():
        if k.endswith("/attn/l1/b"):
            assert max(float(np.abs(g).max()), float(np.abs(ours[k]).max())) <= 1e-6 * top, k
        elif np.abs(g).max() > 0:
            _hold(ours[k], g, tol)
        else:
            np.testing.assert_array_equal(ours[k], g)


def _graph(n, e, seed, mask_frac=0.0):
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e).astype(np.int32)
    d = r.integers(0, n, e).astype(np.int32)
    d[d == 1] = 2                                    # node 1: no in-edges
    s[:4] = d[:4]                                    # self-loops: zero-length edges
    mask = None
    if mask_frac:
        mask = (r.random(e) >= mask_frac).astype(np.float32)
        mask[d == 4] = 0.0                           # node 4: every in-edge masked
    return s, d, mask


# ------------------------------------------------------------ segment_softmax
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["fp32", "fp64"])
def test_segment_softmax_and_gradient_match_jax(dtype):
    r = np.random.default_rng(0)
    n, e, heads = 12, 60, 3
    recv = r.integers(0, n - 3, e).astype(np.int32)          # the last three segments are empty
    logits = r.standard_normal((e, heads)).astype(dtype)
    logits[recv == 2] = -1e30                                # every logit of segment 2 is padding
    logits[(recv == 3) & (np.arange(e) % 2 == 0), 0] = -1e30   # some of segment 3's
    tie = np.flatnonzero(recv == 5)
    logits[tie, :] = 0.75                                    # segment 5: one value, ties throughout
    ct = r.standard_normal((e, heads)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want, vjp = jax.vjp(lambda x: ref_segment_softmax(x, jnp.asarray(recv), n), jnp.asarray(logits))
        want_g = np.asarray(vjp(jnp.asarray(ct))[0])
        want = np.asarray(want)
    x = _t(logits).requires_grad_(True)
    got = segment_softmax(x, _t(recv), n)
    (got_g,) = torch.autograd.grad(got, x, _t(ct))
    assert got.dtype == x.dtype and np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=1e-6 * np.abs(want_g).max(), rtol=0)
    np.testing.assert_allclose(got.detach().numpy()[recv == 2], 1.0 / (recv == 2).sum(), rtol=1e-6)
    np.testing.assert_allclose(got.detach().numpy()[tie], 1.0 / tie.size, rtol=1e-6)


# ------------------------------------------------------ forward and gradients
def _run(name, mask_frac, seed=0, n=30, e=120):
    cfg = CONFIGS[name]
    r = np.random.default_rng(seed)
    s, d, mask = _graph(n, e, seed, mask_frac)
    feats = r.standard_normal((n, cfg.d_in)).astype(np.float32)
    pos = r.standard_normal((n, 3)).astype(np.float32)
    target = (0.1 * r.standard_normal((n, cfg.d_out))).astype(np.float32)
    jp = _ref_params(name)

    def jloss(p):
        out = ref_eq.equiformer_forward(p, jnp.asarray(feats), jnp.asarray(pos), jnp.asarray(s), jnp.asarray(d), cfg,
                                        edge_mask=None if mask is None else jnp.asarray(mask))
        return jnp.mean(jnp.square(out - jnp.asarray(target))), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, jp))
    tp = eq.params_from_numpy(jp, device="cpu")
    leaves = _leaves(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    tout = eq.equiformer_forward(tp, _t(feats), _t(pos), _t(s), _t(d), _port_cfg(cfg),
                                 edge_mask=None if mask is None else _t(mask))
    tl = (tout - _t(target)).square().mean()
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    return (np.asarray(jout), float(jl), _leaves(jax.tree.map(np.asarray, jg))), \
        (tout.detach().numpy(), float(tl.detach()), {k: g.numpy() for k, g in grads.items()}), \
        (tp, _t(feats), _t(pos), _t(s), _t(d), _t(target))


@pytest.mark.parametrize("mask_frac", [0.0, 0.25])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_gradients_match_jax(name, mask_frac):
    (jout, jl, jg), (tout, tl, tg), args = _run(name, mask_frac)
    _hold(tout, jout, FWD_TOL)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    if mask_frac == 0.0:                                     # `equiformer_loss`: the reference's mean square
        params, *inputs = args
        assert abs(float(eq.equiformer_loss(params, *inputs, _port_cfg(CONFIGS[name]))) - jl) <= LOSS_TOL * abs(jl)
    _hold_grads(tg, jg, GRAD_TOL)


def _rotation(r):
    q = np.linalg.qr(r.standard_normal((3, 3)))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("name", ["reference_test", "l6_narrow"])
def test_se3_invariance_and_chunking(name):
    """tests/test_models.py::test_equiformer_so3_invariance_and_chunking on
    the port: a rotated and translated input gives the same output (2e-4);
    edge_chunk 64 over 150 edges (a short last chunk) and a chunk wider than
    the graph give the unchunked output (1e-5) and gradient."""
    cfg = _port_cfg(CONFIGS[name])
    p = eq.params_from_numpy(_ref_params(name), "cpu")
    r = np.random.default_rng(0)
    n, e = 40, 150
    s, d = _t(r.integers(0, n, e)), _t(r.integers(0, n, e))
    h = _t(r.standard_normal((n, cfg.d_in)).astype(np.float32))
    pos = _t(r.standard_normal((n, 3)).astype(np.float32))
    R, t = _t(_rotation(r)), torch.tensor([1.0, 2.0, 3.0])
    o1 = eq.equiformer_forward(p, h, pos, s, d, cfg)
    o2 = eq.equiformer_forward(p, h, pos @ R.T + t, s, d, cfg)
    np.testing.assert_allclose(o1.detach().numpy(), o2.detach().numpy(), atol=2e-4)
    leaves = _leaves(p)
    for v in leaves.values():
        v.requires_grad_(True)

    def grads(c):
        out = torch.autograd.grad(eq.equiformer_forward(p, h, pos, s, d, c).square().sum(), list(leaves.values()))
        return {k: g.numpy() for k, g in zip(leaves, out)}

    base = grads(cfg)
    for chunk in (64, 1000):
        cc = dataclasses.replace(cfg, edge_chunk=chunk)
        o3 = eq.equiformer_forward(p, h, pos, s, d, cc)
        np.testing.assert_allclose(o1.detach().numpy(), o3.detach().numpy(), atol=1e-5)
        _hold_grads(grads(cc), base, GRAD_TOL)
    if name == "reference_test":                             # the reference's padded chunks: the same sums
        ref = ref_eq.equiformer_forward(jax.tree.map(jnp.asarray, _ref_params(name)), jnp.asarray(h.numpy()),
                                        jnp.asarray(pos.numpy()), jnp.asarray(s.numpy()), jnp.asarray(d.numpy()),
                                        dataclasses.replace(CONFIGS[name], edge_chunk=64))
        _hold(eq.equiformer_forward(p, h, pos, s, d, dataclasses.replace(cfg, edge_chunk=64)).detach().numpy(),
              np.asarray(ref), FWD_TOL)


def test_self_loop_carries_no_directional_message():
    """A graph of self-loops only: every edge is zero-length (u = 0, R = I)
    and masked by ``edge_ok``, so the messages vanish and the output is that
    of a graph with no edges (the FFN path's alone)."""
    cfg = _port_cfg(CONFIGS["reference_test"])
    r = np.random.default_rng(5)
    n = 10
    loops = _t(np.arange(n, dtype=np.int32))
    feats = _t(r.standard_normal((n, cfg.d_in)).astype(np.float32))
    pos = _t(r.standard_normal((n, 3)).astype(np.float32))
    tp = eq.params_from_numpy(_ref_params("reference_test"), "cpu")
    got = eq.equiformer_forward(tp, feats, pos, loops, loops, cfg)
    none = eq.equiformer_forward(tp, feats, pos, loops[:0], loops[:0], cfg)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.detach().numpy(), none.detach().numpy())


# ------------------------------------------------------------ configs and plan
def test_configs_equal_the_reference():
    spec, ref = get_arch("equiformer-v2"), ref_get_arch("equiformer-v2")
    assert (spec.arch_id, spec.family, spec.source) == (ref.arch_id, ref.family, ref.source)
    assert [f.name for f in dataclasses.fields(eq.EquiformerV2Config)] == \
        [f.name for f in dataclasses.fields(ref_eq.EquiformerV2Config)]
    assert dataclasses.asdict(eq.EquiformerV2Config()) == dataclasses.asdict(ref_eq.EquiformerV2Config())
    assert dataclasses.asdict(spec.make_reduced()) == dataclasses.asdict(ref.make_reduced())
    full = cfg_mod.make_config(None)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_cfg_mod.make_config(None))
    assert (full.n_layers, full.d_hidden, full.l_max, full.m_max, full.n_heads) == (12, 128, 6, 2, 8)
    assert full.k_comps == 49 and [full.m_l_count(m) for m in range(3)] == [7, 6, 5]
    assert set(spec.shapes) == set(ref.shapes)
    for name, shape in ref.shapes.items():
        assert dataclasses.asdict(cfg_mod.make_config(spec.shapes[name])) == \
            dataclasses.asdict(ref_cfg_mod.make_config(shape))


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_param_plan_leaf_shapes_equal_the_reference(which):
    ref_cfg = ref_cfg_mod.SPEC.make_reduced() if which == "reduced" else ref_cfg_mod.make_config(None)
    cfg = _port_cfg(ref_cfg)
    plan = eq.equiformer_param_plan(cfg)
    assert isinstance(plan["layers"], list) and len(plan["layers"]) == cfg.n_layers
    theirs = _leaves(jax.eval_shape(lambda k: ref_eq.equiformer_init(k, ref_cfg), KEY))
    assert {k: tuple(v.shape) for k, v in _leaves(plan).items()} == {k: tuple(v.shape) for k, v in theirs.items()}
    if which == "reduced":
        ours = _leaves(eq.equiformer_init(torch.Generator().manual_seed(0), cfg, device="cpu"))
        ref = _leaves(ref_eq.equiformer_init(KEY, ref_cfg))
        for k in ref:
            assert tuple(ours[k].shape) == ref[k].shape
            if k.endswith("/b") or "norm_g" in k:
                np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))      # zeros and ones alike


# --------------------------------------------------------------- the launchers
def test_launch_train_matches_the_reference_setup(monkeypatch, capsys):
    """``launch.train --arch equiformer-v2 --device cpu --steps 3`` on the
    reference's initial parameters: the losses of the reference's
    ``_gnn_setup`` + ``Trainer`` within 1e-4 relative."""
    from repro.launch import train as ref_train
    from repro.train.loop import Trainer as RefTrainer
    from repro.train.loop import TrainerConfig as RefTrainerConfig
    from repro.train.optimizer import adamw as ref_adamw
    from repro_torch.launch import train
    from repro_torch.train import loop

    spec = ref_get_arch("equiformer-v2")
    params, loss_fn, batches = ref_train._gnn_setup(spec)
    ref = RefTrainer(loss_fn, ref_adamw(1e-3), params, RefTrainerConfig(log_every=10)).fit(batches(), max_steps=3)
    init = ref_train._init_gnn("equiformer-v2", spec.make_reduced())
    monkeypatch.setattr(train, "_init_gnn", lambda arch_id, cfg, device: eq.params_from_numpy(init, device))
    seen = []
    fit = loop.Trainer.fit

    def recording_fit(self, *a, **kw):
        seen.append(fit(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(loop.Trainer, "fit", recording_fit)
    train.main(["--arch", "equiformer-v2", "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("equiformer-v2: loss ") and "over 3 steps" in out
    np.testing.assert_allclose(seen[0], ref, rtol=1e-4)


def test_launch_serve_refuses_with_the_reference_message():
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as ours:
        serve.main(["--arch", "equiformer-v2", "--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        ref_serve.main(["--arch", "equiformer-v2"])
    assert str(ours.value) == str(theirs.value) == "equiformer-v2: graph serving supports coin_gcn/pna/egnn"


# ------------------------------------------------- rank-3 tables on the halo path
K_RANKS, N_LOCAL, KC = 4, 9, (4, 3)


@pytest.fixture(scope="module")
def rank3_group():
    from _torch_halo_ranks import rank3_exchange
    from repro_torch.launch.mesh import GroupSpec, run_group

    r = np.random.default_rng(11)
    tables = r.standard_normal((K_RANKS, N_LOCAL) + KC).astype(np.float32)
    send_idx = r.integers(0, N_LOCAL, (K_RANKS, 5)).astype(np.int64)
    send_loc = r.integers(0, N_LOCAL, (K_RANKS, 3)).astype(np.int64)
    send_rem = r.integers(0, N_LOCAL, (K_RANKS, 2)).astype(np.int64)
    job = dict(tables=tables, send_idx=send_idx, send_loc=send_loc, send_rem=send_rem, pods=2)
    spec = GroupSpec(k=K_RANKS, backend="gloo", devices=("cpu",), timeout_s=300)
    return job, run_group(spec, rank3_exchange, [job] * K_RANKS)


@pytest.mark.parametrize("payload", [None, "bf16", "int8"], ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("via", ["all_gather", "ppermute"])
def test_rank3_halo_exchange_keeps_rows_and_counts_whole_rows(rank3_group, payload, via):
    job, results = rank3_group
    exact = np.concatenate([job["tables"][j][job["send_idx"][j]] for j in range(K_RANKS)])
    row_elems = KC[0] * KC[1]
    bits = {None: 32, "bf16": 16, "int8": 8}[payload]
    for rank, res in enumerate(results):
        got = res[(payload, via)]
        assert got["halo"].shape == exact.shape                     # (k·s, K, C): the trailing shape kept
        if payload is None:
            np.testing.assert_array_equal(got["halo"], exact)
        elif payload == "bf16":                                     # round to nearest: half a bf16 step
            assert (np.abs(got["halo"] - exact) <= np.abs(exact) * 2.0 ** -8).all()
        else:                                                       # half of each sender's amax / 127
            step = np.repeat([np.abs(job["tables"][j][job["send_idx"][j]]).max() / 127 for j in range(K_RANKS)], 5)
            assert (np.abs(got["halo"] - exact) <= 0.5001 * step[:, None, None]).all()
        assert got["wire_rows"] == exact.shape[0]
        assert got["wire_bytes"] == exact.shape[0] * row_elems * bits / 8     # whole rows, not rows × K
        if payload != "int8":                                       # an int8 wire has no gradient (a round)
            want = np.zeros((N_LOCAL,) + KC, np.float32)
            np.add.at(want, job["send_idx"][rank], float(K_RANKS))
            np.testing.assert_array_equal(got["grad"], want)
            assert got["backward_wire_bytes"] == exact.shape[0] * row_elems * bits / 8


def test_rank3_hier_halo_exchange_counts_whole_rows(rank3_group):
    job, results = rank3_group
    pods, km = job["pods"], K_RANKS // job["pods"]
    s_loc, s_rem = job["send_loc"].shape[1], job["send_rem"].shape[1]
    inter, intra = pods * s_rem, km * (s_loc + pods * s_rem)
    for res in results:
        got = res["hier"]
        assert got["shape"] == (intra,) + KC
        assert got["wire_bytes"] == (inter + intra) * KC[0] * KC[1] * 4
        assert got["inter_pod_rows"] == inter
