"""PNA, EGNN and GraphCast of the port against the JAX package's.

The same inputs, made from a seed with numpy, and the reference's own
parameters (its ``*_init``, carried across by ``params_from_numpy``) go
through both packages. Forwards hold within 1e-5 of max |reference|,
losses within 1e-5 relative, and every gradient leaf (`jax.grad` against
autograd) within 1e-4 of that leaf's max |reference|, for the REDUCED
configs and at each config's full width on a small graph, with and
without an edge mask, in float32 and in float64 (JAX under
``jax.enable_x64``).

PNA's float32 gradient is ill-conditioned in the reference itself: a
one-edge segment's variance is exactly 0, where the std's gradient is
1/(2·1e-4) and reaches the messages as two large terms that cancel, so
JAX's own float32 gradient lies 5e-3 to 1e-2 (of a leaf's max) from its
float64 one on these graphs, and any other order of summation lands
elsewhere in that band. There the two packages' gradients are held to
each other in float64 only (float32: finite). Also: the configs and the
registry against the reference's, and EGNN's E(3) equivariance (the twin
of tests/test_models.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as ref_egnn_cfg
from repro.configs import graphcast as ref_gc_cfg
from repro.configs import pna as ref_pna_cfg
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import egnn as ref_egnn
from repro.models import graphcast as ref_gc
from repro.models import pna as ref_pna
from repro_torch.configs import egnn as egnn_cfg
from repro_torch.configs import graphcast as gc_cfg
from repro_torch.configs import pna as pna_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.models import egnn, graphcast, pna

FWD_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _hold(ours, theirs, tol):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    scale = float(np.abs(theirs).max())
    err = float(np.abs(ours - theirs).max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _hold_grads(ours: dict, theirs: dict):
    a, b = _leaves(ours), _leaves(theirs)
    assert a.keys() == b.keys()
    for k in b:
        _hold(a[k], b[k], GRAD_TOL) if np.abs(b[k]).max() > 0 else np.testing.assert_array_equal(a[k], b[k])


def _graph(n, e, seed, mask_frac=0.0):
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e).astype(np.int32)
    d = r.integers(0, n, e).astype(np.int32)
    d[d == 1] = 2                                    # node 1: no in-edges
    mask = None
    if mask_frac:
        mask = (r.random(e) >= mask_frac).astype(np.float32)
        mask[d == 4] = 0.0                           # node 4: every in-edge masked
    return s, d, mask


# Each model: (reference module, port module, reference init, inputs(cfg, n, e, rng) → named arrays,
# forward(mod, params, inputs, senders, receivers, cfg, mask), n_out(cfg)).
def _pna_inputs(cfg, n, e, r):
    return {"x": r.standard_normal((n, cfg.d_in)).astype(np.float32)}


def _egnn_inputs(cfg, n, e, r):
    return {"h": r.standard_normal((n, cfg.d_in)).astype(np.float32),
            "pos": r.standard_normal((n, 3)).astype(np.float32)}


def _gc_inputs(cfg, n, e, r):
    return {"x": r.standard_normal((n, cfg.input_dim)).astype(np.float32),
            "ef": r.standard_normal((e, cfg.d_edge_in)).astype(np.float32)}


def _pna_fwd(mod, p, a, s, d, cfg, m):
    return mod.pna_forward(p, a["x"], s, d, cfg, edge_mask=m)


def _egnn_fwd(mod, p, a, s, d, cfg, m):
    out, x = mod.egnn_forward(p, a["h"], a["pos"], s, d, cfg, edge_mask=m)
    return out, x


def _gc_fwd(mod, p, a, s, d, cfg, m):
    return mod.graphcast_forward(p, a["x"], a["ef"], s, d, cfg, edge_mask=m)


MODELS = {
    "pna": (ref_pna, pna, ref_pna.pna_init, _pna_inputs, _pna_fwd, lambda c: c.d_out),
    "egnn": (ref_egnn, egnn, ref_egnn.egnn_init, _egnn_inputs, _egnn_fwd, lambda c: c.d_out),
    "graphcast": (ref_gc, graphcast, ref_gc.graphcast_init, _gc_inputs, _gc_fwd, lambda c: c.n_vars),
}
CONFIGS = {
    # REDUCED, and full width (the configs' make_config without a shape).
    ("pna", "reduced"): (ref_pna_cfg.SPEC.make_reduced(), 60, 300),
    ("pna", "full"): (ref_pna_cfg.make_config(None), 50, 220),
    ("egnn", "reduced"): (ref_egnn_cfg.SPEC.make_reduced(), 60, 300),
    ("egnn", "full"): (ref_egnn_cfg.make_config(None), 50, 220),
    ("graphcast", "reduced"): (ref_gc_cfg.SPEC.make_reduced(), 60, 300),
    ("graphcast", "full"): (ref_gc_cfg.make_config(None), 24, 96),
}


def _run(model, size, mask_frac, seed=0, dtype=np.float32):
    ref_mod, mod, init, inputs, fwd, n_out = MODELS[model]
    cfg, n, e = CONFIGS[model, size]
    r = np.random.default_rng(seed)
    s, d, mask = _graph(n, e, seed, mask_frac)
    a = {k: v.astype(dtype) for k, v in inputs(cfg, n, e, r).items()}
    target = (0.1 * r.standard_normal((n, n_out(cfg)))).astype(dtype)
    jp = jax.tree.map(lambda v: np.asarray(v).astype(dtype), init(KEY, cfg))
    tp = mod.params_from_numpy(jp, device="cpu")

    def jloss(p):
        out = fwd(ref_mod, p, {k: jnp.asarray(v) for k, v in a.items()}, jnp.asarray(s), jnp.asarray(d), cfg,
                  None if mask is None else jnp.asarray(mask))
        pred = out[0] if isinstance(out, tuple) else out
        return jnp.mean(jnp.square(pred - jnp.asarray(target))), out

    with jax.enable_x64(dtype == np.float64):
        (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jp))
        jout, jl, jg = jax.tree.map(np.asarray, (jout, jl, jg))
    leaves = [v.requires_grad_(True) for v in _leaves_t(tp)]
    tout = fwd(mod, tp, {k: _t(v) for k, v in a.items()}, _t(s), _t(d), cfg,
               None if mask is None else _t(mask))
    pred = tout[0] if isinstance(tout, tuple) else tout
    tl = (pred - _t(target)).square().mean()
    # EGNN's last φ_x moves only the coordinates: JAX's gradient there is 0.
    grads = torch.autograd.grad(tl, leaves, allow_unused=True, materialize_grads=True)
    tg = _unflatten_like(tp, [g.numpy() for g in grads])
    tout = tuple(o.detach() for o in tout) if isinstance(tout, tuple) else tout.detach()
    return (jout, jl, jg), (tout, float(tl.detach()), tg)


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves_t(tree[k])]
    return [tree]


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("mask_frac", [0.0, 0.25])
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("model", ["pna", "egnn", "graphcast"])
def test_forward_loss_and_gradients_match_jax(model, size, mask_frac, dtype):
    (jout, jl, jg), (tout, tl, tg) = _run(model, size, mask_frac, dtype=dtype)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    for o, j in zip(touts, jouts, strict=True):
        assert o.numpy().dtype == j.dtype
        _hold(o.numpy(), j, FWD_TOL)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    if model == "pna" and dtype == np.float32:
        # Ill-conditioned in float32 in the reference itself (module
        # docstring): the fp64 case holds PNA's gradient semantics.
        assert all(np.isfinite(v).all() for v in _leaves(tg).values())
        return
    _hold_grads(tg, jg)


@pytest.mark.parametrize("model", ["pna", "egnn", "graphcast"])
def test_model_loss_functions_match_jax(model):
    """``pna_loss`` / ``egnn_loss`` / ``graphcast_loss`` (no mask) on the
    REDUCED config."""
    ref_mod, mod, init, inputs, _, n_out = MODELS[model]
    cfg, n, e = CONFIGS[model, "reduced"]
    r = np.random.default_rng(7)
    s, d, _ = _graph(n, e, 7)
    a = inputs(cfg, n, e, r)
    target = (0.1 * r.standard_normal((n, n_out(cfg)))).astype(np.float32)
    jp = init(KEY, cfg)
    args = list(a.values()) + [s, d, target]
    jl = getattr(ref_mod, f"{model}_loss")(jp, *(jnp.asarray(v) for v in args), cfg)
    tl = getattr(mod, f"{model}_loss")(mod.params_from_numpy(jp, device="cpu"), *(_t(v) for v in args), cfg)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))


def test_pna_attenuation_on_nodes_without_in_edges():
    """A node with no in-edges: att = δ / 1e-6, so its std·att feature is
    2.5e6 × 1e-4 = 250 — the reference's behaviour, kept."""
    cfg = ref_pna_cfg.SPEC.make_reduced()
    (jout, _, _), (tout, _, _) = _run("pna", "reduced", 0.0)
    _hold(tout.numpy(), jout, FWD_TOL)
    deg = torch.zeros(4).index_add_(0, torch.tensor([0, 0, 2]), torch.ones(3))
    logd = torch.log1p(deg)[:, None]
    att = cfg.mean_log_degree / logd.clamp_min(1e-6)
    assert float(att[1] * 1e-4) == pytest.approx(250.0, rel=1e-6)


@pytest.mark.parametrize("arch,mod,ref_mod", [("pna", pna_cfg, ref_pna_cfg), ("egnn", egnn_cfg, ref_egnn_cfg),
                                              ("graphcast", gc_cfg, ref_gc_cfg)])
def test_configs_equal_the_reference(arch, mod, ref_mod):
    spec, ref = get_arch(arch), ref_get_arch(arch)
    assert (spec.arch_id, spec.family, spec.source) == (ref.arch_id, ref.family, ref.source)
    assert dataclasses.asdict(spec.make_reduced()) == dataclasses.asdict(ref.make_reduced())
    assert dataclasses.asdict(mod.make_config(None)) == dataclasses.asdict(ref_mod.make_config(None))
    assert set(spec.shapes) == set(ref.shapes)
    for name, shape in ref.shapes.items():
        assert dataclasses.asdict(spec.shapes[name]) == {
            k: v for k, v in dataclasses.asdict(shape).items() if k in dataclasses.asdict(spec.shapes[name])}
        assert dataclasses.asdict(mod.make_config(spec.shapes[name])) == dataclasses.asdict(ref_mod.make_config(shape))


def test_graphcast_properties_and_icosphere():
    for cfg_kw in (dict(), dict(d_in=602), dict(n_vars=12, d_in=8)):
        ours, theirs = graphcast.GraphCastConfig(**cfg_kw), ref_gc.GraphCastConfig(**cfg_kw)
        assert (ours.input_dim, ours.residual_output) == (theirs.input_dim, theirs.residual_output)
    for r in range(7):
        assert graphcast.icosphere_sizes(r) == ref_gc.icosphere_sizes(r)
    assert graphcast.icosphere_sizes(6) == (40_962, 245_760)


def test_graphcast_relative_edge_feats_and_remat():
    """The positional edge features, and ``remat``: the same loss and
    gradients as the plain forward."""
    cfg = gc_cfg.SPEC.make_reduced()
    cfg = dataclasses.replace(cfg, n_layers=3)
    r = np.random.default_rng(3)
    n, e = 30, 120
    s, d, _ = _graph(n, e, 3)
    pos = _t(r.standard_normal((n, 3)).astype(np.float32))
    ef = graphcast.relative_edge_feats(pos, pos, _t(s), _t(d))
    rel = pos.numpy()[d] - pos.numpy()[s]
    np.testing.assert_allclose(ef.numpy(), np.concatenate([rel, np.linalg.norm(rel, axis=1, keepdims=True)], 1),
                               rtol=1e-6, atol=1e-6)
    x = _t(r.standard_normal((n, cfg.input_dim)).astype(np.float32))
    out = {}
    for remat in (False, True):
        p = graphcast.graphcast_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        leaves = [v.requires_grad_(True) for v in _leaves_t(p)]
        loss = graphcast.graphcast_forward(p, x, ef, _t(s), _t(d), cfg, remat=remat).square().mean()
        out[remat] = (float(loss), [g.numpy() for g in torch.autograd.grad(loss, leaves)])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_array_equal(a, b)


def _rotation(r):
    q = np.linalg.qr(r.standard_normal((3, 3)))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def test_egnn_se3_equivariance():
    cfg = egnn.EGNNConfig(n_layers=2, d_hidden=16, d_in=8, d_out=2)
    p = egnn.params_from_numpy(ref_egnn.egnn_init(KEY, ref_egnn.EGNNConfig(**dataclasses.asdict(cfg))), "cpu")
    r = np.random.default_rng(0)
    n, e = 40, 150
    s, d = _t(r.integers(0, n, e)), _t(r.integers(0, n, e))
    h = _t(r.standard_normal((n, 8)).astype(np.float32))
    pos = _t(r.standard_normal((n, 3)).astype(np.float32))
    R, t = _t(_rotation(r)), torch.tensor([0.5, -1.0, 2.0])
    h1, x1 = egnn.egnn_forward(p, h, pos, s, d, cfg)
    h2, x2 = egnn.egnn_forward(p, h, pos @ R.T + t, s, d, cfg)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-4)
    np.testing.assert_allclose((x1 @ R.T + t).numpy(), x2.numpy(), atol=2e-4)


@pytest.mark.parametrize("model", ["pna", "egnn", "graphcast"])
def test_init_draws_the_reference_shapes(model):
    ref_mod, mod, init, *_ = MODELS[model]
    cfg = CONFIGS[model, "reduced"][0]
    ours = mod.__dict__[f"{model}_init"](torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = init(KEY, cfg)
    a, b = _leaves(ours), _leaves(theirs)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
        if k.endswith("/b") or k.endswith("/g"):
            np.testing.assert_array_equal(a[k], b[k])      # zeros and ones alike


@pytest.mark.parametrize("arch", ["pna", "egnn", "graphcast"])
def test_launch_train_matches_the_reference_setup(arch, monkeypatch, capsys):
    """``launch.train --arch A --device cpu --steps 3`` on the reference's
    initial parameters (its ``_init_gnn``, carried across): the losses of
    the reference's ``_gnn_setup`` + ``Trainer`` within 1e-4 relative."""
    from repro.launch import train as ref_train
    from repro.train.loop import Trainer as RefTrainer
    from repro.train.loop import TrainerConfig as RefTrainerConfig
    from repro.train.optimizer import adamw as ref_adamw
    from repro_torch.launch import train
    from repro_torch.train import loop

    spec = ref_get_arch(arch)
    params, loss_fn, batches = ref_train._gnn_setup(spec)
    ref = RefTrainer(loss_fn, ref_adamw(1e-3), params, RefTrainerConfig(log_every=10)).fit(batches(), max_steps=3)
    init = ref_train._init_gnn(arch, spec.make_reduced())
    monkeypatch.setattr(train, "_init_gnn", lambda arch_id, cfg, device: MODELS[arch][1].params_from_numpy(init, device))
    seen = []
    fit = loop.Trainer.fit

    def recording_fit(self, *a, **kw):
        seen.append(fit(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(loop.Trainer, "fit", recording_fit)
    train.main(["--arch", arch, "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith(f"{arch}: loss ") and "over 3 steps" in out
    np.testing.assert_allclose(seen[0], ref, rtol=1e-4)
