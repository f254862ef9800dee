"""Gradients of the port's graph kernels against the JAX package's custom VJPs.

`repro_torch.kernels.ops.bsr_spmm` and `fused_gcn_layer` are
`torch.autograd.Function`s whose backward is the reference's
`_bsr_diff_bwd` / `_fused_diff_bwd`. On the CPU their forward runs the plain
version, so these tests check the backward formulas themselves against
`jax.grad` of the reference wrappers (Pallas in interpret mode), at the
reference suite's fused-layer gradient tolerance: 2e-5 of each gradient's
largest magnitude (`tests/test_kernels.py:150-190`).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.graph.structure import blocked_adjacency
from repro_torch.kernels import ops
from repro_torch.kernels.ref import poison_padding

TOL = 2e-5
ORDERS = ["feature_first", "aggregation_first"]


def _case(n=260, e=1000, d_in=24, d_out=5, seed=0):
    """A ragged table with a 4-row tail block, features, weights, bias."""
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    ba = blocked_adjacency(n, ei, r.standard_normal(e).astype(np.float32))
    x = r.standard_normal((n, d_in)).astype(np.float32)
    w = (r.standard_normal((d_in, d_out)) * 0.2).astype(np.float32)
    b = r.standard_normal(d_out).astype(np.float32)
    return ba, x, w, b


def _close(ours, ref, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = float(np.abs(ref).max()) + 1e-9
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=TOL, atol=TOL, err_msg=what)


def _torch_grads(fn, *arrays):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(fn(*leaves), leaves)]


# --------------------------------------------------------------------- bsr_spmm
@pytest.mark.parametrize("f", [7, 33])
def test_bsr_spmm_grad_matches_jax(f):
    ba, _, _, _ = _case(seed=f)
    z = np.random.default_rng(f).standard_normal((ba.n_col_padded - 5, f)).astype(np.float32)
    cols, lens = ba.block_cols, ba.row_nnzb

    def loss_j(vals, z):
        return (j_ops.bsr_spmm(vals, jnp.asarray(cols), z, lens=jnp.asarray(lens)) ** 2).sum()

    def loss_t(vals, z):
        return (ops.bsr_spmm(vals, torch.from_numpy(cols), z, lens=torch.from_numpy(lens)) ** 2).sum()

    ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(ba.block_vals), jnp.asarray(z))
    ours = _torch_grads(loss_t, ba.block_vals, z)
    for name, a, r in zip(("dvals", "dz"), ours, ref):
        _close(a, r, name)


# -------------------------------------------------------------- fused_gcn_layer
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_fused_layer_grad_matches_jax(order, relu):
    """d/d(w, b, x, vals) of Σ out[:n]² — the reference's gradient test
    shapes (n=260, 24 → 5), every differentiable operand."""
    ba, x, w, b = _case()
    n = x.shape[0]
    cols, lens = ba.block_cols, ba.row_nnzb

    def loss_j(w, b, x, vals):
        out = j_ops.fused_gcn_layer(vals, jnp.asarray(cols), jnp.asarray(lens), x, w, b,
                                    order=order, relu=relu)
        return (out[:n] ** 2).sum()

    def loss_t(w, b, x, vals):
        out = ops.fused_gcn_layer(vals, torch.from_numpy(cols), torch.from_numpy(lens), x, w, b,
                                  order=order, relu=relu)
        return (out[:n] ** 2).sum()

    ref = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (w, b, x, ba.block_vals)))
    ours = _torch_grads(loss_t, w, b, x, ba.block_vals)
    for name, a, r in zip(("dw", "db", "dx", "dvals"), ours, ref):
        _close(a, r, f"{order}/relu={relu}/{name}")


@pytest.mark.parametrize("order", ORDERS)
def test_fused_layer_grad_lens_none_matches_jax(order):
    """lens=None (dense-T: every tile counts, padding tiles are zero)."""
    ba, x, w, b = _case(n=300, e=1500, d_in=20, d_out=9, seed=2)
    cols = ba.block_cols

    def loss_j(w, x):
        return (j_ops.fused_gcn_layer(jnp.asarray(ba.block_vals), jnp.asarray(cols), None, x, w,
                                      jnp.asarray(b), order=order)[:300] ** 2).sum()

    def loss_t(w, x):
        return (ops.fused_gcn_layer(torch.from_numpy(ba.block_vals), torch.from_numpy(cols), None, x, w,
                                    torch.from_numpy(b), order=order)[:300] ** 2).sum()

    ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    for name, a, r in zip(("dw", "dx"), _torch_grads(loss_t, w, x), ref):
        _close(a, r, f"{order}/{name}")


# ------------------------------------------------------------------ the padding
@pytest.mark.parametrize("order", ORDERS)
def test_poisoned_padding_gradients_finite_and_zero_on_padding(order):
    """NaN in every padding tile and an emptied block-row: the backward reads
    valid tiles only, so every gradient is finite, dvals is zero on padding
    tiles, and all equal the gradients of the clean table."""
    ba, x, w, b = _case(n=384, e=2500, d_in=20, d_out=9, seed=4)
    cols = torch.from_numpy(ba.block_cols)
    lens = torch.from_numpy(ba.row_nnzb).clone()
    lens[1] = 0
    clean = torch.from_numpy(ba.block_vals)

    def grads(vals):
        return _torch_grads(lambda w, b, x, v: (ops.fused_gcn_layer(v, cols, lens, x, w, b, order=order)[:384] ** 2).sum(),
                            w, b, x, vals)

    poisoned, ref = grads(poison_padding(clean, lens).numpy()), grads(clean.numpy())
    pad = ~ops._tile_mask(cols, lens).numpy()
    assert pad.any() and np.isnan(poison_padding(clean, lens).numpy()[pad]).all()
    assert all(np.isfinite(g).all() for g in poisoned)
    assert (poisoned[3][pad] == 0).all()
    for name, a, r in zip(("dw", "db", "dx", "dvals"), poisoned, ref):
        _close(a, r, name)


def test_bsr_spmm_poisoned_padding_gradients_finite():
    ba, _, _, _ = _case(n=384, e=2500, seed=5)
    cols = torch.from_numpy(ba.block_cols)
    lens = torch.from_numpy(ba.row_nnzb)
    z = np.random.default_rng(5).standard_normal((ba.n_col_padded, 8)).astype(np.float32)
    vals = poison_padding(torch.from_numpy(ba.block_vals), lens).numpy()
    dvals, dz = _torch_grads(lambda v, z: (ops.bsr_spmm(v, cols, z, lens=lens) ** 2).sum(), vals, z)
    assert np.isfinite(dvals).all() and np.isfinite(dz).all()
    assert (dvals[~ops._tile_mask(cols, lens).numpy()] == 0).all()


# -------------------------------------------------------- gradients not asked for
def _ctx(saved, needs, **attrs):
    return types.SimpleNamespace(saved_tensors=saved, needs_input_grad=needs, **attrs)


@pytest.mark.parametrize("order", ORDERS)
def test_backward_skips_dvals_and_dx_when_not_asked(order, monkeypatch):
    """With only w and b asking, the backward returns None for vals and x
    and never builds dvals (10 GB at Nell's widths)."""
    ba, x, w, b = _case()
    vals, cols, lens = ba.arrays(device="cpu")
    xt = ops._pad_rows(torch.from_numpy(x), 128)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    out = ops.fused_gcn_layer(vals, cols, lens, xt, wt, bt, order=order)
    monkeypatch.setattr(ops, "_bsr_dvals", lambda *a: pytest.fail("dvals was computed"))
    ctx = _ctx((vals, cols, lens, xt, wt, out), (False, False, False, False, True, True),
               order=order, relu=True)
    grads = ops._FusedGcnLayer.backward(ctx, torch.ones_like(out))
    assert grads[0] is None and grads[3] is None
    assert grads[4].shape == wt.shape and grads[5].shape == bt.shape
    ctx.needs_input_grad = (False, False, False, True, False, False)
    grads = ops._FusedGcnLayer.backward(ctx, torch.ones_like(out))
    assert grads[3].shape == xt.shape and grads[0] is None and grads[4] is None and grads[5] is None


def test_bsr_spmm_backward_skips_what_is_not_asked(monkeypatch):
    ba, _, _, _ = _case()
    vals, cols, lens = ba.arrays(device="cpu")
    z = torch.ones((ba.n_col_padded, 4))
    g = torch.ones((ba.n_padded, 4))
    monkeypatch.setattr(ops, "_bsr_dvals", lambda *a: pytest.fail("dvals was computed"))
    dvals, _, _, dz = ops._BsrSpmm.backward(_ctx((vals, cols, lens, z), (False, False, False, True)), g)
    assert dvals is None and dz.shape == z.shape
    monkeypatch.undo()
    monkeypatch.setattr(ops, "_bsr_t_apply", lambda *a: pytest.fail("dz was computed"))
    dvals, _, _, dz = ops._BsrSpmm.backward(_ctx((vals, cols, lens, z), (True, False, False, False)), g)
    assert dz is None and dvals.shape == vals.shape


def test_gcn_training_gradient_builds_neither_dvals_nor_input_dx(monkeypatch):
    """The training path (parameters ask, the graph and X do not): no
    dvals, and the blocked transpose runs once per layer — layer 1's
    dx is never formed."""
    from repro_torch.graph.generators import citation_like
    from repro_torch.models.gcn import GCNConfig, gcn_init, gcn_loss

    g = citation_like(300, 1500, n_features=40, n_labels=24, seed=1)
    ba = blocked_adjacency(g.n_nodes, g.edge_index)
    cfg = GCNConfig(layer_dims=(40, 16, 24), backend="bsr")
    params = {k: v.requires_grad_() for k, v in gcn_init(torch.Generator().manual_seed(0), cfg,
                                                           device="cpu").items()}
    calls = []
    real_t_apply = ops._bsr_t_apply
    monkeypatch.setattr(ops, "_bsr_dvals", lambda *a: pytest.fail("dvals was computed"))
    monkeypatch.setattr(ops, "_bsr_t_apply", lambda *a: calls.append(a[3].shape) or real_t_apply(*a))
    e = torch.zeros(1, dtype=torch.int32)
    loss = gcn_loss(params, torch.from_numpy(g.features), e, e, e.float(), torch.from_numpy(g.labels),
                    torch.ones(g.n_nodes), cfg, adjacency=ba)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(torch.isfinite(t).all() for t in grads)
    assert len(calls) == 2          # layer 1: dz for dw; layer 2: dx of h1 (16 wide)
