"""The port's graph kernels (`repro_torch.kernels`) against the JAX
package's, and its CUDA kernels against their plain versions.

On the CPU `repro_torch.kernels.ops.fused_gcn_layer` runs the plain PyTorch
version; it is held against the reference's `fused_gcn_layer` (Pallas in
interpret mode) at the reference suite's bsr tolerance, 3e-4. The tests
marked ``cuda`` hold the hand-written kernels (K2, the fused layer, and K1,
`bsr_spmm`) against the plain versions on the card at the same tolerance
(summation order differs), and one training step on the card against the
same step on the CPU; they skip without a card. JAX is imported inside
fixtures, so the ``cuda`` tests also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py
"""
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.graph.structure import blocked_adjacency
from repro_torch.kernels import bsr_spmm as k1
from repro_torch.kernels import fused_gcn as fg
from repro_torch.kernels.ops import bsr_spmm, fused_gcn_layer
from repro_torch.kernels.ref import bsr_spmm_ref, fused_gcn_layer_ref, poison_padding

TOL = 3e-4
ORDERS = ["feature_first", "aggregation_first"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel layer (skips where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    j_bsr = importlib.import_module("repro.kernels.bsr_spmm")   # the package re-exports a function of that name
    from repro.kernels import ops as j_ops, ref as j_ref

    return types.SimpleNamespace(jnp=jnp, ops=j_ops, ref=j_ref, bsr=j_bsr)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(n=300, e=1500, d_in=50, d_out=7, seed=0):
    """Seeded numpy inputs: a ragged blocked adjacency (tail block when
    n % 128 != 0), row-padded features, weights and a nonzero bias."""
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    ba = blocked_adjacency(n, ei, r.standard_normal(e).astype(np.float32))
    x = r.standard_normal((n, d_in)).astype(np.float32)
    w = (r.standard_normal((d_in, d_out)) * 0.2).astype(np.float32)
    b = r.standard_normal(d_out).astype(np.float32)
    return ba, x, w, b


def _torch_args(ba, x, w, b, device="cpu"):
    vals, cols, lens = ba.arrays(device=device)
    return vals, cols, lens, *(torch.from_numpy(a).to(device) for a in (x, w, b))


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol, atol=tol)


# ------------------------------------------------------------ CPU vs the JAX package
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_fused_layer_matches_jax(jx, order, relu):
    """n=300, 50 → 7 (as tests/test_kernels.py:106-124): awkward widths and a
    tail block of 44 rows."""
    ba, x, w, b = _case()
    ref = jx.ops.fused_gcn_layer(*[jx.jnp.asarray(a) for a in (ba.block_vals, ba.block_cols, ba.row_nnzb, x, w, b)],
                                 order=order, relu=relu)
    out = fused_gcn_layer(*_torch_args(ba, x, w, b), order=order, relu=relu)
    assert out.shape == (ba.n_padded, w.shape[1])
    _close(out[:300], np.asarray(ref)[:300])


@pytest.mark.parametrize("order", ORDERS)
def test_fused_layer_lens_none_matches_jax(jx, order):
    """lens=None: every tile counts (padding tiles are zero)."""
    ba, x, w, b = _case(n=260, e=900, d_in=24, d_out=5, seed=3)
    ref = jx.ops.fused_gcn_layer(jx.jnp.asarray(ba.block_vals), jx.jnp.asarray(ba.block_cols), None,
                                 jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b), order=order)
    vals, cols, _, xt, wt, bt = _torch_args(ba, x, w, b)
    _close(fused_gcn_layer(vals, cols, None, xt, wt, bt, order=order)[:260], np.asarray(ref)[:260])


def test_ref_oracles_match_jax(jx):
    ba, x, w, b = _case(n=257, e=800, d_in=16, d_out=6, seed=5)
    xp = np.zeros((ba.n_col_padded, x.shape[1]), np.float32)
    xp[:257] = x
    jv, jc = jx.jnp.asarray(ba.block_vals), jx.jnp.asarray(ba.block_cols)
    vals, cols, _ = ba.arrays(device="cpu")
    _close(bsr_spmm_ref(vals, cols, torch.from_numpy(xp)), jx.ref.bsr_spmm_ref(jv, jc, jx.jnp.asarray(xp)))
    for order in ORDERS:
        _close(fused_gcn_layer_ref(vals, cols, torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(b),
                                   order=order, relu=True),
               jx.ref.fused_gcn_layer_ref(jv, jc, jx.jnp.asarray(xp), jx.jnp.asarray(w), jx.jnp.asarray(b),
                                          order=order, relu=True))


def test_poison_padding_matches_jax(jx):
    ba, _, _, _ = _case(n=384, e=2500, seed=6)
    vals, _, lens = ba.arrays(device="cpu")
    ours = poison_padding(vals, lens).numpy()
    theirs = jx.bsr.poison_padding(ba.block_vals, ba.block_cols, ba.row_nnzb)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_array_equal(np.nan_to_num(ours), np.nan_to_num(theirs))


# -------------------------------------------------------------- the ragged contract
def _poisoned_empty_row(device="cpu", order="feature_first", d_in=20):
    """Poison every padding tile with NaN and empty block-row 1."""
    ba, x, w, b = _case(n=384, e=2500, d_in=d_in, d_out=9, seed=4)
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b, device)
    lens = lens.clone()
    lens[1] = 0
    out = fused_gcn_layer(poison_padding(vals, lens), cols, lens, xt, wt, bt, order=order)
    clean = fg.fused_gcn_layer_plain(vals.cpu(), cols.cpu(), lens.cpu(), xt.cpu(), wt.cpu(), bt.cpu(),
                                     order=order)
    return out.cpu(), clean, bt.cpu()


@pytest.mark.parametrize("order", ORDERS)
def test_poisoned_padding_stays_finite(order):
    out, clean, _ = _poisoned_empty_row(order=order)
    assert torch.isfinite(out).all()
    _close(out, clean, tol=1e-6)


@pytest.mark.parametrize("order", ORDERS)
def test_empty_block_row_gives_act_b(order):
    out, _, b = _poisoned_empty_row(order=order)
    torch.testing.assert_close(out[128:256], b.clamp_min(0).expand(128, -1), rtol=0, atol=0)


# ------------------------------------------------------------- argument checking
def test_wrapper_rejects_what_the_kernels_do_not_take():
    ba, x, w, b = _case()
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b)
    with pytest.raises(TypeError, match="float32"):
        fused_gcn_layer(vals, cols, lens, xt.double(), wt, bt)
    with pytest.raises(ValueError, match="unknown dataflow order"):
        fused_gcn_layer(vals, cols, lens, xt, wt, bt, order="sideways")
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fg.ff_transform(xt, wt)
    z = torch.zeros((ba.n_col_padded, 7))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fg.ff_aggregate(vals, cols, lens, z, bt)
    xp = torch.zeros((ba.n_col_padded, 50))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fg.af_layer(vals, cols, lens, xp, wt, bt)
    with pytest.raises(ValueError, match="multiple of 128"):
        fg.ff_aggregate(vals, cols, lens, z[:300], bt)
    with pytest.raises(ValueError, match="contiguous"):
        fg.ff_transform(xp.t(), wt)
    with pytest.raises(TypeError, match="int32"):
        fg.ff_aggregate(vals, cols.long(), lens, z, bt)
    with pytest.raises(ValueError, match="128×128"):
        fg.ff_aggregate(vals[:, :, :64, :64].contiguous(), cols, lens, z, bt)


def test_aggregation_first_width_limit():
    """The aggregation-first kernel keeps a 128 × F_in accumulator in shared
    memory; past its limit it raises instead of failing to launch."""
    assert fg.layer_smem_bytes(fg.AF_MAX_F_IN) <= fg.SMEM_LIMIT < fg.layer_smem_bytes(fg.AF_MAX_F_IN + 1)
    assert fg.AF_MAX_F_IN >= 210
    ba, _, _, _ = _case()
    vals, cols, lens = ba.arrays(device="cpu")
    f_in = fg.AF_MAX_F_IN + 1
    with pytest.raises(ValueError, match="F_in"):
        fg.af_layer(vals, cols, lens, torch.zeros((ba.n_col_padded, f_in)), torch.zeros((f_in, 4)),
                    torch.zeros(4))


# ------------------------------------------------------------ CUDA kernels (card)
@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_cuda_layer_matches_plain(cuda, order, relu):
    ba, x, w, b = _case()
    before = dict(fg.LAUNCHES)
    out = fused_gcn_layer(*_torch_args(ba, x, w, b, cuda), order=order, relu=relu)
    torch.cuda.synchronize()
    ref = fused_gcn_layer(*_torch_args(ba, x, w, b), order=order, relu=relu)
    _close(out.cpu(), ref)
    launched = {k: fg.LAUNCHES[k] - before[k] for k in before}
    want = ({"k2_ff_transform": 1, "k2_ff_aggregate": 1, "k2_af_layer": 0} if order == "feature_first"
            else {"k2_ff_transform": 0, "k2_ff_aggregate": 0, "k2_af_layer": 1})
    want["k1_bsr_spmm"] = 0
    assert launched == want


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
def test_cuda_poisoned_padding_and_empty_row(cuda, order):
    out, clean, b = _poisoned_empty_row(cuda, order)
    assert torch.isfinite(out).all()
    _close(out, clean)
    torch.testing.assert_close(out[128:256], b.clamp_min(0).expand(128, -1), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_in", [20, 24, 50])
def test_cuda_aggregation_first_widths(cuda, d_in):
    ba, x, w, b = _case(d_in=d_in, d_out=24, seed=d_in)
    out = fused_gcn_layer(*_torch_args(ba, x, w, b, cuda), order="aggregation_first")
    _close(out.cpu(), fused_gcn_layer(*_torch_args(ba, x, w, b), order="aggregation_first"))


@pytest.mark.cuda
@pytest.mark.parametrize("d_out", [16, 70, 210])
def test_cuda_feature_first_widths(cuda, d_out):
    """One and several output-column tiles per aggregation block."""
    ba, x, w, b = _case(d_in=300, d_out=d_out, seed=d_out)
    out = fused_gcn_layer(*_torch_args(ba, x, w, b, cuda), order="feature_first")
    _close(out.cpu(), fused_gcn_layer(*_torch_args(ba, x, w, b), order="feature_first"))


def _layer_grads(args, order, relu):
    """Gradients in w, b and x of Σ out² through `fused_gcn_layer`."""
    vals, cols, lens, x, w, b = args
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    out = fused_gcn_layer(vals, cols, lens, x, w, b, order=order, relu=relu)[:300]
    return torch.autograd.grad((out ** 2).sum(), (w, b, x))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_cuda_layer_backward_matches_cpu(cuda, order, relu):
    """The same Function on both devices: kernels forward on the card, the
    plain version on the CPU, one backward; aggregation-first recomputes
    Ã·X through K1."""
    ba, x, w, b = _case()
    before = fg.LAUNCHES["k1_bsr_spmm"]
    on_card = _layer_grads(_torch_args(ba, x, w, b, cuda), order, relu)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["k1_bsr_spmm"] - before == (order == "aggregation_first")
    for a, r in zip(on_card, _layer_grads(_torch_args(ba, x, w, b), order, relu)):
        scale = float(r.abs().max()) + 1e-9
        _close(a.cpu() / scale, r / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [7, 16, 50, 129])
def test_cuda_bsr_spmm_matches_plain(cuda, f):
    ba, _, _, _ = _case(seed=f)
    vals, cols, lens = ba.arrays(device=cuda)
    z = torch.from_numpy(np.random.default_rng(f).standard_normal((ba.n_col_padded, f)).astype(np.float32))
    before = fg.LAUNCHES["k1_bsr_spmm"]
    out = bsr_spmm(vals, cols, z.to(cuda), lens)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["k1_bsr_spmm"] == before + 1
    _close(out.cpu(), k1.bsr_spmm_plain(vals.cpu(), cols.cpu(), lens.cpu(), z))


@pytest.mark.cuda
def test_cuda_bsr_spmm_rectangular_poisoned_empty_row(cuda):
    """Z with twice the output's block-rows, NaN in every padding tile and
    an empty block-row: finite, equal to the clean plain version, zeros on
    the empty row."""
    ba, _, _, _ = _case(n=384, e=2500, seed=4)
    vals, cols, lens = ba.arrays(device="cpu")
    R, T = cols.shape
    lens = lens.clone()
    lens[1] = 0
    cols = (cols + R * (torch.arange(T, dtype=torch.int32) % 2)).contiguous()
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2 * R * 128, 16)).astype(np.float32))
    out = k1.bsr_spmm(poison_padding(vals, lens).to(cuda), cols.to(cuda), lens.to(cuda), z.to(cuda)).cpu()
    assert torch.isfinite(out).all()
    _close(out, k1.bsr_spmm_plain(vals, cols, lens, z))
    assert torch.equal(out[128:256], torch.zeros(128, 16))


@pytest.mark.cuda
def test_cuda_training_step_matches_cpu(cuda):
    """One AdamW step of a small bsr GCN (quant off, 50 → 16 → 24 so that
    layer 2 runs aggregation-first and its backward runs K1) on the card and
    on the CPU, from the same parameters."""
    from repro_torch.models.gcn import GCNConfig, gcn_loss
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import adamw

    ba, x, _, _ = _case(d_in=50)
    r = np.random.default_rng(11)
    params = {"w0": r.standard_normal((50, 16)) * 0.2, "b0": r.standard_normal(16),
              "w1": r.standard_normal((16, 24)) * 0.2, "b1": r.standard_normal(24)}
    labels = r.integers(0, 24, 300)
    cfg = GCNConfig(layer_dims=(50, 16, 24), backend="bsr")
    result = {}
    for device in ("cpu", cuda):
        adj = ba.arrays(device=device)
        batch = {"x": torch.from_numpy(x).to(device), "labels": torch.from_numpy(labels).to(device)}
        e = torch.zeros(1, dtype=torch.int32, device=device)

        def loss(p, bt, adj=adj, e=e):
            return gcn_loss(p, bt["x"], e, e, e.float(), bt["labels"], torch.ones(300, device=e.device),
                            cfg, adjacency=adj)

        tr = Trainer(loss, adamw(1e-2), {k: torch.tensor(v, dtype=torch.float32, device=device)
                                          for k, v in params.items()}, TrainerConfig(log_every=100))
        before = fg.LAUNCHES["k1_bsr_spmm"]
        losses = tr.fit(iter(lambda: batch, None), max_steps=2)
        result[str(device)] = (losses, {k: v.cpu() for k, v in tr.params.items()},
                               fg.LAUNCHES["k1_bsr_spmm"] - before)
    (l_cpu, p_cpu, k1_cpu), (l_card, p_card, k1_card) = result["cpu"], result[str(cuda)]
    assert (k1_cpu, k1_card) == (0, 2)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    for k in p_cpu:
        _close(p_card[k], p_cpu[k])
