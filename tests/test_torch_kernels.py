"""The port's graph kernels (`repro_torch.kernels`) against the JAX
package's, and its CUDA kernels against their plain versions.

On the CPU `repro_torch.kernels.ops.fused_gcn_layer` runs the plain PyTorch
version; it is held against the reference's `fused_gcn_layer` (Pallas in
interpret mode) at the reference suite's bsr tolerance, 3e-4, and in K2's
bf16-operand mode at the bf16 tolerance, 5e-2, with the same operand
dtypes. The tests marked ``cuda`` hold the hand-written kernels (K2, the
fused layer — fp32 and its bf16 instantiations — and K1, `bsr_spmm`)
against the plain versions on the card at the same tolerance (summation
order differs; 1e-2 of the largest magnitude for a bf16 output), and one
training step on the card against the same step on the CPU; they skip
without a card. JAX is imported inside
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
BF16_TOL = 5e-2            # ROADMAP parity contract: bf16 operands
BF16_CARD_TOL = 1e-2       # kernel vs plain on the card, bf16 output: one rounding, sums in another order
ORDERS = ["feature_first", "aggregation_first"]
F32, BF16 = torch.float32, torch.bfloat16
BF16_COMBOS = [pytest.param((F32, BF16, F32), id="bf16_table"), pytest.param((BF16, BF16, BF16), id="bf16_all")]


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


@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_bf16_fused_layer_matches_jax(jx, combo, order, relu):
    """K2's bf16-operand mode: the plain version (which rounds where the
    kernels round) against the reference's `fused_gcn_layer` in interpret
    mode with the same (vals, x, w) dtypes and an fp32 bias; both return
    bf16 (as tests/test_kernels.py:127-147, at 300 nodes, 50 → 7)."""
    vd, xd, wd = combo
    ba, x, w, b = _case()
    jd = {F32: jx.jnp.float32, BF16: jx.jnp.bfloat16}
    ref = jx.ops.fused_gcn_layer(jx.jnp.asarray(ba.block_vals, jd[vd]), jx.jnp.asarray(ba.block_cols),
                                 jx.jnp.asarray(ba.row_nnzb), jx.jnp.asarray(x, jd[xd]),
                                 jx.jnp.asarray(w, jd[wd]), jx.jnp.asarray(b), order=order, relu=relu)
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b)
    out = fused_gcn_layer(vals.to(vd), cols, lens, xt.to(xd), wt.to(wd), bt, order=order, relu=relu)
    assert out.dtype == BF16 and str(ref.dtype) == "bfloat16"
    _close(out[:300].float(), np.asarray(ref, np.float32)[:300], tol=BF16_TOL)


def test_bf16_plain_rounds_where_the_kernels_do():
    """Feature-first rounds Z to vals' dtype; aggregation-first rounds Ã·X to
    W's dtype; both store X's dtype and apply bias and ReLU in fp32."""
    ba, x, w, b = _case(n=260, e=900, d_in=24, d_out=5, seed=3)
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b)
    xp = torch.cat([xt, xt.new_zeros((ba.n_col_padded - 260, 24))])
    v16, x16, w16 = vals.to(BF16), xp.to(BF16), wt.to(BF16)
    z = fg.ff_transform_plain(x16, w16, BF16)
    assert z.dtype == BF16 and torch.equal(z, (x16.float() @ w16.float()).to(BF16))
    ff = fg.fused_gcn_layer_plain(v16, cols, lens, x16, w16, bt, order="feature_first")
    want = (fg._ragged_aggregate_plain(v16, cols, lens, z) + bt).clamp_min(0).to(BF16)
    assert torch.equal(ff, want)
    af = fg.fused_gcn_layer_plain(vals, cols, lens, x16, wt, bt, order="aggregation_first", relu=False)
    m = fg._ragged_aggregate_plain(vals, cols, lens, x16)
    assert af.dtype == BF16 and torch.equal(af, (m @ wt + bt).to(BF16))


# ------------------------------------------------ K1's bf16 mode (per-tile rounding)
def _k1_bf16_case(name):
    """Seeded numpy inputs of K1 with a bf16 Z. ``three_rows``: R=3, T=40,
    lens (40, 17, 1), F=16, five column blocks, fp32 vals ~ 0.05·N(0,1).
    ``halo``: a rectangular [local ‖ halo]-like table (4 block-rows, 11
    column blocks, an empty block-row), F=24. ``halo_bf16_all``: the same
    with bf16 vals."""
    r = np.random.default_rng(0)
    if name == "three_rows":
        R, T, F, cb, lens = 3, 40, 16, 5, [40, 17, 1]
    else:
        R, T, F, cb, lens = 4, 12, 24, 11, [12, 5, 0, 9]
    vals = (0.05 * r.standard_normal((R, T, 128, 128))).astype(np.float32)
    cols = r.integers(0, cb, size=(R, T)).astype(np.int32)
    z = r.standard_normal((cb * 128, F)).astype(np.float32)
    return vals, cols, np.array(lens, np.int32), z, (BF16 if name == "halo_bf16_all" else F32)


def _bf16_rule(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(share of bit-equal elements, max |out − ref| / max |ref|)."""
    out, ref = out.float(), ref.float()
    return float((out == ref).float().mean()), float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("name", ["three_rows", "halo", "halo_bf16_all"])
def test_k1_bf16_plain_rounds_per_tile_as_the_reference(jx, name):
    """K1 with a bf16 Z against the reference's interpret-mode
    `bsr_spmm_pallas`, whose bf16 output block rounds the running sum after
    every tile: at least 99 % of the elements bit-equal, the rest within one
    bf16 step of the largest (2⁻⁷ · max |ref|); summation order inside a
    tile may flip a rounding. Through `kernels.ops.bsr_spmm` too, whose
    output has Z's dtype."""
    vals, cols, lens, z, vals_dtype = _k1_bf16_case(name)
    jnp = jx.jnp
    jv = jnp.asarray(vals).astype(jnp.bfloat16 if vals_dtype == BF16 else jnp.float32)
    ref = jx.bsr.bsr_spmm_pallas(jv, jnp.asarray(cols), jnp.asarray(lens), jnp.asarray(z).astype(jnp.bfloat16),
                                 f_tile=z.shape[1], interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    tv, tc, tl = torch.from_numpy(vals).to(vals_dtype), torch.from_numpy(cols), torch.from_numpy(lens)
    tz = torch.from_numpy(z).to(BF16)
    for out in (k1.bsr_spmm_plain(tv, tc, tl, tz), bsr_spmm(tv, tc, tz, tl)):
        assert out.dtype == BF16
        equal, worst = _bf16_rule(out, ref)
        assert equal >= 0.99 and worst <= 2.0 ** -7, (name, equal, worst)


def test_k1_bf16_round_once_fails_the_rule(jx):
    """The rule above tells the reference's per-tile rounding from rounding
    the fp32 sum once at the end: the latter misses it badly."""
    vals, cols, lens, z, _ = _k1_bf16_case("three_rows")
    jnp = jx.jnp
    ref = jx.bsr.bsr_spmm_pallas(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(lens),
                                 jnp.asarray(z).astype(jnp.bfloat16), f_tile=z.shape[1], interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    tz = torch.from_numpy(z).to(BF16)
    once = fg._ragged_aggregate_plain(torch.from_numpy(vals), torch.from_numpy(cols), torch.from_numpy(lens),
                                      tz).to(BF16)
    equal, _ = _bf16_rule(once, ref)
    assert equal < 0.9, equal


def test_bf16_combinations_the_kernels_do_not_take():
    ba, x, w, b = _case()
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b)
    for args in ((vals.to(BF16), xt, wt), (vals, xt, wt.to(BF16)), (vals, xt.to(BF16), wt.to(BF16)),
                 (vals.half(), xt.half(), wt.half())):
        with pytest.raises(TypeError, match="takes \\(vals, x, w\\) dtypes"):
            fused_gcn_layer(*args[:1], cols, lens, *args[1:], bt)
    with pytest.raises(TypeError, match="bias"):
        fused_gcn_layer(vals, cols, lens, xt, wt, bt.double())
    with pytest.raises(TypeError, match="takes \\(vals, z\\) dtypes"):
        bsr_spmm(vals.to(BF16), cols, xt, lens)
    z = torch.zeros((ba.n_col_padded, 7))
    with pytest.raises(TypeError, match="vals' dtype"):
        fg.ff_aggregate(vals, cols, lens, z.to(BF16), bt)
    with pytest.raises(TypeError, match="takes \\(vals, x, w\\) dtypes"):
        fg.ff_transform(xt.to(BF16), wt, BF16)
    with pytest.raises(TypeError, match="b must be"):
        fg.af_layer(vals, cols, lens, torch.zeros((ba.n_col_padded, 50)), wt, bt.to(BF16))


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
    want = dict.fromkeys(fg.LAUNCHES, 0)
    want.update({"k2_ff_transform": 1, "k2_ff_aggregate": 1} if order == "feature_first" else {"k2_af_layer": 1})
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


# ------------------------------------------------- K2 bf16 instantiations (card)
@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [True, False])
def test_cuda_bf16_layer_matches_plain(cuda, combo, order, relu):
    """Each bf16 instantiation against its plain version on the same inputs,
    with its launches counted under its own name."""
    vd, xd, wd = combo
    ba, x, w, b = _case()
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b, cuda)
    vals, xt, wt = vals.to(vd), xt.to(xd), wt.to(wd)
    before = dict(fg.LAUNCHES)
    out = fused_gcn_layer(vals, cols, lens, xt, wt, bt, order=order, relu=relu)
    torch.cuda.synchronize()
    launched = {k: fg.LAUNCHES[k] - before[k] for k in before if fg.LAUNCHES[k] != before[k]}
    sfx = fg.operand_suffix("test", vd, xd, wd)
    assert launched == ({f"k2_ff_transform{sfx}": 1, f"k2_ff_aggregate{sfx}": 1} if order == "feature_first"
                        else {f"k2_af_layer{sfx}": 1})
    ref = fg.fused_gcn_layer_plain(vals.cpu(), cols.cpu(), lens.cpu(), ops_pad(xt.cpu()), wt.cpu(), bt.cpu(),
                                   order=order, relu=relu)
    assert out.dtype == ref.dtype == BF16
    scale = float(ref.float().abs().max())
    assert float((out.cpu().float() - ref.float()).abs().max()) <= BF16_CARD_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
def test_cuda_bf16_poisoned_padding_and_empty_row(cuda, combo):
    vd, xd, wd = combo
    ba, x, w, b = _case(n=384, e=2500, d_in=16, d_out=40, seed=4)
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b, cuda)
    lens = lens.clone()
    lens[1] = 0
    out = fused_gcn_layer(poison_padding(vals, lens).to(vd), cols, lens, xt.to(xd), wt.to(wd), bt,
                          order="aggregation_first")
    ref = fg.fused_gcn_layer_plain(vals.to(vd).cpu(), cols.cpu(), lens.cpu(), ops_pad(xt.to(xd).cpu()),
                                   wt.to(wd).cpu(), bt.cpu(), order="aggregation_first")
    assert torch.isfinite(out.float()).all()
    scale = float(ref.float().abs().max())
    assert float((out.cpu().float() - ref.float()).abs().max()) <= BF16_CARD_TOL * scale
    assert torch.equal(out[128:256].cpu(), bt.cpu().clamp_min(0).to(BF16).expand(128, -1))


# --------------------------------------------------- K1 bf16 instantiations (card)
K1_BF16 = [pytest.param((F32, BF16), id="bf16"), pytest.param((BF16, BF16), id="bf16_all")]


@pytest.mark.cuda
@pytest.mark.parametrize("combo", K1_BF16)
@pytest.mark.parametrize("f", [16, 70])
def test_cuda_k1_bf16_matches_plain(cuda, combo, f):
    """K1 with a bf16 Z on the card against the plain version's per-tile
    rounding (`_bf16_rule`), on a rectangular Z, with its launches counted
    under its own name."""
    vd, zd = combo
    ba, _, _, _ = _case(seed=f)
    vals, cols, lens = ba.arrays(device="cpu")
    R, T = cols.shape
    cols = (cols + R * (torch.arange(T, dtype=torch.int32) % 2)).contiguous()
    vals = vals.to(vd)
    z = torch.from_numpy(np.random.default_rng(f).standard_normal((2 * R * 128, f)).astype(np.float32)).to(zd)
    name = k1.k1_name(vd, zd)
    before = fg.LAUNCHES[name]
    out = bsr_spmm(vals.to(cuda), cols.to(cuda), z.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert fg.LAUNCHES[name] == before + 1 and out.dtype == BF16
    equal, worst = _bf16_rule(out.cpu(), k1.bsr_spmm_plain(vals, cols, lens, z))
    assert equal >= 0.99 and worst <= 2.0 ** -7, (equal, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("combo", K1_BF16)
def test_cuda_k1_bf16_poisoned_padding_and_empty_row(cuda, combo):
    vd, zd = combo
    ba, _, _, _ = _case(n=384, e=2500, seed=4)
    vals, cols, lens = ba.arrays(device="cpu")
    lens = lens.clone()
    lens[1] = 0
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((vals.shape[0] * 128, 16)).astype(np.float32))
    z = z.to(zd)
    out = k1.bsr_spmm(poison_padding(vals, lens).to(vd).to(cuda), cols.to(cuda), lens.to(cuda), z.to(cuda)).cpu()
    assert torch.isfinite(out.float()).all()
    equal, worst = _bf16_rule(out, k1.bsr_spmm_plain(vals.to(vd), cols, lens, z))
    assert equal >= 0.99 and worst <= 2.0 ** -7, (equal, worst)
    assert torch.equal(out[128:256], torch.zeros(128, 16, dtype=BF16))


def ops_pad(x: torch.Tensor) -> torch.Tensor:
    """Row-pad to the block grid, as `fused_gcn_layer` does before the kernels."""
    from repro_torch.kernels.ops import _pad_rows

    return _pad_rows(x, 128)
