"""The port's graph kernels (`repro_torch.kernels`) against the JAX
package's, and its CUDA kernels against their plain versions.

On the CPU `repro_torch.kernels.ops.fused_gcn_layer` runs the plain PyTorch
version; it is held against the reference's `fused_gcn_layer` (Pallas in
interpret mode) at the reference suite's bsr tolerance, 3e-4, and in K2's
bf16-operand mode at the bf16 tolerance, 5e-2, with the same operand
dtypes. The tests marked ``cuda`` hold the hand-written kernels (K2, the
fused layer — fp32 and its bf16 instantiations —, K1, `bsr_spmm`, K3,
DeepFM's `fm_interaction`, and K4, the LM's `flash_attention`) against the
plain versions on the card at the same tolerance (summation order differs;
1e-2 of the largest magnitude for a bf16 output; 1e-4 of it for K3 and K4,
chip_smoke's rule), one training step on the card against the same step on
the CPU, K3's backward against the CPU's in float64, which `gradcheck`
holds, and one K4 launch per layer of a prefill at gemma3-12b's widths;
and the ragged kernels' split schedule (every K1 and K2-aggregation
instantiation on a skewed table with one block-row of 300 tiles, the same
bits on a second call, and no host synchronisation in a wrapper call,
under ``torch.cuda.set_sync_debug_mode("error")``); they skip without a
card. `ragged_split`, the numpy mirror of that schedule, is checked here
on the CPU. (K3's and K4's CPU parity with the reference is
in tests/test_torch_deepfm.py and tests/test_torch_flash_attention.py.) JAX is imported inside
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
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import fm_interaction as k3
from repro_torch.kernels import fused_gcn as fg
from repro_torch.kernels.ops import bsr_spmm, flash_attention, fm_interaction, fused_gcn_layer
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
    """The aggregation-first kernel aggregates at most `AF_MAX_F_IN` columns
    of F_in at once (its shared-memory accumulator) and takes a wider F_in in
    chunks; the only width it refuses is the reference's: resident =
    4·(F_in·F_out + 2·128·F_in + 128·F_out + 128²) > 14e6, with the
    reference's message (at F_out = 128: F_in 9,029 runs, 9,030 raises)."""
    assert fg.layer_smem_bytes(fg.AF_MAX_F_IN) <= fg.SMEM_LIMIT < fg.layer_smem_bytes(fg.AF_MAX_F_IN + 1)
    assert fg.AF_MAX_F_IN >= 210
    ba, _, _, _ = _case()
    vals, cols, lens = ba.arrays(device="cpu")
    for f_in, f_out in ((fg.AF_MAX_F_IN + 1, 4), (1433, 128), (9029, 128)):
        # Past the width check: a CPU tensor then reaches the device check.
        with pytest.raises(ValueError, match="launches a CUDA kernel"):
            fg.af_layer(vals, cols, lens, torch.zeros((ba.n_col_padded, f_in)), torch.zeros((f_in, f_out)),
                        torch.zeros(f_out))
    for f_in, f_out in ((9030, 128), (241, 20_000)):
        with pytest.raises(ValueError, match="VMEM-resident"):
            fg.af_layer(vals, cols, lens, torch.zeros((ba.n_col_padded, f_in)), torch.zeros((f_in, f_out)),
                        torch.zeros(f_out))


def test_aggregation_first_resident_error_matches_jax(jx):
    """`ops.fused_gcn_layer(order="aggregation_first")` raises where the
    reference raises, with its message, on the CPU too; feature-first takes
    the same widths."""
    ba, _, _, _ = _case(n=130, e=300)
    vals, cols, lens = ba.arrays(device="cpu")
    for f_in, f_out in ((9030, 128), (4000, 1000)):
        x, w, b = np.zeros((130, f_in), np.float32), np.zeros((f_in, f_out), np.float32), np.zeros(f_out, np.float32)
        with pytest.raises(ValueError) as want:
            jx.ops.fused_gcn_layer(*[jx.jnp.asarray(a) for a in (ba.block_vals, ba.block_cols, ba.row_nnzb, x, w, b)],
                                   order="aggregation_first")
        with pytest.raises(ValueError) as got:
            fused_gcn_layer(vals, cols, lens, *(torch.from_numpy(a) for a in (x, w, b)), order="aggregation_first")
        assert str(got.value) == str(want.value)


def test_af_chunk_geometry():
    """`af_chunk`: one chunk of F_in up to `AF_MAX_F_IN`; past it the fewest
    chunks, of one width that is a multiple of 16 and fits shared memory,
    covering F_in with a narrower last chunk."""
    assert fg.af_chunk(16) == (16, 1) and fg.af_chunk(fg.AF_MAX_F_IN) == (fg.AF_MAX_F_IN, 1)
    for f_in in (241, 256, 300, 481, 1433, 5414, 9029):
        ft, n = fg.af_chunk(f_in)
        assert ft % 16 == 0 and ft <= fg.AF_MAX_F_IN and n == -(-f_in // fg.AF_MAX_F_IN)
        assert (n - 1) * ft < f_in <= n * ft
        assert fg.layer_smem_bytes(ft) <= fg.SMEM_LIMIT
    assert fg.af_chunk(241) == (128, 2) and fg.af_chunk(1433) == (240, 6) and fg.af_chunk(9029) == (240, 38)


@pytest.mark.parametrize("f_in", [241, 300])
@pytest.mark.parametrize("relu", [True, False])
def test_wide_aggregation_first_matches_jax(jx, f_in, relu):
    """Aggregation-first past one chunk of the kernel (F_in > `AF_MAX_F_IN`):
    the port's layer on the CPU (its plain version) against the reference's
    interpret-mode `fused_gcn_layer(order="aggregation_first")` at the bsr
    tolerance; n = 260 (a tail block), F_out = 9."""
    ba, x, w, b = _case(n=260, e=1200, d_in=f_in, d_out=9, seed=f_in)
    ref = jx.ops.fused_gcn_layer(*[jx.jnp.asarray(a) for a in (ba.block_vals, ba.block_cols, ba.row_nnzb, x, w, b)],
                                 order="aggregation_first", relu=relu)
    out = fused_gcn_layer(*_torch_args(ba, x, w, b), order="aggregation_first", relu=relu)
    _close(out[:260], np.asarray(ref)[:260])


# ------------------------------------------------ the ragged kernels' split schedule
def _skewed_lens(name):
    """Block-row lengths the split must cut: Nell-like skew (one row of 299
    among short rows), empty rows first, in the middle and last, all tiles in
    one row, and no valid tile at all."""
    r = np.random.default_rng(7)
    if name == "nell_like":
        lens = r.integers(1, 40, 514)
        lens[[3, 100, 511]] = (299, 259, 191)
        return lens
    return {"empty_rows": [0, 0, 5, 0, 0, 7, 1, 0, 0], "one_row": [0, 40, 0], "no_tiles": [0, 0, 0, 0],
            "single": [1]}[name]


@pytest.mark.parametrize("grid,min_tiles,weight", [(1, 1, 1), (4, 1, 1), (132, 4, 2), (528, 4, 1), (2000, 1, 3)])
@pytest.mark.parametrize("name", ["nell_like", "empty_rows", "one_row", "no_tiles", "single"])
def test_ragged_split_covers_every_valid_tile_once(name, grid, min_tiles, weight):
    """`ragged_split`, the numpy mirror of the kernels' schedule: every valid
    tile in exactly one block's segments, never a padding tile, every
    block-row (an empty one too) held by one block or by consecutive blocks
    (so exactly one finishes it), position shares that differ by at most
    one, and no block under ``min_tiles`` positions where there are that
    many."""
    lens = np.asarray(_skewed_lens(name))
    T = int(lens.max())
    blocks = fg.ragged_split(lens, T, grid, min_tiles, weight)
    n = int(lens.sum()) + weight * len(lens)
    assert 1 <= len(blocks) <= grid
    seen = np.zeros((len(lens), T), np.int64)
    holders = {r: [] for r in range(len(lens))}
    for blk in blocks:
        for r, t0, t1 in blk["segments"]:
            assert 0 <= t0 < t1 <= lens[r] and r in blk["rows"]
            seen[r, t0:t1] += 1
        for r in blk["rows"]:
            holders[r].append(blk["block"])
    assert (seen == (np.arange(T)[None, :] < lens[:, None])).all()
    assert all(h and h == list(range(h[0], h[-1] + 1)) for h in holders.values())
    shares = [blk["hi"] - blk["lo"] for blk in blocks]
    assert sum(shares) == n and max(shares) - min(shares) <= 1
    if n >= min_tiles:
        assert min(shares) >= min_tiles


def test_ragged_split_balances_nell_like_rows():
    """At one wave of 132 SMs × 4 blocks, the most valid tiles any block
    streams is within 2× of the mean (one block a block-row gave the
    299-tile row to one block); the aggregation-first layer's heavier row
    weight at 210 outputs too."""
    lens = _skewed_lens("nell_like")
    for weight in (1, fg.ragged_row_weight("k2_af_layer", 210)):
        blocks = fg.ragged_split(lens, 299, 528, row_weight=weight)
        tiles = [sum(t1 - t0 for _, t0, t1 in b["segments"]) for b in blocks]
        assert len(tiles) == 528 and sum(tiles) == lens.sum() and max(tiles) <= 2 * np.mean(tiles)
    assert fg.ragged_row_weight("k2_af_layer", 210) == 7 and fg.ragged_row_weight("k1_bsr_spmm", 210) == 1


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
@pytest.mark.parametrize("combo", [pytest.param((F32, F32, F32), id="f32"), *BF16_COMBOS])
@pytest.mark.parametrize("d_in", [241, 481, 1433])
def test_cuda_wide_aggregation_first(cuda, d_in, combo):
    """F_in past one chunk: the kernel against its plain version (fp32
    within 2e-5 of max, bf16 operands within 5e-2), the same bits on a
    second call."""
    vd, xd, wd = combo
    ba, x, w, b = _case(n=600, e=4000, d_in=d_in, d_out=128, seed=d_in)
    vals, cols, lens, xt, wt, bt = _torch_args(ba, x, w, b, cuda)
    vals, xt, wt = vals.to(vd).contiguous(), xt.to(xd), wt.to(wd)
    xp = torch.cat([xt, xt.new_zeros((ba.n_col_padded - xt.shape[0], d_in))])
    out, again = fg.af_layer(vals, cols, lens, xp, wt, bt), fg.af_layer(vals, cols, lens, xp, wt, bt)
    ref = fg.af_layer_plain(vals, cols, lens, xp, wt, bt)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    scale = float(ref.float().abs().max())
    tol = 2e-5 if xd == F32 else BF16_TOL
    assert float((out.float() - ref.float()).abs().max()) <= tol * scale


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


# ----------------------------------------- the split schedule on the card (K1, K2)
RAGGED = [pytest.param(("ff", c), id=f"ff_{i}") for i, c in zip(("f32", "bf16", "bf16_all"), (
    (F32, F32, F32), (F32, BF16, F32), (BF16, BF16, BF16)))] + \
    [pytest.param(("af", c), id=f"af_{i}") for i, c in zip(("f32", "bf16", "bf16_all"), (
        (F32, F32, F32), (F32, BF16, F32), (BF16, BF16, BF16)))] + \
    [pytest.param(("k1", c), id=f"k1_{i}") for i, c in zip(("f32", "bf16", "bf16_all"), (
        (F32, F32), (F32, BF16), (BF16, BF16)))]


def _skewed_call(inst, device, f=16):
    """A skewed table on ``device`` — one block-row of 300 tiles among 23
    rows of 1–3, NaN in the padding, an empty row — and one ragged call on
    it: (call, plain version on the clean table)."""
    kind, dtypes = inst
    r = np.random.default_rng(19)
    lens = r.integers(1, 4, 24).astype(np.int32)
    lens[5], lens[17] = 300, 0
    R, T, nb = len(lens), 300, 40
    vals = torch.from_numpy((0.05 * r.standard_normal((R, T, 128, 128))).astype(np.float32)).to(device)
    cols = torch.from_numpy(r.integers(0, nb, (R, T)).astype(np.int32)).to(device)
    lens = torch.from_numpy(lens).to(device)
    src = torch.from_numpy(r.standard_normal((nb * 128, f)).astype(np.float32)).to(device)
    b = torch.from_numpy(r.standard_normal(9 if kind == "af" else f).astype(np.float32)).to(device)
    if kind == "k1":
        vd, zd = dtypes
        v, z = vals.to(vd), src.to(zd)
        pv = poison_padding(v, lens)
        return (lambda: k1.bsr_spmm(pv, cols, lens, z)), k1.bsr_spmm_plain(v, cols, lens, z)
    vd, xd, wd = dtypes
    v = vals.to(vd)
    pv = poison_padding(v, lens)
    if kind == "ff":
        z = src.to(vd)
        return (lambda: fg.ff_aggregate(pv, cols, lens, z, b, True, xd)), fg.ff_aggregate_plain(v, cols, lens, z, b,
                                                                                              True, xd)
    x, w = src.to(xd), (0.2 * torch.from_numpy(r.standard_normal((f, 9)).astype(np.float32))).to(device, wd)
    return (lambda: fg.af_layer(pv, cols, lens, x, w, b, True)), fg.af_layer_plain(v, cols, lens, x, w, b, True)


@pytest.mark.cuda
@pytest.mark.parametrize("inst", RAGGED)
def test_cuda_skewed_table_matches_plain_and_repeats_bit_equal(cuda, inst):
    """A 300-tile block-row split over many blocks: the plain version's
    result (fp32 within TOL of max, K2 bf16 within BF16_CARD_TOL, K1 bf16 ≥
    99 % bit-equal within one bf16 step), finite on NaN padding, and the same
    bits on a second call."""
    call, ref = _skewed_call(inst, cuda)
    out = call()
    again = call()
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and out.dtype == ref.dtype
    assert torch.equal(out, again)
    kind, dtypes = inst
    if kind == "k1" and dtypes[1] == BF16:
        equal, worst = _bf16_rule(out.cpu(), ref.cpu())
        assert equal >= 0.99 and worst <= 2.0 ** -7, (equal, worst)
    else:
        tol = TOL if out.dtype == F32 else BF16_CARD_TOL
        scale = float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("inst", RAGGED)
def test_cuda_ragged_wrappers_do_not_sync(cuda, inst):
    """A wrapper call reads nothing back to the host: under
    ``torch.cuda.set_sync_debug_mode("error")`` it raises on any
    synchronising call."""
    call, _ = _skewed_call(inst, cuda)
    call()                                   # builds and loads the library, reads the occupancy once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k1_bf16_product_workspace_past_the_card_raises(cuda):
    """K1 with a bf16 Z sizes its product workspace from the table's shape
    (R · (T + 1) · 128 · ftp bf16 values); one the card cannot hold raises a
    MemoryError naming it before anything is allocated."""
    R, T = 100_000, 10_000                   # 2.6e13 bytes of workspace; cols is a view of one int
    cols = torch.zeros(1, dtype=torch.int32, device=cuda).expand(R, T)
    lens = torch.zeros(R, dtype=torch.int32, device=cuda)
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(MemoryError, match="product workspace"):
        fg._split_args("k1_bsr_spmm_bf16", cols, lens, 16, 1, 16, cuda)
    assert torch.cuda.memory_allocated(cuda) == before
    keep, _, _ = fg._split_args("k1_bsr_spmm", cols, lens, 16, 1, 16, cuda)     # fp32 Z: no such workspace
    assert keep[3].numel() == 0


# ------------------------------------------------------------------------- K3
K3_TOL = 1e-4              # K3 vs plain on the card: · max |plain| (sums in another order)


def test_fm_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper never runs the plain version: a CPU tensor, a
    float64 one or one of the wrong rank raises, and the tiling refuses an
    empty batch, field or width (the kernel takes any D since its redesign:
    an example wider than the stage is read in place)."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.fm_interaction(torch.zeros(4, 39, 10))
    with pytest.raises(TypeError):
        k3.fm_interaction(torch.zeros(4, 39, 10, dtype=torch.float64))
    with pytest.raises(ValueError):
        k3.fm_interaction(torch.zeros(4, 39))
    for shape in ((0, 39, 10), (4, 0, 10), (4, 39, 0)):
        assert k3.fm_tile(*shape) == (0, False)
    bt, staged = k3.fm_tile(4, 39, 4097)        # past the old kernel's widest D: taken, read in place
    assert bt >= 1 and not staged


K3_SHAPES = [
    pytest.param((512, 39, 10), id="serve_p99"), pytest.param((65_536, 39, 10), id="train_batch"),
    pytest.param((262_144, 39, 10), id="serve_bulk"), pytest.param((1000, 39, 10), id="odd_B"),
    pytest.param((77, 1, 10), id="F1"), pytest.param((33, 40, 400), id="chunked_fields"),
    pytest.param((9, 3, 300), id="D_past_threads"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_cuda_fm_interaction_matches_plain(cuda, shape):
    emb = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32))
    before = k3.LAUNCHES["k3_fm_interaction"]
    out = k3.fm_interaction(emb.to(cuda))
    torch.cuda.synchronize()
    assert k3.LAUNCHES["k3_fm_interaction"] == before + 1 and out.dtype == F32 and out.shape == shape[:1]
    ref = k3.fm_interaction_plain(emb)
    assert float((out.cpu() - ref).abs().max()) <= K3_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_fm_interaction_bf16(cuda):
    emb = torch.from_numpy(np.random.default_rng(5).standard_normal((4099, 39, 10)).astype(np.float32)).to(BF16)
    before = k3.LAUNCHES["k3_fm_interaction_bf16"]
    out = k3.fm_interaction(emb.to(cuda))
    torch.cuda.synchronize()
    assert k3.LAUNCHES["k3_fm_interaction_bf16"] == before + 1 and out.dtype == BF16
    ref = k3.fm_interaction_plain(emb).float()
    assert float((out.cpu().float() - ref).abs().max()) <= BF16_CARD_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [512, 65_536, 262_144])
def test_cuda_fm_interaction_bf16_recsys_shapes(cuda, batch):
    """bf16 at DeepFM's serving, training and bulk batches: fp32 sums
    rounded once, as the plain version does, so within one bf16 step of max
    and at least 99 % of the outputs bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(batch)
    emb = torch.randn((batch, 39, 10), generator=g, device=cuda).to(BF16)
    out, ref = k3.fm_interaction(emb), k3.fm_interaction_plain(emb)
    torch.cuda.synchronize()
    equal, worst = _bf16_rule(out.cpu(), ref.cpu())
    assert out.dtype == BF16 and equal >= 0.99 and worst <= 2.0 ** -7, (equal, worst)


@pytest.mark.cuda
def test_cuda_fm_interaction_backward_matches_gradcheck(cuda):
    """`ops.fm_interaction` on the card: forward through K3, backward the
    analytic gradient, against the CPU in float64, whose backward
    `gradcheck` holds against finite differences."""
    small = torch.from_numpy(np.random.default_rng(6).standard_normal((5, 4, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(fm_interaction, (small,))
    r = np.random.default_rng(7)
    emb = r.standard_normal((1000, 39, 10))
    g = r.standard_normal(1000)
    e64 = torch.from_numpy(emb).requires_grad_(True)
    (want,) = torch.autograd.grad(fm_interaction(e64), e64, torch.from_numpy(g))
    e32 = torch.from_numpy(emb).float().to(cuda).requires_grad_(True)
    before = k3.LAUNCHES["k3_fm_interaction"]
    (got,) = torch.autograd.grad(fm_interaction(e32), e32, torch.from_numpy(g).float().to(cuda))
    assert k3.LAUNCHES["k3_fm_interaction"] == before + 1 and got.dtype == F32
    assert float((got.cpu().double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(TypeError):
        fm_interaction(torch.zeros(4, 3, 2, dtype=torch.float64, device=cuda))


# --------------------------------------------- K2's dense transform and K3 alone
TRANSFORMS = [pytest.param(c, id=sfx.lstrip("_") or "f32") for c, sfx in fg._SUFFIX.items()]


def _transform_case(cuda, combo, seed=0):
    """X at Nell's width (5,414 features, 16 outputs): its 65,792 rows for
    fp32, rank 0's 18,048 of the halo plan for the bf16 instantiations."""
    vd, xd, wd = combo
    rows = 65_792 if xd == F32 else 18_048
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((rows, 5_414), generator=g, device=cuda).to(xd)
    w = (torch.randn((5_414, 16), generator=g, device=cuda) * (2.0 / 5_430) ** 0.5).to(wd)
    return (lambda: fg.ff_transform(x, w, vd)), fg.ff_transform_plain(x, w, vd)


@pytest.mark.cuda
@pytest.mark.parametrize("combo", TRANSFORMS)
def test_cuda_ff_transform_at_nell_width(cuda, combo):
    """Each instantiation against the plain version at Nell's width: fp32
    outputs within 1e-4 of max (chip_smoke's rule: the order of the sum
    differs); all bf16 within one bf16 step of max and at least 99 %
    bit-equal; one launch, and the same bits on a second call."""
    call, ref = _transform_case(cuda, combo)
    name = f"k2_ff_transform{fg._SUFFIX[combo]}"
    before = fg.LAUNCHES[name]
    out, again = call(), call()
    torch.cuda.synchronize()
    assert fg.LAUNCHES[name] == before + 2 and out.dtype == ref.dtype and torch.equal(out, again)
    if out.dtype == BF16:
        equal, worst = _bf16_rule(out.cpu(), ref.cpu())
        assert equal >= 0.99 and worst <= 2.0 ** -7, (equal, worst)
    else:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(100, 37, 7), (130, 141, 33), (1000, 1, 16), (4096, 5_415, 16)])
@pytest.mark.parametrize("combo", TRANSFORMS)
def test_cuda_ff_transform_edges(cuda, combo, m, k, n):
    """Odd K (4-byte pieces in fp32, plain 2-byte copies in bf16), K = 1, a
    short last strip, N < 16 and N = 33 over three blocks in y."""
    vd, xd, wd = combo
    r = np.random.default_rng(m + k + n)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(cuda, xd)
    w = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32)).to(cuda, wd)
    out, ref = fg.ff_transform(x, w, vd), fg.ff_transform_plain(x, w, vd)
    torch.cuda.synchronize()
    tol = 1e-4 if vd == F32 else 2.0 ** -7
    assert float((out.float() - ref.float()).abs().max()) <= tol * float(ref.float().abs().max())


K3_INSTANCES = [pytest.param(F32, id="f32"), pytest.param(BF16, id="bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K3_INSTANCES)
def test_cuda_fm_interaction_repeats_bit_equal(cuda, dtype):
    emb = torch.randn((65_536, 39, 10), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda).to(dtype)
    first, second = k3.fm_interaction(emb), k3.fm_interaction(emb)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("inst", TRANSFORMS + K3_INSTANCES)
def test_cuda_dense_wrappers_do_not_sync(cuda, inst):
    """The transform's and K3's wrappers read nothing back to the host:
    under ``torch.cuda.set_sync_debug_mode("error")`` they raise on any
    synchronising call."""
    if isinstance(inst, tuple):
        call, _ = _transform_case(cuda, inst)
    else:
        emb = torch.randn((65_536, 39, 10), device=cuda).to(inst)
        call = lambda: k3.fm_interaction(emb)  # noqa: E731
    call()                                   # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_dense_kernels_do_not_spill(cuda):
    """No transform instantiation nor K3 body keeps values in local memory,
    and each fits the blocks its grid needs on one SM: the transform's one
    block of 8 warps, K3 at least four tiles of 16 examples."""
    for sfx in fg._SUFFIX.values():
        attr = fg.transform_attributes(f"k2_ff_transform{sfx}")
        assert attr["local_bytes"] == 0 and attr["blocks_per_sm"] >= 1, (sfx, attr)
    for dtype in (F32, BF16):
        attr = k3.kernel_attributes(dtype, 65_536, 39, 10)
        assert attr["local_bytes"] == 0 and attr["blocks_per_sm"] >= 4, (dtype, attr)


# ------------------------------------------------------------------------- K4
K4_TOL = 1e-4              # K4 vs plain on the card: · max |plain| (sums in another order)
GLOBAL = 2 ** 30


def _k4_inputs(cuda, s, d=240, bh=16, bh_kv=8, dtype=F32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((n, s, d), generator=g, device=cuda).to(dtype) for n in (bh, bh_kv, bh_kv))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s,window,causal", [(4096, GLOBAL, True), (4096, 1024, True), (1000, GLOBAL, True),
                                             (40, 1024, True), (300, 0, True), (300, GLOBAL, False),
                                             (300, 24, False)],
                         ids=["global_4096", "local_4096", "odd_1000", "short_40", "window_0",
                              "bidirectional", "bidirectional_window"])
def test_cuda_flash_attention_matches_plain(cuda, s, window, causal):
    """gemma3-12b's attention shape for one sequence (16 query heads over 8
    key/value heads, d = 240): global and local, an odd S, S under one
    tile, window 0 and the bidirectional mask."""
    q, k, v = _k4_inputs(cuda, s, seed=s + window % 97)
    before = k4.LAUNCHES["k4_flash_attention"]
    out = k4.flash_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert k4.LAUNCHES["k4_flash_attention"] == before + 1 and out.dtype == F32 and out.shape == q.shape
    ref = k4.flash_attention_plain(q, k, v, window=window, causal=causal)
    assert float((out - ref).abs().max()) <= K4_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_flash_attention_groups_and_bf16(cuda):
    """Grouping kv heads equals expanding them, bit for bit; bf16 within one
    bf16 step of the largest value and ≥ 99 % bit-equal to the plain
    version's rounding."""
    q, k, v = _k4_inputs(cuda, 1000, seed=3)
    grouped = k4.flash_attention(q, k, v, window=1024)
    expanded = k4.flash_attention(q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0), window=1024)
    assert torch.equal(grouped, expanded)
    qb, kb, vb = (t.to(BF16) for t in (q, k, v))
    out = k4.flash_attention(qb, kb, vb)
    ref = k4.flash_attention_plain(qb, kb, vb)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** -7 * float(ref.float().abs().max())
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(4096, 1024), (1000, GLOBAL)], ids=["local_4096", "odd_1000"])
def test_cuda_flash_attention_bf16_matches_plain(cuda, s, window):
    """The tensor-core body at gemma3-12b's local window and at an odd S:
    within one bf16 step of the largest value and ≥ 99 % bit-equal to the
    plain version, which keeps p in fp32."""
    q, k, v = _k4_inputs(cuda, s, dtype=BF16, seed=s + window % 97)
    before = k4.LAUNCHES["k4_flash_attention_bf16"]
    out = k4.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert k4.LAUNCHES["k4_flash_attention_bf16"] == before + 1 and out.dtype == BF16 and out.shape == q.shape
    ref = k4.flash_attention_plain(q, k, v, window=window)
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** -7 * float(ref.float().abs().max())
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_groups_kv_heads(cuda):
    """The bf16 body reads grouped key/value heads in place: bit-equal to
    the same call on k and v expanded per group."""
    q, k, v = _k4_inputs(cuda, 1000, dtype=BF16, seed=5)
    grouped = k4.flash_attention(q, k, v, window=1024)
    expanded = k4.flash_attention(q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0), window=1024)
    assert torch.equal(grouped, expanded)


@pytest.mark.cuda
def test_cuda_flash_attention_bodies_do_not_spill(cuda):
    """Both bodies keep everything in registers: no local memory per thread,
    at most 255 registers; two bf16 blocks share an SM at d = 240."""
    attrs = {dtype: k4.kernel_attributes(dtype, 240) for dtype in (F32, BF16)}
    assert all(a["local_bytes"] == 0 and a["registers"] <= 255 for a in attrs.values()), attrs
    assert attrs[BF16]["blocks_per_sm"] >= 2 and attrs[F32]["blocks_per_sm"] >= 1, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cuda_flash_attention_refuses_unaligned_inputs(cuda, dtype):
    """cp.async copies 16-byte pieces: a q that does not start on a 16-byte
    boundary raises instead of launching."""
    q, k, v = _k4_inputs(cuda, 64, d=16, bh=2, bh_kv=2, dtype=dtype)
    shifted = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    before = dict(k4.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        k4.flash_attention(shifted, k, v)
    assert k4.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_flash_attention_is_forward_only(cuda):
    """K4 itself is forward only: under autograd `ops.flash_attention`
    launches it once in the forward and none in the backward
    (`flash_attention_vjp`, torch ops), whose gradients equal autograd
    through the plain version; without a gradient it is the bare launch."""
    q, k, v = _k4_inputs(cuda, 300, d=48, bh=4, bh_kv=2)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = k4.LAUNCHES["k4_flash_attention"]
    out = flash_attention(q, k, v, window=24)
    assert k4.LAUNCHES["k4_flash_attention"] == before + 1
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert k4.LAUNCHES["k4_flash_attention"] == before + 1
    want = torch.autograd.grad(k4.flash_attention_plain(q, k, v, window=24), (q, k, v), g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= K4_TOL * float(b.abs().max())
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert k4.LAUNCHES["k4_flash_attention"] == before + 2
    with pytest.raises(ValueError, match="multiple of 4"):
        k4.flash_attention(*(t.detach()[..., :14].contiguous() for t in (q, k, v)))


@pytest.mark.cuda
def test_cuda_prefill_launches_k4_once_per_layer(cuda):
    """gemma3-12b's widths at 6 layers (5 local, 1 global): one K4 launch per
    layer of a prefill, each with its layer's window, and none per decode
    step; the prefill's logits against the plain attention's."""
    import dataclasses

    from repro_torch.configs.gemma3_12b import FULL
    from repro_torch.models.transformer_lm import lm_decode_step, lm_init, lm_init_cache, lm_prefill

    cfg = dataclasses.replace(FULL, n_layers=6)
    params = lm_init(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 1500))).to(cuda)
    with torch.inference_mode():
        k4.reset_launch_counts()
        logits = lm_prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        assert k4.LAUNCHES == {"k4_flash_attention": 6, "k4_flash_attention_bf16": 0}
        assert dict(k4.WINDOWS) == {("k4_flash_attention", 1024): 5, ("k4_flash_attention", GLOBAL): 1}
        ref = lm_prefill(params, tokens, cfg, kernel=k4.flash_attention_plain)
        assert float((logits - ref).abs().max()) <= K4_TOL * float(ref.abs().max())
        k4.reset_launch_counts()
        lm_decode_step(params, lm_init_cache(cfg, 1, 8, device=cuda), tokens[:, 0], 0, cfg)
        torch.cuda.synchronize()
        assert k4.LAUNCHES["k4_flash_attention"] == 0
