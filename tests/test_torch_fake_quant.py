"""The fake-quant kernels (`repro_torch.kernels.fake_quant`) against their
plain version, the PyTorch ops of `core/quant.py`.

On the CPU: `select_mirror` (tests/_fake_quant_mirror.py), the numpy
mirror of the kernels' digit schedule (zeros never counted, the bin chosen from the top, the scratch
buffer read where the keys fitted it and x again where they did not),
against `np.partition` on sparse, tie-heavy and NaN inputs; the wrapper's
refusals; and the dispatch (CPU and meta tensors take the ops, launch
nothing). The tests marked ``cuda`` hold the kernels against the ops on the
card bit for bit (max |difference| 0, NaN where the ops give NaN) in fp32
and bf16, the straight-through gradient, the launch count and the absence
of any host synchronisation; they skip without a card. This file imports
no JAX (the CPU comparison with the JAX package is in
tests/test_torch_quant.py), so on the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_fake_quant.py
"""
import math

import numpy as np
import pytest
import torch

import _fake_quant_mirror as mirror
from repro_torch.core.quant import fake_quant
from repro_torch.kernels import fake_quant as fqk
from repro_torch.kernels import launch_counts

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------ the mirror
def _kth_largest_key(keys: np.ndarray, k: int) -> int:
    flat = np.asarray(keys, np.uint32).reshape(-1)
    return int(np.partition(flat, flat.size - k)[flat.size - k])


def _mirror_inputs():
    r = np.random.default_rng(11)
    sparse = np.zeros((300, 541), np.float32)                        # 32 ones a row, a few other values
    for row in sparse:
        row[r.choice(541, 32, replace=False)] = 1.0
    sparse[r.integers(0, 300, 40), r.integers(0, 541, 40)] = r.standard_normal(40).astype(np.float32)
    ties = np.where(r.random(20_000) < 0.8, 1.0, -1.0).astype(np.float32)
    ties[:50] = r.standard_normal(50)
    nan = r.standard_normal(5_000).astype(np.float32)
    nan[r.integers(0, 5_000, 30)] = np.nan
    nan[:4] = [np.inf, -np.inf, -0.0, 1e-42]
    bf16 = torch.from_numpy(r.standard_normal(3_000).astype(np.float32) * 10).to(BF16)
    bf16_bits = bf16.view(torch.int16).numpy().view(np.uint16).copy()
    bf16_bits[:20] = 0x3F80                                          # ties at 1.0
    bf16_bits[20:25] = 0x7FC1                                        # NaN
    return {"sparse": sparse, "ties": ties, "nan": nan, "bf16": bf16_bits}


MIRROR = _mirror_inputs()


@pytest.mark.parametrize("percentile", [99.9, 99.0, 50.0, 0.0])
@pytest.mark.parametrize("name", sorted(MIRROR))
def test_mirror_selects_the_kth_largest_key(name, percentile):
    """The schedule's statistic is the k-th largest magnitude key (NaN
    above inf, zeros below all) for any buffer: all keys fit, only the
    chosen bin fits, nothing fits."""
    keys, kb = mirror.magnitude_keys(MIRROR[name])
    k = fqk.rank_k(keys.size, percentile)
    want = _kth_largest_key(keys, k)
    for cap in (keys.size, fqk.scratch_capacity(keys.size), 64, 0):
        assert mirror.select_mirror(keys, k, kb, cap)[0] == want


def test_mirror_skips_zeros_and_reads_x_once_where_the_keys_fit():
    """Nell's shape in small: 99.4 % zeros. At 99.9 the statistic is 1.0
    among the nonzero keys, read from x once and from the buffer after;
    at 50 it is a zero, found after one pass without a digit chosen."""
    keys, kb = mirror.magnitude_keys(MIRROR["sparse"])
    n, nz = keys.size, int(np.count_nonzero(keys))
    assert nz < n // 10
    key, reads = mirror.select_mirror(keys, fqk.rank_k(n, 99.9), kb, fqk.scratch_capacity(n))
    assert key == 0x3F800000 and reads == ["x", "scratch", "scratch"]
    assert mirror.select_mirror(keys, fqk.rank_k(n, 50.0), kb, fqk.scratch_capacity(n)) == (0, ["x"])


def test_mirror_falls_back_to_x_when_the_buffer_is_too_small():
    """The buffer too small for the first pass's keys: the second pass reads
    x again and copies only the chosen bin, which the third reads from the
    buffer; too small for that bin too (ties: 16,000 ones), every pass
    reads x."""
    keys, kb = mirror.magnitude_keys(MIRROR["sparse"])
    k = fqk.rank_k(keys.size, 99.9)
    nz = int(np.count_nonzero(keys))
    assert mirror.select_mirror(keys, k, kb, nz - 1)[1] == ["x", "x", "scratch"]
    keys, kb = mirror.magnitude_keys(MIRROR["ties"])
    assert mirror.select_mirror(keys, fqk.rank_k(keys.size, 99.9), kb, 1_000)[1] == ["x", "x", "x"]


def test_mirror_bf16_takes_two_digits():
    keys, kb = mirror.magnitude_keys(MIRROR["bf16"])
    assert kb == 15 and fqk.digit_passes(kb) == 2
    assert [mirror.digit_width(kb, p) for p in range(2)] == [11, 4]
    assert [mirror.digit_width(31, p) for p in range(3)] == [11, 10, 10]
    k = fqk.rank_k(keys.size, 0.0)
    assert k == keys.size and mirror.select_mirror(keys, k, kb, keys.size)[0] == int(keys.min())


@pytest.mark.parametrize("n", [1, 37, 999, 1_000, 1_001, 356_000_000])
@pytest.mark.parametrize("percentile", [99.9, 0.0, 100.0])
def test_rank_k_is_the_nearest_rank(n, percentile):
    """k = 1 below 1,000 elements at 99.9, k = n at 0, and within [1, n]."""
    k = fqk.rank_k(n, percentile)
    assert k == min(n, max(1, n - math.ceil(percentile / 100.0 * n) + 1))
    assert 1 <= k <= n and (percentile != 99.9 or n >= 1_000 or k == 1)


# ----------------------------------------------------- the wrapper on the CPU
def test_kernel_wrapper_refuses_cpu_and_other_dtypes():
    with pytest.raises(ValueError, match="CUDA"):
        fqk.fake_quant(torch.ones(8), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fqk.fake_quant(torch.ones(8, dtype=torch.float64), 4)


@pytest.mark.parametrize("percentile", [None, 99.9])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cpu_and_meta_take_the_plain_ops(dtype, percentile):
    """CPU tensors get `fake_quant_plain`'s bits and launch nothing; meta
    tensors (the dry run) keep their shape through the same ops."""
    x = torch.from_numpy(MIRROR["sparse"][:40]).to(dtype)
    before = launch_counts()
    out = fake_quant(x, 4, percentile=percentile)
    assert torch.equal(out, fqk.fake_quant_plain(x, 4, percentile))
    meta = fake_quant(torch.empty(300, 541, dtype=dtype, device="meta"), 4, percentile=percentile)
    assert meta.device.type == "meta" and meta.shape == (300, 541) and meta.dtype == dtype
    assert launch_counts() == before


# ----------------------------------------------------------------- the card
NELL = (65_755, 5_414)


def _sparse_x(device, dtype, rows=NELL[0], cols=NELL[1], seed=0):
    """Nell's features in shape: 32 ones a row at seeded columns."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.zeros(rows, cols, dtype=dtype, device=device)
    idx = torch.rand(rows, cols, generator=g, device=device).topk(32, dim=1).indices
    return x.scatter_(1, idx, 1.0)


def _card_case(name, device, dtype):
    g = torch.Generator(device=device).manual_seed(3)
    randn = lambda *s: torch.randn(*s, generator=g, device=device)   # noqa: E731
    if name == "nell_x":
        return _sparse_x(device, dtype)
    if name == "nell_h":
        return torch.relu(randn(NELL[0], 16)).to(dtype)
    if name == "w1":
        return (0.05 * randn(NELL[1], 16)).to(dtype)
    if name == "w2":
        return (0.3 * randn(16, 210)).to(dtype)
    if name == "ties":                       # 40 M elements, 90 % exact ±1.0: the chosen bin overflows the buffer
        t = torch.where(torch.rand(40_000_000, generator=g, device=device) < 0.9, 1.0, -1.0)
        t[:1000] = randn(1000)
        return t.to(dtype)
    if name == "zeros":
        return torch.zeros(70_001, dtype=dtype, device=device)
    if name == "small":                      # n < 1,000: k = 1 at 99.9
        return randn(999).to(dtype)
    if name == "special":                    # negatives, −0.0, subnormals, inf, NaN
        t = randn(100_003)
        t[:9] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 1e-40, -3e-42, 1.2e-38, -7.5, -1e-45])
        t[5000:5010] = float("nan")
        return t.to(dtype)
    if name == "tiny":                       # subnormal amax: the scale rounds to 0
        t = torch.zeros(1_001, device=device)
        small = 1.4e-45 if dtype == F32 else 2.0**-133        # the least subnormal of the type
        t[::7], t[3::7] = small, -2 * small
        return t.to(dtype)
    raise KeyError(name)


CARD_CASES = ["nell_x", "nell_h", "w1", "w2", "ties", "zeros", "small", "special", "tiny"]


def _same_bits(out, ref):
    """max |out − ref| is 0 and NaN lies where the ops put it; the bits are
    the same (signed zeros too) wherever ref is not NaN."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    if (~nan).any():
        assert float((out[~nan].float() - ref[~nan].float()).abs().max()) == 0.0
    view = torch.int32 if out.dtype == F32 else torch.int16
    assert torch.equal(out[~nan].view(view), ref[~nan].view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("percentile", [None, 99.9, 0.0], ids=["max", "p99.9", "k_eq_n"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", CARD_CASES)
def test_cuda_fake_quant_same_bits_as_the_ops(cuda, name, dtype, percentile):
    x = _card_case(name, cuda, dtype)
    out = fqk.fake_quant(x, 4, percentile)
    ref = fqk.fake_quant_plain(x, 4, percentile)
    torch.cuda.synchronize()
    _same_bits(out, ref)
    # The dispatch in core/quant.py takes the kernel on the card.
    _same_bits(fake_quant(x, 4, percentile=percentile), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cuda_fake_quant_bits_and_unaligned_start(cuda, dtype, bits):
    """2 and 8 bits; a view starting one element in (not 16-byte aligned)."""
    base = _card_case("nell_h", cuda, dtype).reshape(-1)
    x = base[1:300_001]
    for percentile in (None, 99.9):
        _same_bits(fqk.fake_quant(x, bits, percentile), fqk.fake_quant_plain(x, bits, percentile))


@pytest.mark.cuda
def test_cuda_fake_quant_scale_matches_the_ops_over_many_magnitudes(cuda):
    """The scale (amax times the fp32 reciprocal of qmax, as the ops compute
    amax / qmax on the card) over 2,000 tensors whose amax spans 2⁻²⁰–2²⁰."""
    g = torch.Generator(device=cuda).manual_seed(5)
    amax = torch.exp2(torch.rand(2000, generator=g, device=cuda) * 40 - 20)
    for dtype in (F32, BF16):
        for a in amax[:1000 if dtype == F32 else 200].tolist():
            x = torch.tensor([a, -a / 3, a / 7, 0.0], device=cuda).to(dtype)
            _, state = fqk._launch(x, 4, None)
            ref_scale = torch.where(x.abs().max() > 0, x.abs().max() / 7.0, torch.ones((), dtype=dtype,
                                                                                         device=cuda))
            bits = int(state[1].item()) & (0xFFFFFFFF if dtype == F32 else 0xFFFF)
            want = int(ref_scale.view(torch.int32 if dtype == F32 else torch.int16).item())
            assert bits == want & (0xFFFFFFFF if dtype == F32 else 0xFFFF), (dtype, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cuda_fake_quant_straight_through_gradient(cuda, dtype):
    x = _card_case("nell_h", cuda, dtype)[:4096].clone().requires_grad_()
    w = _card_case("w2", cuda, dtype).clone().requires_grad_()
    (fake_quant(x, 4, percentile=99.9).float().sum() + fake_quant(w, 4).float().sum()).backward()
    assert torch.equal(x.grad, torch.ones_like(x)) and torch.equal(w.grad, torch.ones_like(w))


@pytest.mark.cuda
def test_cuda_fake_quant_counts_its_launches(cuda):
    x = _card_case("nell_h", cuda, F32)
    fqk.reset_launch_counts()
    fake_quant(x, 4, percentile=99.9)
    fake_quant(x.to(BF16), 4)
    assert fqk.LAUNCHES == {"fq_max_pass": 0, "fq_select_pass": 3, "fq_quantize": 1,
                            "fq_max_pass_bf16": 1, "fq_select_pass_bf16": 0, "fq_quantize_bf16": 1}
    assert launch_counts()["fq_select_pass"] == 3


@pytest.mark.cuda
def test_cuda_fake_quant_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fake_quant(torch.ones(16, dtype=torch.float64, device=cuda), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fake_quant(torch.ones(16, dtype=torch.float16, device=cuda), 4, percentile=99.9)


@pytest.mark.cuda
@pytest.mark.parametrize("percentile", [None, 99.9])
def test_cuda_fake_quant_does_not_sync(cuda, percentile):
    """A call reads nothing back to the host: under
    ``torch.cuda.set_sync_debug_mode("error")`` it raises on any
    synchronising call."""
    x = _card_case("nell_h", cuda, F32).requires_grad_()
    fake_quant(x, 4, percentile=percentile)          # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fake_quant(x, 4, percentile=percentile).sum().backward()
        fake_quant(x.detach().to(BF16), 4, percentile=percentile)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
