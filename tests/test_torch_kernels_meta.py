"""K1–K4 on the meta device and under ``FlopCounterMode``.

Each kernel's entry is a `torch.library` custom op (`repro_torch.kernels.ops`)
with a fake implementation and a FLOP formula over its table's shape, so
the dry run (`repro_torch.launch.dryrun`) traces a step on meta tensors and
counts the same work the card runs. Here: each wrapper gives the plain
version's shape and dtype on meta, its formula gives the stated count on
meta, on the CPU (the plain version runs inside the op, which counts as one
operation) and — the ``cuda`` tests, skipped without a card — on the card;
the blocked-transpose backward counts alike; a device other than CPU,
CUDA and meta still raises.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.graph.structure import blocked_adjacency
from repro_torch.kernels.ops import bsr_spmm, flash_attention, fm_interaction, fused_gcn_layer, kernel_flops


def _table(n=300, e=1500, seed=0):
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    return blocked_adjacency(n, ei, r.standard_normal(e).astype(np.float32))


def _flops(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kw)
    return out, fc.get_total_flops()


def _k1_args(device, f=24):
    vals, cols, lens = _table().arrays(device="cpu")
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((300, f)).astype(np.float32))
    return [t.to(device) for t in (vals, cols, lens, z)]


def _k2_args(device, d_in=50, d_out=7):
    vals, cols, lens = _table().arrays(device="cpu")
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((300, d_in)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((d_in, d_out)) * 0.2).astype(np.float32))
    b = torch.from_numpy(r.standard_normal(d_out).astype(np.float32))
    return [t.to(device) for t in (vals, cols, lens, x, w, b)]


def _attn_args(device, bh=4, s=40, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    return [torch.randn((bh, s, d), generator=g).to(device, dtype) for _ in range(3)]


def _meta(args):
    return [torch.empty_like(a, device="meta") for a in args]


def test_formulas_state_their_counts():
    """The formulas in closed form on a small shape."""
    assert kernel_flops("k1_bsr_spmm", (3, 5, 128, 128), (384, 16)) == 2 * 3 * 5 * 128 * 128 * 16
    assert kernel_flops("k2_fused_gcn_layer", (3, 5, 128, 128), (384, 50), (50, 7)) == (
        2 * 384 * 50 * 7 + 2 * 3 * 5 * 128 * 128 * 7)
    assert kernel_flops("k2_fused_gcn_layer", (3, 5, 128, 128), (384, 50), (50, 7), order="aggregation_first") == (
        2 * 3 * 5 * 128 * 128 * 50 + 2 * 3 * 128 * 50 * 7)
    assert kernel_flops("k3_fm_interaction", (8, 39, 10)) == 3 * 8 * 39 * 10 + 3 * 8 * 10
    # S = 40 is one fp32 q-tile (128 rows) over two k-tiles (32 keys): causal, every key up to row 39.
    assert kernel_flops("k4_flash_attention", (4, 40, 16)) == 4 * 4 * 16 * 40 * 40
    # bf16: q-tiles of 64 rows, k-tiles of 64 keys; S = 256, window 64: q-tile i visits k-tiles i − 1 and i.
    assert kernel_flops("k4_flash_attention", (2, 256, 16), window=64, dtype=torch.bfloat16) == (
        4 * 2 * 16 * (64 * 64 + 3 * 64 * 128))
    with pytest.raises(KeyError):
        kernel_flops("k5", (1,))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k1_shape_and_flops(device):
    vals, cols, lens, z = args = _k1_args("cpu")
    if device == "meta":
        args = _meta(args)
    out, flops = _flops(bsr_spmm, args[0], args[1], args[3], lens=args[2])
    ref = bsr_spmm(vals, cols, z, lens=lens)
    assert out.device.type == device and out.shape == ref.shape and out.dtype == ref.dtype
    assert flops == kernel_flops("k1_bsr_spmm", vals.shape, z.shape)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("order", ["feature_first", "aggregation_first"])
def test_k2_shape_and_flops(device, order):
    args = _k2_args("cpu")
    ref = fused_gcn_layer(*args, order=order)
    run = _meta(args) if device == "meta" else args
    out, flops = _flops(fused_gcn_layer, *run, order=order)
    assert out.device.type == device and out.shape == ref.shape and out.dtype == ref.dtype
    vals, x, w = args[0], args[3], args[4]
    padded = (x.shape[0] + 127) // 128 * 128
    assert flops == kernel_flops("k2_fused_gcn_layer", vals.shape, (padded, x.shape[1]), w.shape, order=order)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_shape_and_flops(device, dtype):
    emb = torch.randn((12, 39, 10), generator=torch.Generator().manual_seed(4)).to(dtype)
    ref = fm_interaction(emb)
    out, flops = _flops(fm_interaction, emb.to(device))
    assert out.device.type == device and out.shape == ref.shape == (12,) and out.dtype == ref.dtype
    assert flops == kernel_flops("k3_fm_interaction", emb.shape)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("window", [None, 8])
def test_k4_shape_and_flops(device, window):
    q, k, v = _attn_args("cpu")
    k, v = k[:2], v[:2]                                  # 2 query heads per key / value head
    ref = flash_attention(q, k, v, window=window)
    out, flops = _flops(flash_attention, *[t.to(device) for t in (q, k, v)], window=window)
    assert out.device.type == device and out.shape == ref.shape and out.dtype == ref.dtype
    assert flops == kernel_flops("k4_flash_attention", q.shape, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_flops_follow_the_visited_tiles(dtype):
    """K4's count is the (query, key) pairs of the k-tiles its body visits:
    a window cuts it to about S·window, the causal mask to about half."""
    bh, S, d = 8, 4096, 128

    def count(**kw):
        return kernel_flops("k4_flash_attention", (bh, S, d), dtype=dtype, **kw)

    full = 4 * bh * d * S * S
    assert count(causal=False) == full
    assert count(window=8, causal=False) == full                   # without the causal mask every tile is visited
    assert 0.5 * full < count() < 0.52 * full                      # causal: the lower triangle and its diagonal tiles
    local = count(window=1024)
    assert (S - 1024) * 1024 < local / (4 * bh * d) < (1024 + 2 * 128) * S   # the window, at most a tile each side
    assert count(window=8) < local < count()
    assert count(window=S) == count() == count(window=10 * S)      # a window of S or more is global


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_blocked_backward_counts_over_the_table(device):
    """K1's gradient: dz by the blocked-transpose apply (one custom op,
    counted over the table like K1), the same on meta and on the CPU."""
    vals, cols, lens, z = _k1_args("cpu")
    if device == "meta":
        vals, cols, lens, z = _meta([vals, cols, lens, z])
    z = z.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        out = bsr_spmm(vals, cols, z, lens=lens)
        (gz,) = torch.autograd.grad(out.sum(), z)
    assert gz.shape == z.shape and gz.device.type == device
    padded = (vals.shape[0] * vals.shape[2], z.shape[1])
    assert fc.get_total_flops() == 2 * kernel_flops("k1_bsr_spmm", vals.shape, padded)


def test_other_devices_still_raise():
    from repro_torch.kernels import ops

    with pytest.raises(ValueError, match="no kernel for device"):
        ops._on_device("bsr_spmm", None, None, torch.empty(1, device="meta"))


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_k1_flops_equal_meta(cuda):
    args = _k1_args(cuda)
    _, on_card = _flops(bsr_spmm, args[0], args[1], args[3], lens=args[2])
    meta = _meta(args)
    _, on_meta = _flops(bsr_spmm, meta[0], meta[1], meta[3], lens=meta[2])
    assert on_card == on_meta == kernel_flops("k1_bsr_spmm", args[0].shape, args[3].shape)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["feature_first", "aggregation_first"])
def test_cuda_k2_flops_equal_meta(cuda, order):
    args = _k2_args(cuda)
    out, on_card = _flops(fused_gcn_layer, *args, order=order)
    _, on_meta = _flops(fused_gcn_layer, *_meta(args), order=order)
    assert on_card == on_meta and out.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k3_flops_equal_meta(cuda, dtype):
    emb = torch.randn((512, 39, 10), device=cuda).to(dtype)
    _, on_card = _flops(fm_interaction, emb)
    _, on_meta = _flops(fm_interaction, emb.to("meta"))
    assert on_card == on_meta == kernel_flops("k3_fm_interaction", emb.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k4_flops_equal_meta(cuda, dtype):
    q, k, v = _attn_args(cuda, s=300, d=64, dtype=dtype)
    _, on_card = _flops(flash_attention, q, k, v, window=64)
    _, on_meta = _flops(flash_attention, *[t.to("meta") for t in (q, k, v)], window=64)
    assert on_card == on_meta == kernel_flops("k4_flash_attention", q.shape, window=64, dtype=dtype)


@pytest.mark.cuda
def test_cuda_blocked_backward_flops_equal_meta(cuda):
    counts = []
    for dev in (cuda, "meta"):
        vals, cols, lens, z = _k1_args("cpu")
        vals, cols, lens, z = [t.to(dev) for t in (vals, cols, lens, z)]
        z.requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            torch.autograd.grad(bsr_spmm(vals, cols, z, lens=lens).sum(), z)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1]
