"""The port's flash attention (K4's plain version and wrapper) against the
JAX package's, on the CPU.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs
`flash_attention_plain`. Same numpy inputs into both packages, held against
the reference's `repro.kernels.ops.flash_attention` (Pallas in interpret
mode, tests/test_kernels.py:268-304) and `repro.kernels.ref.flash_attention_ref`
at the reference suite's tolerances: 2e-5 in fp32, 2e-2 for bf16 inputs
against the fp32 oracle. The Pallas kernel asserts ``S % 64 == 0`` at these
tiles, so an S that is not a multiple of 64 is held against the oracle
only. The CUDA kernel itself runs on the card (tests/test_torch_kernels.py)
and, through the g++ shim, on the CPU (tests/test_torch_kernel_emulation.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain, k_tiles
from repro_torch.kernels.ref import flash_attention_ref

TOL = 2e-5
BF16_TOL = 2e-2
GLOBAL = 2 ** 30


def _qkv(bh, s, d, seed, bh_kv=None):
    r = np.random.default_rng(seed)
    q = r.standard_normal((bh, s, d)).astype(np.float32)
    k, v = (r.standard_normal((bh_kv or bh, s, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _jax(fn, q, k, v, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v)), **kw), dtype=np.float32)


def _port(fn, q, k, v, dtype=torch.float32, **kw):
    return fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw).float().numpy()


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,d,window", [(128, 64, None), (256, 64, 48), (128, 128, 16), (128, 240, None),
                                        (128, 240, 24), (128, 64, 0)])
def test_plain_matches_pallas_and_oracle(s, d, window):
    """The reference's three cases, gemma3's head width 240 (global and a
    window), and window 0 (no valid key: every row averages v)."""
    q, k, v = _qkv(2, s, d, seed=s + d + (window or 0))
    out = _port(ops.flash_attention, q, k, v, window=window)
    _close(out, _jax(j_ops.flash_attention, q, k, v, window=window, bq=64, bk=64))
    _close(out, _jax(j_ref.flash_attention_ref, q, k, v, window=window))


@pytest.mark.parametrize("window", [None, 20])
def test_plain_bidirectional_matches_pallas(window):
    q, k, v = _qkv(2, 128, 64, seed=5)
    out = _port(ops.flash_attention, q, k, v, window=window, causal=False)
    _close(out, _jax(j_ops.flash_attention, q, k, v, window=window, causal=False, bq=64, bk=64))
    _close(out, _jax(j_ref.flash_attention_ref, q, k, v, window=window, causal=False))


def test_plain_window_zero_averages_v():
    q, k, v = _qkv(2, 64, 16, seed=6)
    out = _port(ops.flash_attention, q, k, v, window=0)
    _close(out, np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape))


def test_plain_bf16_matches_fp32_oracle():
    """tests/test_kernels.py::test_flash_bf16: bf16 inputs, fp32 inside,
    bf16 out, within 2e-2 of the fp32 oracle on the same (rounded) values;
    and the Pallas kernel's bf16 output."""
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32) for a in _qkv(2, 128, 64, seed=7))
    out = _port(ops.flash_attention, q, k, v, dtype=torch.bfloat16)
    _close(out, _jax(j_ref.flash_attention_ref, q, k, v), BF16_TOL)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    _close(out, np.asarray(j_ops.flash_attention(jq, jk, jv, bq=64, bk=64), np.float32), BF16_TOL)
    assert ops.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v))).dtype == torch.bfloat16


@pytest.mark.parametrize("s,window", [(1, None), (100, None), (130, 9), (63, 0)])
def test_plain_any_length_matches_oracle(s, window):
    """S that the Pallas kernel's tiles do not divide: against the oracle."""
    q, k, v = _qkv(3, s, 48, seed=s)
    _close(_port(ops.flash_attention, q, k, v, window=window),
           _jax(j_ref.flash_attention_ref, q, k, v, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oracle_twin_matches_jax_oracle(dtype):
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32) for a in _qkv(2, 96, 32, seed=8))
    out = _port(flash_attention_ref, q, k, v, dtype=dtype, window=16)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(j_ref.flash_attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)), window=16), np.float32)
    _close(out, ref, TOL if dtype == torch.float32 else BF16_TOL)


def test_plain_groups_kv_heads():
    """Grouped-query attention: query row b·H + h reads key/value row
    b·Hk + h // G, as the reference's `_chunked_attention` groups; equal to
    k and v expanded per group."""
    q, k, v = _qkv(8, 70, 16, seed=9, bh_kv=4)
    out = _port(ops.flash_attention, q, k, v, window=12)
    expanded = _port(ops.flash_attention, q, np.repeat(k, 2, 0), np.repeat(v, 2, 0), window=12)
    np.testing.assert_array_equal(out, expanded)
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(*(torch.from_numpy(a) for a in _qkv(6, 8, 16, seed=0, bh_kv=4)))


def test_plain_is_forward_only_on_the_card_only():
    """A call that records a gradient goes through `ops._FlashAttention`
    (the plain forward here, K4 on the card) whose backward is
    `flash_attention_vjp`, the same code on both devices: its gradients
    equal autograd through the plain version; without a gradient the call
    is the bare forward."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(4, 8, 16, seed=1, bh_kv=2))
    out = ops.flash_attention(q, k, v, window=3)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(flash_attention_plain(q, k, v, window=3), (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL * float(b.abs().max()))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 8, 16, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="one dtype"):
        k4.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="BH/G"):
        k4.flash_attention(q, k[:, :4], v)
    k4.reset_launch_counts()
    assert k4.LAUNCHES == {"k4_flash_attention": 0, "k4_flash_attention_bf16": 0} and not k4.WINDOWS


def test_k_tiles_skip_only_fully_masked_tiles():
    """For each body's tiling (fp32 and bf16), the k-tiles a block visits
    hold every valid pair of its q-tile (so a skipped tile is fully masked),
    and the skip is what the source note says at gemma3's prefill_32k shape:
    half of a global layer's tiles, and a local layer's window plus one
    q-tile and one k-tile per q-tile."""
    for dtype in (torch.float32, torch.bfloat16):
        bq, bk = k4.K4_BLOCK_ROWS[dtype], k4.K4_TILE_KEYS[dtype]
        S = 300
        pos = np.arange(S)
        for window in (GLOBAL, 40, 1):
            valid = (pos[None, :] > pos[:, None] - window) & (pos[None, :] <= pos[:, None])
            for q0 in range(0, S, bq):
                rows = valid[q0:q0 + bq]
                need = {j // bk for j in np.flatnonzero(rows.any(axis=0))}
                visited = set(k_tiles(q0, S, window, True, dtype))
                assert need <= visited and len(visited) <= len(need) + 1
        for window in (0, -5):
            assert list(k_tiles(64, S, window, True, dtype)) == list(range(-(-S // bk)))
        assert list(k_tiles(64, S, 8, False, dtype)) == list(range(-(-S // bk)))
        S, n_q = 32_768, 32_768 // bq
        full = n_q * (S // bk)
        glob = sum(len(k_tiles(q0 * bq, S, GLOBAL, True, dtype)) for q0 in range(n_q))
        local = sum(len(k_tiles(q0 * bq, S, 1024, True, dtype)) for q0 in range(n_q))
        assert 0.49 < glob / full < 0.51 and local / full < (1024 + bq + bk) / S


def test_flash_attention_plain_matches_the_model_attention():
    """tests/test_kernels.py::test_flash_matches_model_attention: the plain
    version on (B·H, S, d) equals the reference's `_chunked_attention` on
    (B, S, H, d) at 3e-5."""
    from repro.nn.attention import _chunked_attention

    r = np.random.default_rng(10)
    q, k, v = (r.standard_normal((2, 128, 4, 64)).astype(np.float32) for _ in range(3))
    model = np.asarray(_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(128), 32,
                                          chunk=64))
    flat = [torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(8, 128, 64).copy()) for a in (q, k, v)]
    out = ops.flash_attention(*flat, window=32).reshape(2, 4, 128, 64).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(out, model, rtol=3e-5, atol=3e-5)
