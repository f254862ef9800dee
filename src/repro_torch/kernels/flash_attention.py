"""The LM's flash attention on Hopper (K4), with its plain version — twin of
`repro.kernels.flash_attention`.

    out[bh] = softmax((q[bh] · k[bh // G]ᵀ) · d^-0.5, masked) · v[bh // G]

over q (BH, S, d) and k, v (BH / G, S, d), fp32 or bf16: a pair (i, j) is
valid when ``j > i − window`` and, when causal, ``j ≤ i``; a masked score is
−1e30 (not −∞), so a row with no valid key averages v over all S keys. Scores,
softmax and the product with v are fp32 (in bf16, p enters the product as
two bf16 terms, see below); the output has q's dtype. The CUDA source is
``csrc/flash_attention_kernels.cuh`` (the two kernel bodies),
``csrc/ptx.cuh`` (the PTX instructions they use, shared with K2 and K3) and
``csrc/flash_attention.cu`` (launchers).

Source note
-----------
**Replaces** ``src/repro/kernels/flash_attention.py::flash_attention_pallas``
(def line 70, body ``_kernel`` line 31, ``pallas_call`` line 90).

**What bounds it on the H100: operations**, 4·d per valid pair against
4·d·sizeof(T) bytes per row read once. At gemma3-12b's d = 240 and S = 4,096,
16 heads, the 1.29·10¹¹ operations of a causal layer take 1.92 ms at the CUDA
cores' 67 TFLOP/s in fp32 (its 126 MB 0.038 ms at 3.35 TB/s), and 0.130 ms
at the tensor cores' 989 TFLOP/s in bf16 (a local layer's 5.64·10¹⁰, 0.057 ms,
against 0.038 ms of bytes). The two modes are two kernel bodies
(``csrc/flash_attention_kernels.cuh``), and tile differently
(`K4_BLOCK_ROWS`, `K4_TILE_KEYS`, `k4_smem_bytes` and `k_tiles` take the
dtype):

* **bf16: the tensor cores** (``mma.sync`` m16n8k16, fp32 accumulators,
  operands by ``ldmatrix``; one instantiation per head width in steps of 16,
  so the accumulator holds exactly the head's columns). What bounds it there
  is the rate of ``mma.sync`` and the shared memory that feeds it: every warp
  reads each K and V tile. 4 warps of 16 query rows (64 a block, two blocks
  an SM) take 64-key tiles; Q·Kᵀ is 15 k-steps of 16 at d = 240, P·V 30
  n-tiles of 8 whose fp32 accumulator stays in registers. The reference keeps
  p in fp32 (``_kernel``, lines 38-59), and rounding p to one bf16 before P·V
  leaves ~60 % of the outputs bit-equal to that result; so P·V carries p as
  two bf16 fragments, P_hi + P_lo, in two products into one fp32 sum (~99.7 %
  bit-equal, at 1.5× the product work of a one-fragment design), and the row
  sum is taken on the fp32 p.
* **fp32: IEEE fp32 on the CUDA cores** (no TF32: fp32 means IEEE fp32).
  What bounds it there is shared-memory reads per FMA. 8 warps of 16 query
  rows (128 a block) take 32-key tiles; each lane scores a 4 × 4 tile (64
  FMAs per eight 16-byte reads) and accumulates 4 rows × 32 columns of the
  output (128 FMAs per nine reads, all issued before the FMAs). With Q
  resident (122 KB at 128 rows of d = 240) one block fills an SM.

Both: each warp's rows stay in its registers end to end (m, l, scores,
accumulator), the softmax runs on the lanes that hold a row with warp
shuffles, K and V arrive by ``cp.async`` so that V_j's copy overlaps Q·K_jᵀ
and K_{j+1}'s overlaps P·V_j (two barriers per k-tile), only tiles on the
diagonal, the window's edge or the ragged end test each element, and the
heaviest q-tiles run first. It takes any S (the reference asserts
``S % bq == 0``): rows past S are zero-filled, and keys past S get p = 0.
When causal and window ≥ 1 it skips the k-tiles in which every pair of its
q-tile is masked; each row then has its own key as a valid one, so every
skipped term is exactly 0 or is exactly zeroed by the first valid key's
rescale ``exp(−1e30 − m) = 0``. The result differs from visiting every tile
only when a masked key's k or v holds NaN or ∞. With window < 1, or when not
causal, every k-tile is visited. `kernel_attributes` reports the registers,
the local memory (spills) and the blocks per SM the compiler gave each body.

**Grouped-query attention.** k and v may have BH / G rows for G query heads
per key/value head: the launcher takes G, and query row ``b·H + h`` reads
key/value row ``(b·H + h) // G = b·Hk + h // G``, the reference's grouping
(`repro.nn.attention`, ``h // G``), without copying k and v per group.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs
`flash_attention_plain`; on CUDA tensors it runs `flash_attention` here or
raises. The wrapper adds one to its launcher's entry of ``LAUNCHES``
(``k4_flash_attention``, ``k4_flash_attention_bf16``) where it launches, and
to ``WINDOWS[(name, window)]`` beside it.

**The gradient.** The reference's K4 has no VJP and no backward kernel: its
models differentiate ``_chunked_attention``. `flash_attention_vjp` is the
gradient of the function K4 computes, in plain torch ops that run the same
on both devices: it recomputes P from q and k with the kernel's mask,
in blocks of key/value heads and query rows so that no more than
``VJP_SCORE_BYTES`` of scores live at once, and launches no K4 (so
``LAUNCHES`` and ``WINDOWS`` count forwards only).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels._build import library

__all__ = ["LAUNCHES", "WINDOWS", "reset_launch_counts", "K4_BLOCK_ROWS", "K4_TILE_KEYS", "K4_THREADS",
           "K4_MAX_D", "k4_smem_bytes", "k_tiles", "kernel_attributes", "flash_attention", "flash_attention_plain",
           "flash_attention_vjp", "VJP_SCORE_BYTES"]

F32, BF16 = torch.float32, torch.bfloat16
K4_BLOCK_ROWS = {F32: 128, BF16: 64}     # query rows per block (k4::F32_BQ, k4::BF16_BQ)
K4_TILE_KEYS = {F32: 32, BF16: 64}       # keys per k-tile (k4::F32_BK, k4::BF16_BK)
K4_THREADS = {F32: 256, BF16: 128}       # threads per block: warps of 16 query rows
K4_MAX_D = 256                           # widest head either body takes (k4::MAX_D)
_F32_P_STRIDE = 20                       # floats per key of a warp's p tile (k4::F32_P_STRIDE)
_NAMES = {F32: "k4_flash_attention", BF16: "k4_flash_attention_bf16"}

LAUNCHES = {name: 0 for name in _NAMES.values()}
WINDOWS: collections.Counter = collections.Counter()      # (launcher, window) → launches


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    WINDOWS.clear()


def k4_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the body for ``dtype``
    (``k4::smem_bytes``): Q, K and V, rows padded as the .cuh says, and the
    fp32 body's per-warp p tiles."""
    bq, bk = K4_BLOCK_ROWS[dtype], K4_TILE_KEYS[dtype]
    if dtype == BF16:
        return 2 * (bq + 2 * bk) * (-(-d // 16) * 16 + 8)
    return 4 * ((bq + 2 * bk) * (d + 4) + K4_THREADS[F32] // 32 * bk * _F32_P_STRIDE)


def _clamp_window(window: int, S: int) -> int:
    return max(-S, min(S, window))


def k_tiles(q0: int, S: int, window: int, causal: bool, dtype: torch.dtype) -> range:
    """The k-tiles the block of the q-tile at ``q0`` visits in the body for
    ``dtype`` (``k4::k_tiles``)."""
    bq, bk = K4_BLOCK_ROWS[dtype], K4_TILE_KEYS[dtype]
    window = _clamp_window(window, S)
    if causal and window >= 1:
        last = min(q0 + bq - 1, S - 1)
        return range(max(q0 - window + 1, 0) // bk, last // bk + 1)
    return range(0, -(-S // bk))


def _groups(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    if k.shape != v.shape or k.dim() != 3 or q.dim() != 3 or q.shape[1:] != k.shape[1:]:
        raise ValueError(f"flash_attention takes q (BH, S, d) and k, v (BH/G, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] < 1 or q.shape[0] % k.shape[0]:
        raise ValueError(f"flash_attention: {q.shape[0]} query rows do not group over {k.shape[0]} key rows")
    return q.shape[0] // k.shape[0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None = None,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one head at a time: q, k and v
    widened to fp32, dense scores scaled by d^-0.5, the −1e30 mask, softmax,
    the product with v, and the output cast to q's dtype."""
    G = _groups(q, k, v)
    BH, S, d = q.shape
    win = S if window is None else int(window)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] > pos[:, None] - win
    if causal:
        valid &= pos[None, :] <= pos[:, None]
    masked = torch.tensor(-1e30, device=q.device)
    out = torch.empty_like(q)
    for bh in range(BH):
        s = (q[bh].float() @ k[bh // G].float().T) * (d ** -0.5)
        w = torch.softmax(torch.where(valid, s, masked), dim=-1)
        out[bh] = (w @ v[bh // G].float()).to(q.dtype)
    return out


VJP_SCORE_BYTES = 2**27      # one (heads, G, rows, S) fp32 block of the backward: 128 MiB; ≤ 5 live at once


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                        window: int | None = None, causal: bool = True):
    """(dq, dk, dv) of ``out = flash_attention(q, k, v, window, causal)`` for
    the cotangent ``g``, each in its input's dtype, computed in fp32:

        P = softmax(mask(q·kᵀ·d^-0.5)),  D = rowsum(g ∘ out),
        dV = Pᵀ·g,  dS = P ∘ (g·Vᵀ − D) on valid pairs (0 on masked ones),
        dQ = dS·K·d^-0.5,  dK = dSᵀ·Q·d^-0.5,

    with dK and dV summed over the G query heads that read each key/value
    row (``bh // G``). A masked score is the constant −1e30, so it passes
    no gradient; a row with no valid key averages v, and its P still
    reaches dV. Works through blocks of key/value heads and of query rows
    so that a score block holds at most `VJP_SCORE_BYTES`."""
    G = _groups(q, k, v)
    BH, S, d = q.shape
    BHk = k.shape[0]
    win = S if window is None else int(window)
    scale = d ** -0.5
    pos = torch.arange(S, device=q.device)
    masked = torch.tensor(-1e30, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros((BHk, S, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    heads = max(1, min(BHk, VJP_SCORE_BYTES // (4 * G * S * S)))
    rows = max(1, min(S, VJP_SCORE_BYTES // (4 * G * heads * S)))
    for h0 in range(0, BHk, heads):
        h1 = min(h0 + heads, BHk)
        kb, vb = k[h0:h1].float(), v[h0:h1].float()                               # (h, S, d)
        for r0 in range(0, S, rows):
            r1 = min(r0 + rows, S)
            qb = q[h0 * G:h1 * G, r0:r1].float().unflatten(0, (h1 - h0, G))       # (h, G, r, d)
            gb = g[h0 * G:h1 * G, r0:r1].float().unflatten(0, (h1 - h0, G))
            ob = out[h0 * G:h1 * G, r0:r1].float().unflatten(0, (h1 - h0, G))
            qpos = pos[r0:r1, None]
            valid = pos[None, :] > qpos - win
            if causal:
                valid &= pos[None, :] <= qpos
            s = torch.einsum("hgrd,hsd->hgrs", qb, kb) * scale
            p = torch.softmax(torch.where(valid, s, masked), dim=-1)
            del s
            dv[h0:h1] += torch.einsum("hgrs,hgrd->hsd", p, gb)
            dp = torch.einsum("hgrd,hsd->hgrs", gb, vb)
            D = (gb * ob).sum(dim=-1, keepdim=True)
            ds = torch.where(valid, p * (dp - D), 0.0)
            del p, dp
            dq[h0 * G:h1 * G, r0:r1] = (torch.einsum("hgrs,hsd->hgrd", ds, kb) * scale).flatten(0, 1).to(q.dtype)
            dk[h0:h1] += torch.einsum("hgrs,hgrd->hsd", ds, qb) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in _NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float, P], ctypes.c_int
    for name in ("k4_block_rows", "k4_tile_keys", "k4_block_threads"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [I], ctypes.c_int
    lib.k4_max_d.argtypes, lib.k4_max_d.restype = [], ctypes.c_int
    lib.k4_smem_bytes.argtypes, lib.k4_smem_bytes.restype = [I, I], ctypes.c_longlong
    lib.k4_kernel_attributes.argtypes, lib.k4_kernel_attributes.restype = [I, I, P, P, P], ctypes.c_int
    lib.k4_error_string.argtypes, lib.k4_error_string.restype = [I], ctypes.c_char_p
    return lib


def kernel_attributes(dtype: torch.dtype, d: int = 240) -> dict:
    """What the compiler gave the body for ``dtype``, read from the card
    (``cudaFuncGetAttributes``): registers a thread, local memory a thread
    (spills; 0 when none) and the blocks that fit one SM at head width d."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    lib = _lib()
    err = lib.k4_kernel_attributes(int(dtype == BF16), d, ctypes.byref(regs), ctypes.byref(local),
                                   ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"k4_kernel_attributes: CUDA error {err} ({lib.k4_error_string(err).decode()})")
    return dict(registers=regs.value, local_bytes=local.value, blocks_per_sm=blocks.value, d=d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (BH, S, d) over k, v (BH / G, S, d) on the card, one
    launch: fp32 or bf16 (all three alike, each starting on a 16-byte
    boundary), any S ≥ 1, d a multiple of 4 up to `K4_MAX_D`; ``window``
    None means S. The output has q's shape and dtype."""
    if q.dtype not in _NAMES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k and v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    G = _groups(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention launches a CUDA kernel and takes CUDA tensors on one card, "
                             f"got {q.device}, {k.device}, {v.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: q, k and v must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary (cp.async)")
    BH, S, d = q.shape
    if d % 4 or not 4 <= d <= K4_MAX_D:
        raise ValueError(f"flash_attention takes a head width d that is a multiple of 4 up to {K4_MAX_D}, got {d}")
    if not (1 <= S < 2**31 and 1 <= BH < 2**31):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is outside the kernel's sizes")
    window = S if window is None else int(window)
    out = torch.empty_like(q)
    name = _NAMES[q.dtype]
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, d, G,
                             _clamp_window(window, S), int(causal), float(d ** -0.5), stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.k4_error_string(err).decode()})")
    LAUNCHES[name] += 1
    WINDOWS[(name, window)] += 1
    return out
