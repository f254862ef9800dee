"""The LM's flash attention on Hopper (K4), with its plain version — twin of
`repro.kernels.flash_attention`.

    out[bh] = softmax((q[bh] · k[bh // G]ᵀ) · d^-0.5, masked) · v[bh // G]

over q (BH, S, d) and k, v (BH / G, S, d), fp32 or bf16: a pair (i, j) is
valid when ``j > i − window`` and, when causal, ``j ≤ i``; a masked score is
−1e30 (not −∞), so a row with no valid key averages v over all S keys. Scores,
softmax and the product with v are fp32; the output has q's dtype. The CUDA
source is ``csrc/flash_attention_kernels.cuh`` (kernel) and
``csrc/flash_attention.cu`` (launchers).

Source note
-----------
**Replaces** ``src/repro/kernels/flash_attention.py::flash_attention_pallas``
(def line 70, body ``_kernel`` line 31, ``pallas_call`` line 90).

**What bounds it on the H100: operations** in fp32 (4·d per valid pair,
against 4·d·4 bytes per row read once: at gemma3-12b's d = 240 and S = 4,096,
16 heads, 1.29·10¹¹ operations of a causal layer take 1.92 ms at
67 TFLOP/s, its 126 MB 0.038 ms at 3.35 TB/s). In bf16 both bounds are
close at the tensor cores' rate (0.130 ms of operations at 989 TFLOP/s for a
causal layer; a local layer's 5.64·10¹⁰ take 0.057 ms against 0.038 ms of
bytes). This first kernel computes on the CUDA cores in fp32 for both types;
the tensor cores for bf16 are later work.

**What the design does about it.** The TPU grid ``(BH, S/bq, S/bk)``
carries m, l and the accumulator in VMEM across k-steps; on Hopper one block
owns a (bh, 64-row q-tile) and loops over 32-key k-tiles itself, with Q and
each K and V tile staged in shared memory (rows padded to d + 4 floats) and
the accumulator in registers, 4 rows × 16 columns per thread; two blocks
share an SM at d = 240 (``K4_BLOCK_ROWS``, ``K4_TILE_KEYS``; see the .cuh).
It takes any S (the reference asserts ``S % bq == 0``): the last tiles are
masked, and keys past S get p = 0. When causal and window ≥ 1 it skips the
k-tiles in which every pair of its q-tile is masked; each row then has its
own key as a valid one, so every skipped term is exactly 0 or is exactly
zeroed by the first valid key's rescale ``exp(−1e30 − m) = 0``. The result
differs from visiting every tile only when a masked key's k or v holds NaN
or ∞. With window < 1, or when not causal, every k-tile is visited.

**Grouped-query attention.** k and v may have BH / G rows for G query heads
per key/value head: the launcher takes G, and query row ``b·H + h`` reads
key/value row ``(b·H + h) // G = b·Hk + h // G``, the reference's grouping
(`repro.nn.attention`, ``h // G``), without copying k and v per group.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs
`flash_attention_plain`; on CUDA tensors it runs `flash_attention` here or
raises. The wrapper adds one to its launcher's entry of ``LAUNCHES``
(``k4_flash_attention``, ``k4_flash_attention_bf16``) where it launches, and
to ``WINDOWS[(name, window)]`` beside it.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels._build import library

__all__ = ["LAUNCHES", "WINDOWS", "reset_launch_counts", "K4_BLOCK_ROWS", "K4_TILE_KEYS", "K4_MAX_D",
           "k4_smem_bytes", "k_tiles", "flash_attention", "flash_attention_plain"]

K4_BLOCK_ROWS = 64               # query rows per block (k4::BQ)
K4_TILE_KEYS = 32                # keys per k-tile (k4::BK)
K4_MAX_D = 256                   # widest head the kernel takes (k4::MAX_D)
_NAMES = {torch.float32: "k4_flash_attention", torch.bfloat16: "k4_flash_attention_bf16"}

LAUNCHES = {name: 0 for name in _NAMES.values()}
WINDOWS: collections.Counter = collections.Counter()      # (launcher, window) → launches


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    WINDOWS.clear()


def k4_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (``k4::smem_bytes``)."""
    return 4 * ((K4_BLOCK_ROWS + K4_TILE_KEYS) * (d + 4) + K4_BLOCK_ROWS * (K4_TILE_KEYS + 1)
                + 3 * K4_BLOCK_ROWS)


def _clamp_window(window: int, S: int) -> int:
    return max(-S, min(S, window))


def k_tiles(q0: int, S: int, window: int, causal: bool) -> range:
    """The k-tiles the block of the q-tile at ``q0`` visits (``k4::k_tiles``)."""
    window = _clamp_window(window, S)
    if causal and window >= 1:
        last = min(q0 + K4_BLOCK_ROWS - 1, S - 1)
        return range(max(q0 - window + 1, 0) // K4_TILE_KEYS, last // K4_TILE_KEYS + 1)
    return range(0, -(-S // K4_TILE_KEYS))


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in _NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float, P], ctypes.c_int
    for name in ("k4_block_rows", "k4_tile_keys", "k4_max_d"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
    lib.k4_smem_bytes.argtypes, lib.k4_smem_bytes.restype = [I], ctypes.c_longlong
    lib.k4_error_string.argtypes, lib.k4_error_string.restype = [I], ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (BH, S, d) over k, v (BH / G, S, d) on the card, one
    launch: fp32 or bf16 (all three alike), any S ≥ 1, d a multiple of 4 up
    to `K4_MAX_D`; ``window`` None means S. The output has q's shape and
    dtype."""
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
