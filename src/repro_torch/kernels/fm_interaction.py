"""DeepFM's second-order FM term on Hopper (K3), with its plain version —
twin of `repro.kernels.fm_interaction`.

    out[b] = ½ · Σ_d [ (Σ_f emb[b, f, d])² − Σ_f emb[b, f, d]² ]

over ``emb`` (B, F, D) in fp32 or bf16: sums and products in fp32, the
output (B,) in emb's dtype. The CUDA source is
``csrc/fm_interaction_kernels.cuh`` (kernel) and ``csrc/fm_interaction.cu``
(launchers).

Source note
-----------
**Replaces** ``src/repro/kernels/fm_interaction.py::fm_interaction_pallas``
(body ``_kernel``, line 21; ``pallas_call`` at line 37).

**What bounds it on the H100: bytes.** It reads every element of ``emb``
once and does two operations with it. At DeepFM's widths (F = 39, D = 10,
fp32) that is 1,560 B per example: 102.2 MB at the training batch of
65,536, 30.5 µs at 3.35 TB/s, against 0.1 GFLOP.

**What the design does about it.** One block takes a tile of consecutive
examples, which is one contiguous run of memory, stages it into shared
memory with every thread on consecutive addresses, then gives one thread to
each (example, d) pair to walk the fields, and sums each example's D terms
in order (see the .cuh). The TPU kernel's ``b_tile``, which had to divide
B, does not carry over: the kernel picks its own tile (`fm_tile`) and takes
any B; the last tile is short. An example wider than the stage is taken a
chunk of fields at a time. D is bounded by shared memory: at most
`FM_MAX_D`.

On CPU tensors `repro_torch.kernels.ops.fm_interaction` runs
`fm_interaction_plain`; on CUDA tensors it runs `fm_interaction` here or
raises. The wrapper adds one to its launcher's entry of ``LAUNCHES``
(``k3_fm_interaction``, ``k3_fm_interaction_bf16``) where it launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library
from repro_torch.kernels.ref import fm_interaction_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "FM_THREADS", "FM_MAX_D", "fm_tile", "fm_smem_bytes",
           "fm_interaction", "fm_interaction_plain"]

FM_THREADS = 256                 # threads per block (k3::THREADS)
_BUDGET = 12 * 1024              # fp32 words of shared memory per block (k3::BUDGET)
FM_MAX_D = _BUDGET // 3          # widest D the kernel takes (k3::MAX_D)
_NAMES = {torch.float32: "k3_fm_interaction", torch.bfloat16: "k3_fm_interaction_bf16"}

LAUNCHES = {name: 0 for name in _NAMES.values()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fm_tile(F: int, D: int) -> tuple[int, int]:
    """(examples per block, fields per staged chunk), as ``k3::tile_for``:
    one thread per (example, d) pair where D allows, and the staged chunk
    plus the pair accumulators within the block's shared memory."""
    if D > FM_MAX_D or F < 1 or D < 1:
        return 0, 0
    bt = min(FM_THREADS // D, _BUDGET // (F * D + 2 * D))
    if bt >= 1:
        return bt, F
    return 1, min(_BUDGET // D - 2, F)


def fm_smem_bytes(F: int, D: int) -> int:
    bt, fc = fm_tile(F, D)
    return 4 * (bt * fc * D + 2 * bt * D)


# The kernel does the oracle's arithmetic (fp32 field sums, s² − q per d,
# summed over d, halved, rounded once to emb's dtype), so its plain version
# is the oracle itself.
fm_interaction_plain = fm_interaction_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("fm_interaction")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in _NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [P, P, I, I, I, P], ctypes.c_int
    for name in ("k3_tile_examples", "k3_tile_fields"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [I, I], ctypes.c_int
    lib.k3_smem_bytes.argtypes, lib.k3_smem_bytes.restype = [I, I], ctypes.c_longlong
    lib.k3_error_string.argtypes, lib.k3_error_string.restype = [I], ctypes.c_char_p
    return lib


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """The FM term of ``emb`` (B, F, D) on the card, one launch: any B, any
    F ≥ 1, 1 ≤ D ≤ `FM_MAX_D`; fp32 or bf16, the output (B,) in emb's
    dtype."""
    if emb.dtype not in _NAMES:
        raise TypeError(f"fm_interaction takes float32 or bfloat16 embeddings, got {emb.dtype}")
    if emb.dim() != 3:
        raise ValueError(f"fm_interaction takes (B, F, D) embeddings, got shape {tuple(emb.shape)}")
    if emb.device.type != "cuda":
        raise ValueError(f"fm_interaction launches a CUDA kernel and takes CUDA tensors, got {emb.device}")
    if not emb.is_contiguous():
        raise ValueError("fm_interaction: emb must be contiguous")
    B, F, D = emb.shape
    if F < 1 or not 1 <= D <= FM_MAX_D:
        raise ValueError(f"fm_interaction takes F ≥ 1 and 1 ≤ D ≤ {FM_MAX_D}, got F={F}, D={D}")
    if B >= 2**31 or F * D >= 2**31:
        raise ValueError(f"fm_interaction: shape {tuple(emb.shape)} is past the kernel's int32 sizes")
    out = torch.empty((B,), dtype=emb.dtype, device=emb.device)
    if B == 0:
        return out
    name = _NAMES[emb.dtype]
    lib = _lib()
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    err = getattr(lib, name)(emb.data_ptr(), out.data_ptr(), B, F, D, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.k3_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return out
