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
once and does three operations with it. At DeepFM's widths (F = 39, D = 10,
fp32) that is 1,560 B per example: 102.2 MB at the training batch of
65,536, 30.5 µs at 3.35 TB/s, against 0.1 GFLOP. At the serving batch of
512 (0.8 MB) the floor is a launch and one round trip to memory.

**What the design does about it.** A block of 256 threads takes a tile of
consecutive examples, one contiguous run of memory, and issues every
16-byte ``cp.async`` of it before waiting once, so the whole tile is in
flight together; the tile is a multiple of the fewest examples whose bytes
are a multiple of 16 (2 in fp32, 4 in bf16 at DeepFM's widths), so every
tile starts 16-byte aligned. Each example then gets G = min(32, D rounded
up to a power of two) lanes of one warp, which walk its fields for their d,
and a butterfly of shuffles over those lanes sums the D terms in a fixed
order (see the .cuh). The grid is one wave of blocks, each looping over
its tiles with two in a shared-memory ring, the next tile's copies in
flight while it sums the current one. The TPU kernel's ``b_tile``, which had to divide B,
does not carry over: the kernel picks its own tile from B, F, D and the
dtype (`fm_tile`: at most one pass of the block, 256 / G examples, and no
more than B / 128 rounded up, so that a batch of 512 spreads over 128
blocks) and takes any B; the last tile is short. An example whose tile
would pass 48 KB of shared memory is not staged: the lanes read it in place,
consecutive lanes on consecutive d.

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

__all__ = ["LAUNCHES", "reset_launch_counts", "FM_THREADS", "fm_tile", "fm_smem_bytes", "kernel_attributes",
           "fm_interaction", "fm_interaction_plain"]

FM_THREADS = 256                 # threads per block (k3::THREADS)
_STAGE_BYTES = 48 * 1024         # the largest staged tile (k3::STAGE_BYTES)
_COVER = 128                     # blocks the grid reaches where B allows (k3::COVER)
_NAMES = {torch.float32: "k3_fm_interaction", torch.bfloat16: "k3_fm_interaction_bf16"}

LAUNCHES = {name: 0 for name in _NAMES.values()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fm_tile(B: int, F: int, D: int, dtype=torch.float32) -> tuple[int, bool]:
    """(examples per block, whether the tile is staged in shared memory), as
    ``k3::tile_for``: at most one pass of the block (256 / G examples, G the
    lanes of one example), no more than ⌈B / 128⌉ rounded up to u, and,
    staged, a multiple of u (the fewest examples whose bytes are a multiple
    of 16) within 48 KB. (0, False) for a shape the kernel does not take."""
    if B < 1 or F < 1 or D < 1:
        return 0, False
    E = F * D * dtype.itemsize
    u = next(n for n in (1, 2, 4, 8, 16) if E * n % 16 == 0)
    staged = E * u <= _STAGE_BYTES
    bt = FM_THREADS // min(32, 1 << (D - 1).bit_length())
    if staged:
        bt = min(bt, _STAGE_BYTES // E // u * u)
    return min(bt, -(-(-(-B // _COVER)) // u) * u), staged


def fm_smem_bytes(B: int, F: int, D: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block (``k3::smem_bytes``): a ring of two
    staged tiles, each in whole 16-byte pieces; none when not staged."""
    bt, staged = fm_tile(B, F, D, dtype)
    return 2 * (-(-(bt * F * D * dtype.itemsize) // 16) * 16) if staged else 0


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
    for name in ("k3_tile_examples", "k3_tile_staged"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [I, I, I, I], ctypes.c_int
    lib.k3_smem_bytes.argtypes, lib.k3_smem_bytes.restype = [I, I, I, I], ctypes.c_longlong
    lib.k3_attributes.argtypes, lib.k3_attributes.restype = [I, I, I, I, P, P, P], ctypes.c_int
    lib.k3_error_string.argtypes, lib.k3_error_string.restype = [I], ctypes.c_char_p
    return lib


@functools.cache
def kernel_attributes(dtype, B: int, F: int, D: int) -> dict:
    """What the compiler gave K3's instantiation for ``dtype``, read from the
    card: registers a thread, local memory a thread (spills; 0 when none)
    and the blocks that fit one SM with the tile of (B, F, D) staged."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    lib = _lib()
    err = lib.k3_attributes(int(dtype == torch.bfloat16), B, F, D, ctypes.byref(regs), ctypes.byref(local),
                            ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"k3_attributes: CUDA error {err} ({lib.k3_error_string(err).decode()})")
    return dict(registers=regs.value, local_bytes=local.value, blocks_per_sm=blocks.value)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """The FM term of ``emb`` (B, F, D) on the card, one launch: any B, any
    F ≥ 1 and D ≥ 1; fp32 or bf16, the output (B,) in emb's dtype."""
    if emb.dtype not in _NAMES:
        raise TypeError(f"fm_interaction takes float32 or bfloat16 embeddings, got {emb.dtype}")
    if emb.dim() != 3:
        raise ValueError(f"fm_interaction takes (B, F, D) embeddings, got shape {tuple(emb.shape)}")
    if emb.device.type != "cuda":
        raise ValueError(f"fm_interaction launches a CUDA kernel and takes CUDA tensors, got {emb.device}")
    if not emb.is_contiguous():
        raise ValueError("fm_interaction: emb must be contiguous")
    B, F, D = emb.shape
    if F < 1 or D < 1:
        raise ValueError(f"fm_interaction takes F ≥ 1 and D ≥ 1, got F={F}, D={D}")
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
