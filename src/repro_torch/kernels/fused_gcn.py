"""One fused ragged-BSR GCN layer on Hopper (K2), with its plain version.

    H = act( Ã · (X · W) + b )        (feature-first, COIN §IV-C3)
    H = act( (Ã · X) · W + b )        (aggregation-first)

over the ragged 128×128 blocked adjacency of
`repro_torch.graph.structure.blocked_adjacency`. The CUDA source is
``csrc/fused_gcn_kernels.cuh`` (kernels) and ``csrc/fused_gcn.cu`` (launchers).

Source note
-----------
**Replaces** ``src/repro/kernels/fused_gcn.py::fused_gcn_layer_pallas``:
the feature-first body ``_ff_kernel`` (line 45) and the aggregation-first
body ``_af_kernel`` (line 70).

**What bounds it on the H100: bytes.** The layer must read X once and every
valid tile once. At Nell's layer 1 (X 65,792 × 5,414 fp32, 11,662 valid
tiles) that is 1.42 GB + 0.76 GB = 2.19 GB, 0.65 ms at 3.35 TB/s, against
17.5 GFLOP, 0.26 ms at the 67 TFLOP/s fp32 rate of the CUDA cores. Layer 2
(16 → 210) is bytes-bound too (0.76 GB of tiles).

**What the design does about it.**

* Feature-first is two launches. `ff_transform` writes Z = X·W once (Nell:
  65,792 × 16 fp32, 4.2 MB, which stays in the 50 MB L2); `ff_aggregate`
  then walks the ragged tiles against Z and adds bias and activation in its
  epilogue. Carrying the TPU body over block by block would recompute
  X[cols[r,t]]·W for every nonzero tile: at Nell that reads X about 23
  times (32 GB) for 15× the arithmetic.
* Aggregation-first is one launch: Ã·X accumulates in shared memory
  (128 × F_in fp32), then the same block multiplies by W and adds bias and
  activation. F_in is bounded by shared memory: at most `AF_MAX_F_IN`.
* One block owns one (block-row, feature tile) pair and loops over its own
  tiles ``t < lens[r]``, so the TPU's accumulator carried along a
  sequential grid axis becomes a loop: nothing crosses blocks, there are no
  atomics, padding tiles are never read, and an empty block-row writes
  act(b).
* A 128×128 fp32 tile is 64 KB, so tiles move through shared memory in
  128 × 32 chunks by asynchronous copies, two stages deep: the next chunk
  is in flight while the block computes on the current one. Each thread
  owns one tile row and reads shared memory four floats at a time.
* IEEE fp32 FMAs on the CUDA cores, no tensor cores. A block-row with many
  tiles runs them one after another in one block (Nell's longest block-row
  has 299 tiles, the median 19), and that block sets the aggregation's
  time: splitting long block-rows is later work.

**The bf16-operand mode** (the TPU kernel's, ``fused_gcn.py:57-59`` and
``:88-90``) is the same kernels instantiated on other element types, one
launcher per combination of (vals, X, W):

* fp32, fp32, fp32 — the launch names below without a suffix;
* fp32, bf16, fp32 — suffix ``_bf16``: the halo path's bf16 neighbor table
  (`repro_torch.models.gcn`), where the only rounding is the bf16 output;
* bf16, bf16, bf16 — suffix ``_bf16_all``.

Operands are widened to fp32 as they are staged and rounded where the TPU
kernel rounds: feature-first Z = X·W to vals' type, aggregation-first Ã·X
to W's type before the product with W, the output to X's type; bias (fp32)
and activation apply in fp32. bf16 halves the bytes of what it touches (at
the halo path's rank shape only the 16-wide table, not the fp32 tiles that
bound the kernel). The stages stay fp32, so `AF_MAX_F_IN` is the same for
every combination. Any other combination raises a TypeError.

On CPU tensors `repro_torch.kernels.ops.fused_gcn_layer` runs the plain
versions below; on CUDA tensors it runs the kernels or raises. Each kernel
wrapper adds one to its entry of `LAUNCHES` where it launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "AF_MAX_F_IN",
    "layer_smem_bytes",
    "ff_transform",
    "ff_aggregate",
    "af_layer",
    "fused_gcn_layer_cuda",
    "ff_transform_plain",
    "ff_aggregate_plain",
    "af_layer_plain",
    "fused_gcn_layer_plain",
    "operand_suffix",
]

TILE = 128                  # adjacency tile edge the kernels take
_KC, _NC, _STAGES = 32, 16, 2   # staged chunk depth, accumulator chunk, pipeline stages (as in the .cuh)
FF_F_TILE = 64              # output columns one feature-first aggregation block covers
SMEM_LIMIT = 232_448        # bytes of shared memory one H100 block may opt into

# The (vals, X, W) dtype combinations K2 takes, and their launchers' suffixes.
_F32, _BF16 = torch.float32, torch.bfloat16
_SUFFIX = {(_F32, _F32, _F32): "", (_F32, _BF16, _F32): "_bf16", (_BF16, _BF16, _BF16): "_bf16_all"}
_K2 = ("k2_ff_transform", "k2_ff_aggregate", "k2_af_layer")

# K1's (vals, Z) dtype combinations and their launchers (`kernels.bsr_spmm`).
K1_NAMES = {(_F32, _F32): "k1_bsr_spmm", (_F32, _BF16): "k1_bsr_spmm_bf16",
            (_BF16, _BF16): "k1_bsr_spmm_bf16_all"}

# Launches of every kernel of the library (K2 here, K1 in `kernels.bsr_spmm`).
LAUNCHES = {**{f"{k}{sfx}": 0 for sfx in _SUFFIX.values() for k in _K2},
            **{name: 0 for name in K1_NAMES.values()}}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def layer_smem_bytes(ft: int) -> int:
    """Shared memory of one ragged-layer block with an accumulator of width
    ``ft`` (mirrors ``k2::layer_smem_bytes``)."""
    ftp = -(-ft // _NC) * _NC
    return 4 * (_STAGES * (TILE * (_KC + 4) + _KC * ftp) + TILE * (ftp + 1))


AF_MAX_F_IN = max(f for f in range(_NC, 4096, _NC) if layer_smem_bytes(f) <= SMEM_LIMIT)


def operand_suffix(kernel: str, vals_dtype, x_dtype, w_dtype) -> str:
    """The launch-name suffix of K2's (vals, X, W) dtype combination, or a
    TypeError naming the combinations the kernels take."""
    try:
        return _SUFFIX[(vals_dtype, x_dtype, w_dtype)]
    except KeyError:
        taken = "; ".join(f"({', '.join(str(d).removeprefix('torch.') for d in c)})" for c in _SUFFIX)
        raise TypeError(
            f"{kernel} takes (vals, x, w) dtypes {taken}; got "
            f"({vals_dtype}, {x_dtype}, {w_dtype})"
        ) from None


# ----------------------------------------------------------------- plain versions
# fp32 arithmetic on widened operands, rounded where the kernels round; for
# fp32 operands every cast below is the identity.
def _ragged_aggregate_plain(vals, cols, lens, src):
    """Σ_{t < lens[r]} vals[r, t] @ src_block[cols[r, t]] as (R·B, F) in fp32,
    reading only the valid tiles."""
    R, T, B, _ = vals.shape
    F = src.shape[1]
    valid = torch.arange(T, device=vals.device)[None, :] < lens[:, None]
    r_idx, t_idx = valid.nonzero(as_tuple=True)
    tiles = vals[r_idx, t_idx].float()                                   # (nnz, B, B)
    blocks = src.reshape(-1, B, F)[cols[r_idx, t_idx].long()].float()   # (nnz, B, F)
    acc = tiles.new_zeros((R, B, F)).index_add_(0, r_idx, torch.bmm(tiles, blocks))
    return acc.reshape(R * B, F)


def _act(h: torch.Tensor, relu: bool) -> torch.Tensor:
    return h.clamp_min(0.0) if relu else h


def ff_transform_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Z = X · W in fp32, stored as ``out_dtype`` (vals' dtype)."""
    return (x.float() @ w.float()).to(out_dtype)


def ff_aggregate_plain(vals, cols, lens, z, b, relu: bool = True, out_dtype=torch.float32) -> torch.Tensor:
    out = _act(_ragged_aggregate_plain(vals, cols, lens, z) + b.float().reshape(1, -1), relu)
    return out.to(out_dtype)


def af_layer_plain(vals, cols, lens, x, w, b, relu: bool = True) -> torch.Tensor:
    """act(round_W(Ã · X) · W + b) in fp32, stored in X's dtype."""
    m = _ragged_aggregate_plain(vals, cols, lens, x).to(w.dtype).float()
    return _act(m @ w.float() + b.float().reshape(1, -1), relu).to(x.dtype)


def fused_gcn_layer_plain(vals, cols, lens, x, w, b, order: str = "feature_first",
                          relu: bool = True) -> torch.Tensor:
    if order == "feature_first":
        z = ff_transform_plain(x, w, vals.dtype)
        return ff_aggregate_plain(vals, cols, lens, z, b, relu, x.dtype)
    if order == "aggregation_first":
        return af_layer_plain(vals, cols, lens, x, w, b, relu)
    raise ValueError(f"unknown dataflow order: {order!r}")


# ------------------------------------------------------------------ CUDA kernels
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("fused_gcn")
    P, I = ctypes.c_void_p, ctypes.c_int
    args = {
        "k2_ff_transform": [P, P, P, I, I, I, P],
        "k2_ff_aggregate": [P, P, P, I, I, I, P, P, P, I, I, I, P],
        "k2_af_layer": [P, P, P, I, I, I, P, I, P, P, P, I, I, P],
    }
    signatures = {f"{k}{sfx}": a for k, a in args.items() for sfx in _SUFFIX.values()}
    signatures.update({name: [P, P, P, I, I, I, P, P, I, I, P] for name in K1_NAMES.values()})
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.k2_layer_smem_bytes.argtypes, lib.k2_layer_smem_bytes.restype = [I], ctypes.c_longlong
    lib.k2_error_string.argtypes, lib.k2_error_string.restype = [I], ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.k2_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(kernel: str, **tensors) -> torch.device:
    """Device, dtype, rank and contiguity checks shared by the wrappers:
    int32 tables, an fp32 bias, fp32 or bf16 data (each wrapper then checks
    its combination)."""
    want = {"cols": (torch.int32,), "lens": (torch.int32,), "b": (_F32,)}
    rank = {"vals": 4, "cols": 2, "lens": 1, "x": 2, "z": 2, "w": 2, "b": 1}
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        dtypes = want.get(name, (_F32, _BF16))
        if t.dtype not in dtypes:
            names = " or ".join(str(d) for d in dtypes)
            raise TypeError(f"{kernel}: {name} must be {names}, got {t.dtype}")
        if t.dim() != rank[name]:
            raise ValueError(f"{kernel}: {name} must have {rank[name]} dims, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if max(t.shape, default=0) >= 2**31:
            raise ValueError(f"{kernel}: {name} has a dimension past the kernels' int32 sizes")
        if t.device != device:
            raise ValueError(f"{kernel}: all operands must be on one device, got {device} and {t.device}")
    return device


def _require_cuda(kernel: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel} launches a CUDA kernel and takes CUDA tensors, got {device}")


def _check_table(kernel: str, vals, cols, lens, src, f_out: int, b=None) -> None:
    R, T, B, B2 = vals.shape
    if B != TILE or B2 != TILE:
        raise ValueError(f"{kernel}: the kernels take {TILE}×{TILE} tiles, got {B}×{B2}")
    if tuple(cols.shape) != (R, T) or tuple(lens.shape) != (R,):
        raise ValueError(f"{kernel}: cols {tuple(cols.shape)} / lens {tuple(lens.shape)} do not match vals {(R, T)}")
    if vals.data_ptr() % 16:
        raise ValueError(f"{kernel}: vals must be 16-byte aligned (the kernels copy it in 16-byte pieces)")
    if src.shape[0] % TILE or src.shape[0] == 0:
        raise ValueError(f"{kernel}: feature rows must be a positive multiple of {TILE}, got {src.shape[0]}")
    if f_out < 1:
        raise ValueError(f"{kernel}: the output needs at least one column, got {f_out}")
    if b is not None and tuple(b.shape) != (f_out,):
        raise ValueError(f"{kernel}: b must have shape ({f_out},), got {tuple(b.shape)}")


def ff_transform(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Z = X · W on the card (feature-first launch 1 of 2), stored as
    ``out_dtype`` — vals' dtype in the layer: (x, w, out) is (fp32, fp32,
    fp32), (bf16, fp32, fp32) or (bf16, bf16, bf16)."""
    device = _check("ff_transform", x=x, w=w)
    M, K = x.shape
    if w.shape[0] != K or min(M, K, w.shape[1]) < 1:
        raise ValueError(f"ff_transform: cannot multiply x {tuple(x.shape)} by w {tuple(w.shape)}")
    sfx = operand_suffix("ff_transform", out_dtype, x.dtype, w.dtype)
    N = w.shape[1]
    _require_cuda("ff_transform", device)
    z = torch.empty((M, N), dtype=out_dtype, device=device)
    _launch(f"k2_ff_transform{sfx}", x.data_ptr(), w.data_ptr(), z.data_ptr(), M, K, N, _stream(device))
    return z


def ff_aggregate(vals, cols, lens, z, b, relu: bool = True, out_dtype=torch.float32) -> torch.Tensor:
    """act(Ã · Z + b) on the card (feature-first launch 2 of 2); Z in vals'
    dtype, the output stored as ``out_dtype`` (X's dtype in the layer)."""
    device = _check("ff_aggregate", vals=vals, cols=cols, lens=lens, z=z, b=b)
    if z.dtype != vals.dtype:
        raise TypeError(f"ff_aggregate: z must have vals' dtype {vals.dtype}, got {z.dtype}")
    w_dtype = _BF16 if vals.dtype == _BF16 else _F32
    sfx = operand_suffix("ff_aggregate", vals.dtype, out_dtype, w_dtype)
    f_out = z.shape[1]
    _check_table("ff_aggregate", vals, cols, lens, z, f_out, b)
    _require_cuda("ff_aggregate", device)
    R, T = cols.shape
    out = torch.empty((R * TILE, f_out), dtype=out_dtype, device=device)
    _launch(
        f"k2_ff_aggregate{sfx}", vals.data_ptr(), cols.data_ptr(), lens.data_ptr(), R, T,
        z.shape[0] // TILE, z.data_ptr(), b.data_ptr(), out.data_ptr(), f_out,
        min(f_out, FF_F_TILE), int(relu), _stream(device),
    )
    return out


def af_layer(vals, cols, lens, x, w, b, relu: bool = True) -> torch.Tensor:
    """act((Ã · X) · W + b) on the card, one launch; output in X's dtype."""
    device = _check("af_layer", vals=vals, cols=cols, lens=lens, x=x, w=w, b=b)
    sfx = operand_suffix("af_layer", vals.dtype, x.dtype, w.dtype)
    f_in, f_out = w.shape
    if x.shape[1] != f_in or f_in < 1:
        raise ValueError(f"af_layer: x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    if f_in > AF_MAX_F_IN:
        raise ValueError(
            f"af_layer: F_in={f_in} needs {layer_smem_bytes(f_in)} bytes of shared memory "
            f"per block, past the card's {SMEM_LIMIT}; the aggregation-first kernel takes "
            f"F_in ≤ {AF_MAX_F_IN} (use order='feature_first')"
        )
    _check_table("af_layer", vals, cols, lens, x, f_out, b)
    _require_cuda("af_layer", device)
    R, T = cols.shape
    out = torch.empty((R * TILE, f_out), dtype=x.dtype, device=device)
    _launch(
        f"k2_af_layer{sfx}", vals.data_ptr(), cols.data_ptr(), lens.data_ptr(), R, T,
        x.shape[0] // TILE, x.data_ptr(), f_in, w.data_ptr(), b.data_ptr(), out.data_ptr(),
        f_out, int(relu), _stream(device),
    )
    return out


def fused_gcn_layer_cuda(vals, cols, lens, x, w, b, order: str = "feature_first",
                         relu: bool = True) -> torch.Tensor:
    """The whole layer on the card: two launches feature-first, one
    aggregation-first."""
    operand_suffix("fused_gcn_layer", vals.dtype, x.dtype, w.dtype)
    if order == "feature_first":
        z = ff_transform(x, w, vals.dtype)
        return ff_aggregate(vals, cols, lens, z, b, relu, x.dtype)
    if order == "aggregation_first":
        return af_layer(vals, cols, lens, x, w, b, relu)
    raise ValueError(f"unknown dataflow order: {order!r}")
