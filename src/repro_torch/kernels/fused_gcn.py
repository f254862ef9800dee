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
* The transform (``csrc/xw_kernel.cuh``) streams X once, each row 1 KB at
  a time (512 B in bf16): one block of 8 warps per SM (`xw_blocks`) takes
  an even share of the row groups (`xw_rows`: 64 rows fp32, 48 bf16),
  copies 256 values of K of a group's rows and W's matching rows per chunk
  by 16-byte cp.async (each row's chunk as its 16-byte-aligned run: Nell's
  fp32 rows are 8-byte aligned), two chunks deep (three in bf16); each warp
  takes 32 of the 256 for all the group's rows
  (FMAs on the CUDA cores for fp32 and bf16 X, `mma.sync` fed by
  `ldmatrix` when every operand is bf16), and the warps' partials are added
  in warp order at the end of each group.
* Aggregation-first is one launch: Ã·X accumulates in shared memory, then
  the same block multiplies by W and adds bias and activation. Shared
  memory holds 128 × `AF_MAX_F_IN` fp32 sums at most, so a wider F_in is
  taken in chunks (`af_chunk`): the block streams each row's tiles once per
  chunk, and adds each chunk's product with W's matching rows to the row's
  fp32 output sum, in ascending k (one FMA chain over k, as a single pass
  would run it; the sum lives in a per-block workspace between chunks),
  with bias and activation after the last chunk. Any F_in runs; the only
  limit is the reference's (`check_af_resident`).
* **The grid divides the valid tiles, not the block-rows.** Nell's
  block-rows are skewed (the longest holds 299 tiles, the median 19), so a
  block per block-row would leave the card idle while the longest row
  streams alone. Instead the valid tiles, in (row, tile) order, each row
  followed by `ragged_row_weight` positions that stand for its epilogue,
  are one sequence of N positions, and each of G blocks takes ⌊N/G⌋ or
  ⌈N/G⌉ of them (G one wave of the card, from the kernel's occupancy, and
  no block under `MIN_TILES` positions; `ragged_split` mirrors the
  schedule in numpy). A row split over blocks is finished by the last
  block to arrive, which adds the fp32 partials in block order (the same
  bits on every run, no float atomics) and runs the epilogue; an empty
  block-row writes act(b) from exactly one block. The wrapper passes the
  prefix sum of lens plus the row weight, computed on the card with
  `torch.cumsum`, and the workspace: nothing is read back to the host, so
  a call never synchronises.
* A 128×128 fp32 tile is 64 KB, so tiles move through shared memory in
  128 × 32 chunks by asynchronous copies, two stages deep, across row
  boundaries: the next chunk is in flight while the block computes on the
  current one. Each thread owns one tile row and reads shared memory four
  floats at a time. IEEE fp32 FMAs on the CUDA cores, no tensor cores: at
  F = 16 the work is 6.1 GFLOP against 0.76 GB, bytes-bound.

**The bf16-operand mode** (the TPU kernel's, ``fused_gcn.py:57-59`` and
``:88-90``) is the same kernels instantiated on other element types, one
launcher per combination of (vals, X, W):

* fp32, fp32, fp32 — the launch names below without a suffix;
* fp32, bf16, fp32 — suffix ``_bf16``: the halo path's bf16 neighbor table
  (`repro_torch.models.gcn`), where the only rounding is the bf16 output;
* bf16, bf16, bf16 — suffix ``_bf16_all``.

Operands are widened to fp32 where the compute loop reads them and
rounded where the TPU kernel rounds: feature-first Z = X·W to vals' type,
aggregation-first Ã·X to W's type before the product with W, the output to
X's type; bias (fp32) and activation apply in fp32. bf16 halves the bytes
of what it touches (at the halo path's rank shape only the 16-wide table,
not the fp32 tiles that bound the kernel). Source rows stay in their own
type in shared memory and arrive by cp.async in 16-byte pieces (8 bf16 or 4
fp32 values) where the width is a multiple of that; the fp32 stage is the
larger, so `AF_MAX_F_IN` (240) holds for every combination. Any other
combination raises a TypeError.

On CPU tensors `repro_torch.kernels.ops.fused_gcn_layer` runs the plain
versions below; on CUDA tensors it runs the kernels or raises. Each kernel
wrapper adds one to its entry of `LAUNCHES` where it launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import library

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "AF_MAX_F_IN",
    "AF_RESIDENT_LIMIT",
    "af_chunk",
    "check_af_resident",
    "layer_smem_bytes",
    "MIN_TILES",
    "ragged_split",
    "ragged_row_weight",
    "ragged_attributes",
    "ragged_grid",
    "xw_rows",
    "xw_blocks",
    "xw_smem_bytes",
    "transform_attributes",
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
MIN_TILES = 4               # fewest positions a block of the split takes (the launchers' min_tiles)
SMEM_LIMIT = 232_448        # bytes of shared memory one H100 block may opt into
H100_SMS = 132              # an H100 SXM's SMs
_XW_KC = 256                # values of K in one transform chunk (k2::XW_KC)

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


def _padded(ft: int) -> int:
    return -(-ft // _NC) * _NC


def layer_smem_bytes(ft: int, src_dtype=torch.float32) -> int:
    """Shared memory of one ragged-layer block with an accumulator of width
    ``ft`` over source rows of ``src_dtype`` (mirrors ``k2::layer_smem_bytes``):
    per stage an fp32 adjacency chunk and 32 source rows in their own type,
    then the fp32 accumulator."""
    ftp = _padded(ft)
    return 4 * (_STAGES * TILE * (_KC + 4) + TILE * (ftp + 1)) + _STAGES * _KC * ftp * src_dtype.itemsize


# The widest chunk of the aggregation-first input one block aggregates at once,
# for every dtype combination (the fp32 stage is the larger).
AF_MAX_F_IN = max(f for f in range(_NC, 4096, _NC) if layer_smem_bytes(f) <= SMEM_LIMIT)

# The reference's bound on the aggregation-first layer's VMEM-resident set
# (`repro/kernels/ops.py::fused_gcn_layer`), bytes.
AF_RESIDENT_LIMIT = 14_000_000


def check_af_resident(f_in: int, f_out: int, block: int = TILE) -> None:
    """Raise the reference's ValueError where its aggregation-first layer
    refuses the widths: the weight, two (block, F_in) and one (block, F_out)
    fp32 buffers and one tile past 14 MB. The kernels here take any width;
    the port refuses what the reference refuses, and nothing else."""
    resident = 4 * (f_in * f_out + 2 * block * f_in + block * f_out + block * block)
    if resident > AF_RESIDENT_LIMIT:
        raise ValueError(
            f"aggregation_first fused layer needs ~{resident / 1e6:.0f} MB "
            f"VMEM-resident (F_in={f_in}, F_out={f_out}) — past the ~16 MB "
            "budget; use order='feature_first' or the unfused bsr_spmm path"
        )


def af_chunk(f_in: int) -> tuple[int, int]:
    """(chunk width, chunks) of the aggregation-first kernel at input width
    ``f_in``: one chunk of F_in itself up to `AF_MAX_F_IN`, else the fewest
    chunks of at most `AF_MAX_F_IN` columns, all of one width, a multiple of
    16 (the last one narrower)."""
    if f_in <= AF_MAX_F_IN:
        return f_in, 1
    n = -(-f_in // AF_MAX_F_IN)
    ft = _padded(-(-f_in // n))
    return ft, -(-f_in // ft)


def xw_rows(x_dtype) -> int:
    """Rows of one pass of a transform block (``k2::xw_rows``): 64 for fp32
    X, 48 for bf16."""
    return 64 if x_dtype.itemsize == 4 else 48


def xw_smem_bytes(x_dtype, w_dtype) -> int:
    """Dynamic shared memory of one transform block (mirrors
    ``k2::xw_smem_bytes``): a ring of stages (two for fp32 X, three for
    bf16), each the pass's rows of 256 values of X at a pitch of 16 bytes
    more and 256 rows of W (64 bytes fp32, 48 bf16); the warps' partial sums
    meet in the stage just computed."""
    w_pitch = _NC * 4 if w_dtype.itemsize == 4 else _NC * 2 + 16
    stages = 2 if x_dtype.itemsize == 4 else 3
    return stages * (xw_rows(x_dtype) * (_XW_KC * x_dtype.itemsize + 16) + _XW_KC * w_pitch)


def xw_blocks(M: int, x_dtype, sms: int = H100_SMS) -> int:
    """Transform blocks per 16-column block of the output (mirrors
    ``k2::xw_blocks``): one per SM, no more than the ⌈M / xw_rows⌉ row
    groups, which they share evenly."""
    return max(1, min(sms, -(-M // xw_rows(x_dtype))))


def ragged_row_weight(name: str, f_out: int) -> int:
    """The positions that stand for a row's epilogue in the split schedule:
    one, and for the aggregation-first layer, whose epilogue is the product
    with W, four more per 128 output columns: that product runs at about a
    quarter of the tiles' streaming rate (`tools/ragged_bench.py` at Nell's
    210 outputs on an H100 80GB HBM3 at 700 W: weight 7 0.63 ms, weight 2
    0.69–0.76 ms, weight 1 0.99 ms)."""
    return 1 + (4 * f_out // TILE if name.startswith("k2_af_layer") else 0)


def ragged_split(lens, T: int, grid_x: int, min_tiles: int = MIN_TILES, row_weight: int = 1) -> list[dict]:
    """The ragged kernels' split schedule, in numpy. Row r holds positions
    ``[ends[r-1], ends[r])``: its valid tiles, then ``row_weight`` positions
    for its epilogue (``ends`` the prefix sum of lens clamped to [0, T], plus
    ``row_weight``). G = min(grid_x, ⌊N / min_tiles⌋) blocks (at least one)
    take positions ``[⌊g·N/G⌋, ⌊(g+1)·N/G⌋)``. For each block: its
    positions ``[lo, hi)``, the ``(row, t0, t1)`` segments of valid tiles it
    streams, and the rows whose positions it holds (a row held by several
    blocks is split; the last of them to arrive writes its epilogue)."""
    lens = np.clip(np.asarray(lens, dtype=np.int64), 0, T)
    ends = np.cumsum(lens + row_weight)
    starts = ends - lens - row_weight
    n = int(ends[-1]) if len(lens) else 0
    G = max(1, min(grid_x, n // max(min_tiles, 1)))
    rows = np.arange(len(lens))
    blocks = []
    for g in range(G):
        lo, hi = g * n // G, (g + 1) * n // G
        t0, t1 = np.maximum(starts, lo) - starts, np.minimum(starts + lens, hi) - starts
        seg = rows[t1 > t0]
        blocks.append(dict(block=g, lo=lo, hi=hi, segments=[(int(r), int(t0[r]), int(t1[r])) for r in seg],
                           rows=[int(r) for r in rows[(starts < hi) & (ends > lo)]]))
    return blocks


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
_PLAIN_GATHER = 1 << 28     # elements of gathered source blocks the plain version holds at once


def _ragged_aggregate_plain(vals, cols, lens, src):
    """Σ_{t < lens[r]} vals[r, t] @ src_block[cols[r, t]] as (R·B, F) in fp32,
    reading only the valid tiles; the source blocks are gathered a slice of
    columns at a time, so that a wide F (Nell's valid tiles at F = 9,029:
    54 GB at once) fits the card."""
    R, T, B, _ = vals.shape
    F = src.shape[1]
    valid = torch.arange(T, device=vals.device)[None, :] < lens[:, None]
    r_idx, t_idx = valid.nonzero(as_tuple=True)
    tiles = vals[r_idx, t_idx].float()                                   # (nnz, B, B)
    rows = cols[r_idx, t_idx].long()
    src_blocks = src.reshape(-1, B, F)
    step = max(1, _PLAIN_GATHER // max(rows.numel() * B, 1))
    acc = tiles.new_zeros((R, B, F))
    for f0 in range(0, F, step):
        blocks = src_blocks[rows, :, f0:f0 + step].float()              # (nnz, B, ≤ step)
        acc[:, :, f0:f0 + step].index_add_(0, r_idx, torch.bmm(tiles, blocks))
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
    split = [I, I, I, P, P, P]    # grid_x, row_weight, min_tiles, part, arrivals, prods
    args = {
        "k2_ff_transform": [P, P, P, I, I, I, P],
        "k2_ff_aggregate": [P, P, P, I, I, I, P, P, P, I, I, I, *split, P],
        "k2_af_layer": [P, P, P, I, I, I, P, I, I, P, P, P, I, I, *split, P, P],
    }
    signatures = {f"{k}{sfx}": a for k, a in args.items() for sfx in _SUFFIX.values()}
    signatures.update({name: [P, P, P, I, I, I, P, P, I, I, *split, P] for name in K1_NAMES.values()})
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.k2_ragged_attributes.argtypes, lib.k2_ragged_attributes.restype = [I, I, I, P, P, P], ctypes.c_int
    lib.k2_ff_transform_attributes.argtypes, lib.k2_ff_transform_attributes.restype = [I, P, P, P], ctypes.c_int
    lib.k2_xw_blocks.argtypes, lib.k2_xw_blocks.restype = [I, I, I], ctypes.c_int
    lib.k2_xw_smem_bytes.argtypes, lib.k2_xw_smem_bytes.restype = [I, I], ctypes.c_longlong
    lib.k2_layer_smem_bytes.argtypes, lib.k2_layer_smem_bytes.restype = [I, I], ctypes.c_longlong
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


# The ragged launchers' (mode, combo) in k2_ragged_attributes.
_RAGGED_MODE = {"k2_ff_aggregate": 0, "k2_af_layer": 1, "k1_bsr_spmm": 2}
_COMBO = {"": 0, "_bf16": 1, "_bf16_all": 2}


def _ragged_id(name: str) -> tuple[int, int]:
    for base, mode in _RAGGED_MODE.items():
        if name.startswith(base) and name[len(base):] in _COMBO:
            return mode, _COMBO[name[len(base):]]
    raise ValueError(f"{name} is not a ragged launcher; they are {sorted(_RAGGED_MODE)} with suffixes {list(_COMBO)}")


@functools.cache
def ragged_attributes(name: str, ft: int) -> dict:
    """What the compiler gave the ragged instantiation of launcher ``name``,
    read from the card (``cudaFuncGetAttributes``): registers a thread, local
    memory a thread (spills; 0 when none) and the blocks that fit one SM at
    accumulator width ``ft``."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    lib = _lib()
    err = lib.k2_ragged_attributes(*_ragged_id(name), ft, ctypes.byref(regs), ctypes.byref(local),
                                   ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"k2_ragged_attributes({name}, {ft}): CUDA error {err} ({lib.k2_error_string(err).decode()})")
    return dict(registers=regs.value, local_bytes=local.value, blocks_per_sm=blocks.value)


@functools.cache
def transform_attributes(name: str) -> dict:
    """What the compiler gave the transform instantiation of launcher
    ``name`` (``k2_ff_transform`` and its suffixes), read from the card:
    registers a thread, local memory a thread (spills; 0 when none) and the
    blocks that fit one SM."""
    sfx = name.removeprefix("k2_ff_transform")
    if not name.startswith("k2_ff_transform") or sfx not in _COMBO:
        raise ValueError(f"{name} is not a transform launcher; they are k2_ff_transform with suffixes {list(_COMBO)}")
    regs, local, blocks = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    lib = _lib()
    err = lib.k2_ff_transform_attributes(_COMBO[sfx], ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"k2_ff_transform_attributes({name}): CUDA error {err} ({lib.k2_error_string(err).decode()})")
    return dict(registers=regs.value, local_bytes=local.value, blocks_per_sm=blocks.value)


@functools.cache
def ragged_grid(name: str, ft: int, device_index: int) -> int:
    """Blocks of the split schedule's grid: one wave of the card (its SMs ×
    the blocks of the instantiation that fit one)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(1, sms * ragged_attributes(name, ft)["blocks_per_sm"])


def _split_args(name: str, cols, lens, ft: int, grid_y: int, f_out: int, device: torch.device,
                chunks: int = 1):
    """(tensors to keep alive, the launcher's leading ``ends`` pointer and
    trailing split arguments): the prefix sum of lens clamped to [0, T] plus
    the row weight, and the workspace, made on the card without reading
    anything back: fresh arrival counters, zeroed, for every launch. The
    aggregation-first layer's split-row partials take one slot per chunk of
    F_in (``chunks``): 2 · grid · chunks · 128 · ftp floats, 128 × F_in a
    block and side in all (at F_in = 9,029 on 132 blocks, 1.2 GB).

    K1 with a bf16 Z keeps the rounded product of every tile of a split row
    in ``prods``, indexed by position. Without reading lens back, the wrapper
    sizes it for every position the table could hold: R · (T + 1) · grid_y ·
    128 · ftp bf16 values, where the valid tiles need only N · 128 · F (rank
    0 of the halo plan, 141 × 248 at F = 16: 144 MB against 32.5 MB; a
    514 × 299 table at F = 210 would need 10.1 GB). A workspace larger than
    the card's memory less what torch holds raises a MemoryError here."""
    R, T = cols.shape
    ftp = _padded(ft)
    grid_x = ragged_grid(name, ft, device.index if device.index is not None else torch.cuda.current_device())
    weight = ragged_row_weight(name, f_out)
    per_tile = name.startswith("k1_bsr_spmm") and name != "k1_bsr_spmm"     # K1 with a bf16 Z
    n_prods = R * (T + weight) * grid_y * TILE * ftp if per_tile else 0
    if n_prods:
        free = torch.cuda.get_device_properties(device).total_memory - torch.cuda.memory_allocated(device)
        if 2 * n_prods > free:
            raise MemoryError(
                f"{name}: the per-tile product workspace of a {R} × {T} table at width {f_out} needs "
                f"{2 * n_prods} bytes (R · (T + 1) · {grid_y} · {TILE} · {ftp} bf16 values), more than the "
                f"{free} bytes the card has outside torch's allocations; an fp32 Z needs no such workspace"
            )
    ends = torch.cumsum(lens.clamp(0, T) + weight, 0, dtype=torch.int32)
    part = torch.empty(0 if per_tile else 2 * grid_x * grid_y * chunks * TILE * ftp, dtype=torch.float32,
                       device=device)
    arrivals = torch.zeros(R * grid_y, dtype=torch.int32, device=device)
    prods = torch.empty(n_prods, dtype=torch.int16, device=device)
    keep = (ends, part, arrivals, prods)
    return keep, ends.data_ptr(), (grid_x, weight, MIN_TILES, part.data_ptr(), arrivals.data_ptr(), prods.data_ptr())


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
    name, ft = f"k2_ff_aggregate{sfx}", min(f_out, FF_F_TILE)
    out = torch.empty((R * TILE, f_out), dtype=out_dtype, device=device)
    _keep, ends, split = _split_args(name, cols, lens, ft, -(-f_out // ft), f_out, device)
    _launch(
        name, vals.data_ptr(), cols.data_ptr(), ends, R, T, z.shape[0] // TILE, z.data_ptr(), b.data_ptr(),
        out.data_ptr(), f_out, ft, int(relu), *split, _stream(device),
    )
    return out


def af_layer(vals, cols, lens, x, w, b, relu: bool = True) -> torch.Tensor:
    """act((Ã · X) · W + b) on the card, one launch, F_in in chunks of
    `af_chunk`; output in X's dtype."""
    device = _check("af_layer", vals=vals, cols=cols, lens=lens, x=x, w=w, b=b)
    sfx = operand_suffix("af_layer", vals.dtype, x.dtype, w.dtype)
    f_in, f_out = w.shape
    if x.shape[1] != f_in or f_in < 1:
        raise ValueError(f"af_layer: x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    check_af_resident(f_in, f_out)
    _check_table("af_layer", vals, cols, lens, x, f_out, b)
    _require_cuda("af_layer", device)
    R, T = cols.shape
    name = f"k2_af_layer{sfx}"
    ft, chunks = af_chunk(f_in)
    out = torch.empty((R * TILE, f_out), dtype=x.dtype, device=device)
    keep, ends, split = _split_args(name, cols, lens, ft, 1, f_out, device, chunks)
    grid_x = split[0]
    osum = torch.empty(grid_x * TILE * f_out if chunks > 1 else 0, dtype=torch.float32, device=device)
    _launch(
        name, vals.data_ptr(), cols.data_ptr(), ends, R, T, x.shape[0] // TILE, x.data_ptr(), f_in, ft,
        w.data_ptr(), b.data_ptr(), out.data_ptr(), f_out, int(relu), *split, osum.data_ptr(), _stream(device),
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
