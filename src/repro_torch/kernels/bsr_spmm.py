"""The ragged 128×128 block-sparse product on Hopper (K1), with its plain
version — twin of `repro.kernels.bsr_spmm`.

    out[r·B:(r+1)·B, :] = Σ_{t < lens[r]} vals[r, t] @ Z[cols[r, t]·B : (cols[r, t]+1)·B, :]

at any width F, over the tables of
`repro_torch.graph.structure.blocked_adjacency`. Z may hold more block-rows
than the output (the rectangular ``[local ‖ halo]`` tables of the halo path).
The output has Z's dtype, as the reference's ``out_shape``. (vals, Z) are
fp32 and fp32, fp32 and bf16 (the halo path's bf16 table, in the
aggregation-first recompute), or bf16 and bf16. With a bf16 Z the reference
adds each tile's product into its bf16 output block, so the running sum is
rounded after every tile: ``acc = bf16(acc + bf16(vals[r,t] @ Z_blk))``,
the tile product in fp32 (`bsr_spmm.py:81-83`). Kernel and plain version
both do that; rounding once at the end is a different result.

Source note
-----------
**Replaces** ``src/repro/kernels/bsr_spmm.py::bsr_spmm_pallas`` (body
``_kernel``, line 66; ``pallas_call`` at line 112).

**What bounds it on the H100: bytes.** It must read every valid tile once.
At Nell's aggregation-first recompute (Ã·h1, F = 16; 11,662 valid tiles)
that is 0.76 GB of tiles against 4 MB of Z and of output: 0.23 ms at
3.35 TB/s, against 6.1 GFLOP, 0.09 ms at the 67 TFLOP/s fp32 rate of the
CUDA cores. The bf16 mode at rank 0 of the sharded Nell (7,940 valid fp32
tiles, 0.52 GB, and a 55,424 × 16 bf16 table) is bound at about 0.156 ms.

**What the design does about it.** It is the aggregation loop of the fused
layer's kernel, not a copy of it: ``ragged_layer_kernel<2>`` in
``csrc/fused_gcn_kernels.cuh`` runs the same schedule as K2's aggregations
and stores the accumulator as it is: no bias, no activation. The grid
divides the valid tiles, not the block-rows: each block streams an even
share of the N valid tiles (``fused_gcn.ragged_split``) in 128 × 32 chunks
copied asynchronously two stages deep, and a block-row split over several
blocks is finished by the last of them to arrive, which adds the fp32
partials in block order. So Nell's 299-tile block-row no longer sets the
time, no float is added atomically and the bits are the same on every
run. Padding tiles are never read; an empty block-row writes zeros. The
TPU's lane padding and ``f_tile`` do not carry over: columns past F are
masked in the staging loads.

**How the bf16 mode keeps the reference's rounding chain.** The running
sum ``acc = bf16(acc + bf16(P_t))`` must run in tile order, but each tile's
product P_t = vals[r,t] @ Z_blk depends on nothing else. A block-row held
whole by one block runs the chain in that block, as before. For a split
block-row every block computes the products of its own tiles in fp32 and
writes them, rounded to bf16, to a workspace indexed by tile position; the
block that finishes the row then runs the chain over all of its products
in order. Every rounding is the one `bsr_spmm_plain` (``_rounded_per_tile``)
makes. The workspace is sized for every position the table could hold,
R · (T + 1) · 128 · F bf16 values (144 MB at rank 0 of the halo plan,
against the 32.5 MB its valid tiles need), since lens is not read back;
`fused_gcn._split_args` raises before an allocation the card cannot hold.
bf16 Z rows reach shared memory by cp.async in 16-byte pieces and
are widened where the compute loop reads them.

On CPU tensors `repro_torch.kernels.ops.bsr_spmm` runs `bsr_spmm_plain`;
on CUDA tensors it runs `bsr_spmm` or raises. The wrapper adds one to its
launcher's entry of ``LAUNCHES`` (``k1_bsr_spmm``, ``k1_bsr_spmm_bf16``,
``k1_bsr_spmm_bf16_all``) where it launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gcn import (
    FF_F_TILE,
    K1_NAMES,
    TILE,
    _check,
    _check_table,
    _launch,
    _ragged_aggregate_plain,
    _require_cuda,
    _split_args,
    _stream,
)

__all__ = ["bsr_spmm", "bsr_spmm_plain", "k1_name"]


def k1_name(vals_dtype, z_dtype) -> str:
    """The launcher of K1's (vals, Z) dtype combination, or a TypeError
    naming the combinations it takes."""
    try:
        return K1_NAMES[(vals_dtype, z_dtype)]
    except KeyError:
        taken = "; ".join(f"({', '.join(str(d).removeprefix('torch.') for d in c)})" for c in K1_NAMES)
        raise TypeError(f"bsr_spmm takes (vals, z) dtypes {taken}; got ({vals_dtype}, {z_dtype})") from None


def _rounded_per_tile(vals, cols, lens, z) -> torch.Tensor:
    """The reference's bf16 running sum: for t < lens[r] in order,
    acc[r] = round(acc[r] + round(vals[r, t] @ Z_block[cols[r, t]])), each
    tile product in fp32, each rounding to Z's dtype. Reads only the valid
    tiles."""
    R, _, B, _ = vals.shape
    F = z.shape[1]
    zb = z.reshape(-1, B, F)
    acc = z.new_zeros((R, B, F))
    lens = lens.long()
    for t in range(int(lens.max()) if R else 0):
        r_idx = (lens > t).nonzero(as_tuple=True)[0]
        tile = torch.bmm(vals[r_idx, t].float(), zb[cols[r_idx, t].long()].float()).to(z.dtype)
        acc[r_idx] = (acc[r_idx].float() + tile.float()).to(z.dtype)
    return acc.reshape(R * B, F)


def bsr_spmm_plain(vals, cols, lens, z) -> torch.Tensor:
    """Σ_{t < lens[r]} vals[r, t] @ Z_block[cols[r, t]] as (R·B, F) in Z's
    dtype, reading only the valid tiles: in fp32 for an fp32 Z, with the
    running sum rounded per tile for a bf16 Z."""
    if z.dtype == torch.float32:
        return _ragged_aggregate_plain(vals, cols, lens, z)
    return _rounded_per_tile(vals, cols, lens, z)


def bsr_spmm(vals, cols, lens, z) -> torch.Tensor:
    """Ã · Z on the card, one launch; Z's rows a positive multiple of 128;
    (vals, Z) fp32 and fp32, fp32 and bf16, or bf16 and bf16; the output in
    Z's dtype."""
    device = _check("bsr_spmm", vals=vals, cols=cols, lens=lens, z=z)
    name = k1_name(vals.dtype, z.dtype)
    f = z.shape[1]
    _check_table("bsr_spmm", vals, cols, lens, z, f)
    _require_cuda("bsr_spmm", device)
    R, T = cols.shape
    ft = min(f, FF_F_TILE)
    out = torch.empty((R * TILE, f), dtype=z.dtype, device=device)
    _keep, ends, split = _split_args(name, cols, lens, ft, -(-f // ft), f, device)
    _launch(
        name, vals.data_ptr(), cols.data_ptr(), ends, R, T, z.shape[0] // TILE, z.data_ptr(), out.data_ptr(),
        f, ft, *split, _stream(device),
    )
    return out
