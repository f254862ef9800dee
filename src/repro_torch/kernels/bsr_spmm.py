"""The ragged 128×128 block-sparse product on Hopper (K1), with its plain
version — twin of `repro.kernels.bsr_spmm`.

    out[r·B:(r+1)·B, :] = Σ_{t < lens[r]} vals[r, t] @ Z[cols[r, t]·B : (cols[r, t]+1)·B, :]

in fp32 at any width F, over the tables of
`repro_torch.graph.structure.blocked_adjacency`. Z may hold more block-rows
than the output (the rectangular ``[local ‖ halo]`` tables of the halo path).

Source note
-----------
**Replaces** ``src/repro/kernels/bsr_spmm.py::bsr_spmm_pallas`` (body
``_kernel``, line 66; ``pallas_call`` at line 112).

**What bounds it on the H100: bytes.** It must read every valid tile once.
At Nell's aggregation-first recompute (Ã·h1, F = 16; 11,662 valid tiles)
that is 0.76 GB of tiles against 4 MB of Z and of output: 0.23 ms at
3.35 TB/s, against 6.1 GFLOP, 0.09 ms at the 67 TFLOP/s fp32 rate of the
CUDA cores.

**What the design does about it.** It is the aggregation loop of the fused
layer's kernel, not a copy of it: ``ragged_layer_kernel<2>`` in
``csrc/fused_gcn_kernels.cuh`` runs the same staging loop as K2's
feature-first aggregation (one block per block-row and feature tile, a loop
over its own tiles ``t < lens[r]``, 128 × 32 chunks copied asynchronously
two stages deep) and stores the accumulator as it is: no bias, no
activation. Padding tiles are never read; an empty block-row writes zeros.
The TPU's lane padding and ``f_tile`` do not carry over: columns past F are
masked in the staging loads. Like K2's aggregation, the block that owns the
longest block-row sets its time (PERF.md).

On CPU tensors `repro_torch.kernels.ops.bsr_spmm` runs `bsr_spmm_plain`;
on CUDA tensors it runs `bsr_spmm` or raises. The wrapper adds one to
``LAUNCHES["k1_bsr_spmm"]`` where it launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gcn import (
    FF_F_TILE,
    TILE,
    _check,
    _check_table,
    _launch,
    _ragged_aggregate_plain,
    _require_cuda,
    _stream,
)

__all__ = ["bsr_spmm", "bsr_spmm_plain"]


def bsr_spmm_plain(vals, cols, lens, z) -> torch.Tensor:
    """Σ_{t < lens[r]} vals[r, t] @ Z_block[cols[r, t]] as (R·B, F), reading
    only the valid tiles."""
    return _ragged_aggregate_plain(vals, cols, lens, z)


def bsr_spmm(vals, cols, lens, z) -> torch.Tensor:
    """Ã · Z on the card, one launch; Z's rows a positive multiple of 128.
    fp32 only: K1's bf16 mode comes with halo training (ROADMAP)."""
    device = _check("bsr_spmm", vals=vals, cols=cols, lens=lens, z=z)
    if vals.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"bsr_spmm takes float32 vals and z, got {vals.dtype} and {z.dtype}")
    f = z.shape[1]
    _check_table("bsr_spmm", vals, cols, lens, z, f)
    _require_cuda("bsr_spmm", device)
    R, T = cols.shape
    out = torch.empty((R * TILE, f), dtype=torch.float32, device=device)
    _launch(
        "k1_bsr_spmm", vals.data_ptr(), cols.data_ptr(), lens.data_ptr(), R, T,
        z.shape[0] // TILE, z.data_ptr(), out.data_ptr(), f, min(f, FF_F_TILE), _stream(device),
    )
    return out
