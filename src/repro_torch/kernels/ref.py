"""Plain PyTorch oracles of the blocked kernels — twin of `repro.kernels.ref`,
plus `poison_padding` (twin of `repro.kernels.bsr_spmm.poison_padding`)."""
from __future__ import annotations

import torch

__all__ = ["bsr_spmm_ref", "fused_gcn_layer_ref", "poison_padding"]


def bsr_spmm_ref(vals: torch.Tensor, cols: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Dense-gather oracle: out[r] = Σ_t vals[r,t] @ Z_block[cols[r,t]].

    Ignores the ragged lengths on purpose — padding tiles are zero, so the
    dense-T sum equals the ragged kernel's skip-padding sum exactly.
    """
    R, T, B, _ = vals.shape
    F = z.shape[1]
    zb = z.reshape(-1, B, F)                       # (Cb, B, F)
    gathered = zb[cols.long()]                     # (R, T, B, F)
    return torch.einsum("rtij,rtjf->rif", vals, gathered).reshape(R * B, F)


def fused_gcn_layer_ref(
    vals: torch.Tensor, cols: torch.Tensor, z_or_x: torch.Tensor,
    w: torch.Tensor, b: torch.Tensor,
    order: str = "feature_first", relu: bool = True,
) -> torch.Tensor:
    """Unfused oracle of the fused GCN layer: the same layer as three
    separate fp32 ops."""
    x = z_or_x.float()
    if order == "feature_first":
        h = bsr_spmm_ref(vals.float(), cols, x @ w.float())
    else:
        h = bsr_spmm_ref(vals.float(), cols, x) @ w.float()
    h = h + b.reshape(1, -1).float()
    return h.clamp_min(0.0) if relu else h


def poison_padding(vals: torch.Tensor, lens: torch.Tensor, poison: float = float("nan")) -> torch.Tensor:
    """Copy of ``vals`` (R, T, B, B) with every padding tile (t ≥ lens[r]) set
    to ``poison``, on the tensors' own device.

    The ragged-skip contract says the kernels NEVER read those tiles: running
    a layer on a poisoned copy and finding the output finite proves it.
    """
    T = vals.shape[1]
    pad = torch.arange(T, device=vals.device)[None, :] >= lens.to(vals.device)[:, None]
    out = vals.clone()
    out[pad] = poison
    return out
