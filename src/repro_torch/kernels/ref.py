"""Plain PyTorch oracles of the kernels — twin of `repro.kernels.ref` (the
blocked products, DeepFM's FM term and the LM's flash attention), plus
`poison_padding` (twin of `repro.kernels.bsr_spmm.poison_padding`)."""
from __future__ import annotations

import torch

__all__ = ["bsr_spmm_ref", "fused_gcn_layer_ref", "fm_interaction_ref", "flash_attention_ref", "poison_padding"]


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


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B,): ½·Σ_d[(Σ_f e)² − Σ_f e²], accumulated in fp32 (in
    float64 for a float64 emb) and returned in emb's dtype."""
    e = emb.to(torch.promote_types(emb.dtype, torch.float32))
    s = e.sum(dim=1)
    sq = (e * e).sum(dim=1)
    return (0.5 * (s * s - sq).sum(dim=-1)).to(emb.dtype)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    window: int | None = None, causal: bool = True,
) -> torch.Tensor:
    """Dense oracle of the flash-attention kernel over (BH, S, d): scores in
    q's dtype, widened to fp32 and scaled by d^-0.5, the −1e30 mask
    (``k > q − window``, and ``k ≤ q`` when causal), softmax in fp32, the
    weights cast to v's dtype for the product with v."""
    BH, S, d = q.shape
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * (d ** -0.5)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    win = S if window is None else window
    valid = kp > qp - win
    if causal:
        valid &= kp <= qp
    s = torch.where(valid[None], s, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v)


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
