"""EGNN — E(n)-Equivariant Graph Neural Network [arXiv:2102.09844] — twin of
`repro.models.egnn`.

Assigned config: 4 layers, d_hidden=64, E(n) equivariance. Per layer:

  m_ij  = φ_e(h_i, h_j, ‖x_i − x_j‖²)
  x_i' = x_i + (1/deg) Σ_j (x_i − x_j) · φ_x(m_ij)      (coordinate update)
  h_i' = φ_h(h_i, Σ_j m_ij)                              (feature update)

Equivariance holds because coordinates enter only through squared distances
and relative vectors. Senders gather from one table of ``[x ‖ h]`` a layer
(``policy.neighbor_table``: one exchange a layer on a halo rank, since x
moves every layer); ``edge_mask`` zeroes padding edges' messages and keeps
them out of the degree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import degrees, segment_sum
from repro_torch.nn.layers import init_tree, mlp_apply, mlp_plan, params_from_numpy

__all__ = ["EGNNConfig", "egnn_param_plan", "egnn_init", "params_from_numpy", "egnn_forward", "egnn_loss"]


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_out: int = 1
    coord_clamp: float = 100.0


def egnn_param_plan(cfg: EGNNConfig) -> dict:
    d = cfg.d_hidden
    p: dict = {"enc": mlp_plan([cfg.d_in, d])}
    for i in range(cfg.n_layers):
        p[f"phi_e{i}"] = mlp_plan([2 * d + 1, d, d])
        p[f"phi_x{i}"] = mlp_plan([d, d, 1])
        p[f"phi_h{i}"] = mlp_plan([2 * d, d, d])
    p["dec"] = mlp_plan([d, d, cfg.d_out])
    return p


def egnn_init(generator: torch.Generator, cfg: EGNNConfig, dtype=torch.float32,
              device: str | torch.device | None = None) -> dict:
    """`egnn_param_plan` drawn from ``generator``."""
    return init_tree(generator, egnn_param_plan(cfg), dtype, device)


def egnn_forward(
    params: dict,
    h: torch.Tensor,            # (N, d_in) node features
    x: torch.Tensor,            # (N, 3) coordinates
    senders: torch.Tensor,
    receivers: torch.Tensor,
    cfg: EGNNConfig,
    policy: ShardingPolicy = NO_POLICY,
    edge_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    n = h.shape[0]
    s, r = senders.long(), receivers.long()
    h = mlp_apply(params["enc"], h)
    if edge_mask is None:
        deg = degrees(r, n).clamp_min(1.0)
    else:
        # Padding edges (mask 0) must not count as neighbors.
        deg = segment_sum(edge_mask, r, n).clamp_min(1.0)
    mask = None if edge_mask is None else edge_mask[:, None]
    lo = torch.tensor(-cfg.coord_clamp, dtype=x.dtype, device=x.device)
    hi = torch.tensor(cfg.coord_clamp, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        xh = policy.neighbor_table(torch.cat([x, h], dim=-1))
        xt, ht = xh[:, :3], xh[:, 3:]
        rel = x.index_select(0, r) - xt.index_select(0, s)   # (E, 3)
        d2 = (rel * rel).sum(dim=-1, keepdim=True)
        m_in = torch.cat([h.index_select(0, r), ht.index_select(0, s), d2], dim=-1)
        m = mlp_apply(params[f"phi_e{i}"], m_in)              # (E, d)
        if mask is not None:
            m = m * mask
        # Coordinate update (equivariant): weighted relative vectors. The
        # clip as jnp.clip computes it, so a tie at the bound splits the
        # gradient as JAX's does.
        cw = torch.minimum(torch.maximum(mlp_apply(params[f"phi_x{i}"], m), lo), hi)
        xw = rel * cw if mask is None else rel * cw * mask
        x = x + segment_sum(xw, r, n) / deg[:, None]
        # Feature update (invariant).
        magg = segment_sum(m, r, n)
        h = h + mlp_apply(params[f"phi_h{i}"], torch.cat([h, magg], dim=-1))
        h = policy.constrain(h, "node_hidden")
    return mlp_apply(params["dec"], h), x


def egnn_loss(params, h, x, senders, receivers, target, cfg, policy=NO_POLICY) -> torch.Tensor:
    pred, _ = egnn_forward(params, h, x, senders, receivers, cfg, policy)
    return (pred - target).square().mean()
