"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718] — twin of
`repro.models.pna`.

Assigned config: 4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation. Each layer:

  m_ij = M(h_i, h_j)            (pre-transform MLP on endpoint features)
  agg  = ⨁ (4 aggregators × 3 degree scalers) → 12·d concat
  h_i' = U(h_i ‖ agg)           (post-transform) + residual

Messages gather sender rows from ``policy.neighbor_table(h)``: the identity
unsharded, ``[local ‖ halo]`` on a rank of an armed halo policy, whose
plan pads edge lists with weight-0 edges that ``edge_mask`` leaves out of
every statistic (and out of the degree). Every index must lie inside its
table (`repro_torch.graph.ops`).

Gathers are ``index_select``, whose backward is an ``index_add_``. The
backward of ``tab[s]`` (advanced indexing) sorts the indices and walks
each run of one index serially: on a sampled block whose hubs repeat
thousands of times it took 209 of a 263 ms PNA training step on an
H100 (``chip_smoke.py``'s ``gnn_train``). EGNN and GraphCast gather the
same way.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import degrees, multi_aggregate_edges, segment_sum
from repro_torch.nn.layers import dense_plan, init_tree, linear, params_from_numpy

__all__ = ["PNAConfig", "pna_param_plan", "pna_init", "params_from_numpy", "pna_forward", "pna_loss"]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    d_out: int = 1
    mean_log_degree: float = 2.5   # the PNA δ normalizer (train-set statistic)

    @property
    def n_agg_feats(self) -> int:
        return 4 * 3  # aggregators × scalers


def pna_param_plan(cfg: PNAConfig) -> dict:
    d = cfg.d_hidden
    p: dict = {"enc": dense_plan(cfg.d_in, d)}
    for i in range(cfg.n_layers):
        p[f"pre{i}"] = dense_plan(2 * d, d)
        p[f"post{i}"] = dense_plan(d * (1 + cfg.n_agg_feats), d)
    p["dec"] = dense_plan(d, cfg.d_out)
    return p


def pna_init(generator: torch.Generator, cfg: PNAConfig, dtype=torch.float32,
             device: str | torch.device | None = None) -> dict:
    """`pna_param_plan` drawn from ``generator`` (not JAX's numbers: carry the
    reference's across with `params_from_numpy` to compute what it does)."""
    return init_tree(generator, pna_param_plan(cfg), dtype, device)


def pna_forward(
    params: dict,
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    cfg: PNAConfig,
    policy: ShardingPolicy = NO_POLICY,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    n = x.shape[0]
    s, r = senders.long(), receivers.long()
    h = torch.relu(linear(params["enc"], x))
    if edge_mask is None:
        deg = degrees(r, n)
    else:
        # Padding edges (mask 0) must not count as neighbors.
        deg = segment_sum(edge_mask, r, n)
    logd = torch.log1p(deg)[:, None]
    amp = logd / cfg.mean_log_degree
    # A node with no in-edges gets δ / 1e-6 here, as in the reference.
    att = cfg.mean_log_degree / logd.clamp_min(1e-6)
    for i in range(cfg.n_layers):
        tab = policy.neighbor_table(h)
        msg_in = torch.cat([tab.index_select(0, s), h.index_select(0, r)], dim=-1)
        msg = torch.relu(linear(params[f"pre{i}"], msg_in))
        aggs = multi_aggregate_edges(msg, r, n, edge_mask)
        feats = [h]
        for a in ("mean", "max", "min", "std"):
            v = aggs[a]
            feats += [v, v * amp, v * att]
        h = h + torch.relu(linear(params[f"post{i}"], torch.cat(feats, dim=-1)))
        h = policy.constrain(h, "node_hidden")
    return linear(params["dec"], h)


def pna_loss(params, x, senders, receivers, target, cfg, policy=NO_POLICY) -> torch.Tensor:
    pred = pna_forward(params, x, senders, receivers, cfg, policy)
    return (pred - target).square().mean()
