"""GraphCast-style encoder–processor–decoder mesh GNN [arXiv:2212.12794] —
twin of `repro.models.graphcast`.

Assigned config: 16 processor layers, d_hidden=512, sum aggregator,
n_vars=227, mesh_refinement=6. The stack runs over the given graph (the
paper's grid↔mesh mapping becomes the generic node/edge featurization;
``mesh_refinement`` sizes the native icosphere mesh of `icosphere_sizes`).
Processor layers are interaction networks with persistent edge latents and
residual connections.

Senders gather from ``policy.neighbor_table(h)``, one exchange a layer on
a halo rank. Edge latents live on the receiving rank's edges, padding
edges included: they evolve there but ``edge_mask`` keeps them out of the
sum. ``remat`` runs each processor layer under
`torch.utils.checkpoint.checkpoint` (non-reentrant): the same arithmetic,
with one layer's activations alive at a time in the backward (a float64
gradient of the full config on the R6 mesh needs it).

`relative_edge_feats` gives each edge ``[p_r − p_s, ‖p_r − p_s‖]``
(``d_edge_in`` = 4) from node positions, so a rank computes its edges'
features from its neighbor table of positions with no edge permutation.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import segment_sum
from repro_torch.nn.layers import Draw, init_tree, layer_norm, mlp_apply, mlp_plan, params_from_numpy

__all__ = [
    "GraphCastConfig",
    "graphcast_param_plan",
    "graphcast_init",
    "params_from_numpy",
    "graphcast_forward",
    "graphcast_loss",
    "icosphere_sizes",
    "relative_edge_feats",
]


def icosphere_sizes(refinement: int) -> tuple[int, int]:
    """(nodes, directed edges) of the refined icosahedral mesh: R6 → 40 962
    nodes / 245 760 edges (GraphCast's native processor mesh)."""
    n_nodes = 10 * 4**refinement + 2
    n_edges_undirected = 30 * 4**refinement
    return n_nodes, 2 * n_edges_undirected


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227               # output variables per node
    mesh_refinement: int = 6
    d_edge_in: int = 4              # relative-position edge features
    d_in: int | None = None         # input width; defaults to n_vars (native)

    @property
    def input_dim(self) -> int:
        return self.n_vars if self.d_in is None else self.d_in

    @property
    def residual_output(self) -> bool:
        return self.input_dim == self.n_vars


def _ln_plan(d: int) -> dict:
    return {"g": Draw((d,), "ones"), "b": Draw((d,), "zeros")}


def graphcast_param_plan(cfg: GraphCastConfig) -> dict:
    d = cfg.d_hidden
    p: dict = {
        "enc_node": mlp_plan([cfg.input_dim, d, d]),
        "enc_edge": mlp_plan([cfg.d_edge_in, d, d]),
        "enc_node_ln": _ln_plan(d),
        "enc_edge_ln": _ln_plan(d),
    }
    for i in range(cfg.n_layers):
        p[f"edge_mlp{i}"] = mlp_plan([3 * d, d, d])
        p[f"node_mlp{i}"] = mlp_plan([2 * d, d, d])
        p[f"edge_ln{i}"] = _ln_plan(d)
        p[f"node_ln{i}"] = _ln_plan(d)
    p["dec"] = mlp_plan([d, d, cfg.n_vars])
    return p


def graphcast_init(generator: torch.Generator, cfg: GraphCastConfig, dtype=torch.float32,
                   device: str | torch.device | None = None) -> dict:
    """`graphcast_param_plan` drawn from ``generator``."""
    return init_tree(generator, graphcast_param_plan(cfg), dtype, device)


def relative_edge_feats(pos_table: torch.Tensor, pos: torch.Tensor, senders: torch.Tensor,
                        receivers: torch.Tensor) -> torch.Tensor:
    """(E, 4) ``[p_r − p_s, ‖p_r − p_s‖]``: receivers index ``pos``, senders
    ``pos_table`` (``pos`` itself unsharded, ``policy.neighbor_table(pos)``
    on a halo rank)."""
    rel = pos[receivers.long()] - pos_table[senders.long()]
    return torch.cat([rel, rel.norm(dim=-1, keepdim=True)], dim=-1)


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return layer_norm(x, p["g"], p["b"])


def _processor_layer(p: tuple, h: torch.Tensor, e: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
                     mask: torch.Tensor | None, policy: ShardingPolicy) -> tuple[torch.Tensor, torch.Tensor]:
    """One interaction network: update edges, then nodes; residual + LN both."""
    edge_mlp, edge_ln, node_mlp, node_ln = p
    tab = policy.neighbor_table(h)
    e_in = torch.cat([e, tab.index_select(0, s), h.index_select(0, r)], dim=-1)
    e = e + _ln(mlp_apply(edge_mlp, e_in), edge_ln)
    # Padding-edge latents evolve but never aggregate.
    agg = segment_sum(e if mask is None else e * mask, r, h.shape[0])      # sum aggregator
    h = h + _ln(mlp_apply(node_mlp, torch.cat([h, agg], dim=-1)), node_ln)
    return policy.constrain(h, "node_hidden"), e


def graphcast_forward(
    params: dict,
    x: torch.Tensor,                 # (N, input_dim) node variables
    edge_feats: torch.Tensor,        # (E, d_edge_in) e.g. relative positions
    senders: torch.Tensor,
    receivers: torch.Tensor,
    cfg: GraphCastConfig,
    policy: ShardingPolicy = NO_POLICY,
    edge_mask: torch.Tensor | None = None,
    remat: bool = False,
) -> torch.Tensor:
    s, r = senders.long(), receivers.long()
    h = _ln(mlp_apply(params["enc_node"], x), params["enc_node_ln"])
    e = _ln(mlp_apply(params["enc_edge"], edge_feats), params["enc_edge_ln"])
    mask = None if edge_mask is None else edge_mask[:, None]
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = tuple(params[f"{name}{i}"] for name in ("edge_mlp", "edge_ln", "node_mlp", "node_ln"))
        if remat:
            h, e = checkpoint(_processor_layer, p, h, e, s, r, mask, policy, use_reentrant=False)
        else:
            h, e = _processor_layer(p, h, e, s, r, mask, policy)
    out = mlp_apply(params["dec"], h)
    return x + out if cfg.residual_output else out   # residual prediction (GraphCast)


def graphcast_loss(params, x, edge_feats, senders, receivers, target, cfg, policy=NO_POLICY) -> torch.Tensor:
    pred = graphcast_forward(params, x, edge_feats, senders, receivers, cfg, policy)
    return (pred - target).square().mean()
