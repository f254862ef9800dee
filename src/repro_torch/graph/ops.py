"""Message-passing primitives over edge lists — twin of `repro.graph.ops`.

Aggregation ``O = A·Z`` as gather(senders) → weight → segment-reduce
(receivers), with `index_add_` for sums. This segment backend is the
cross-check of the blocked kernels on the host and on the card. Ghost-padded
edges (receiver == n_nodes) accumulate into an extra row that
`aggregate_padded` slices off.
"""
from __future__ import annotations

import torch

__all__ = ["aggregate", "aggregate_padded", "sym_norm_edge_weights", "degrees"]


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def degrees(receivers: torch.Tensor, num_nodes: int) -> torch.Tensor:
    return _segment_sum(
        torch.ones(receivers.shape, dtype=torch.float32, device=receivers.device),
        receivers, num_nodes,
    )


def sym_norm_edge_weights(
    senders: torch.Tensor, receivers: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """D^-1/2 Ã D^-1/2 edge weights (Kipf–Welling normalization)."""
    inv_r = torch.rsqrt(degrees(receivers, num_nodes).clamp_min(1.0))
    inv_s = torch.rsqrt(degrees(senders, num_nodes).clamp_min(1.0))
    return inv_s[senders.long()] * inv_r[receivers.long()]


def aggregate(
    features: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """O[r] = Σ_{(s,r) ∈ E} w_sr · Z[s] — the GCN aggregation stage (sum;
    the other reductions arrive with the model families that use them)."""
    msgs = features[senders.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return _segment_sum(msgs, receivers, num_nodes)


def aggregate_padded(
    features: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Aggregation when edges are ghost-padded: a zero ghost row is appended
    to the features, the segment space is num_nodes+1, and the ghost row is
    dropped."""
    feats = torch.cat([features, torch.zeros_like(features[:1])], dim=0)
    return aggregate(feats, senders, receivers, num_nodes + 1, edge_weight)[:num_nodes]
