"""Message-passing primitives over edge lists — twin of `repro.graph.ops`.

Aggregation ``O = A·Z`` as gather(senders) → weight → segment-reduce
(receivers), with `index_add_` for sums and `scatter_reduce` for max and
min. This segment backend is the cross-check of the blocked kernels on the
host and on the card. Ghost-padded edges (receiver == n_nodes) accumulate
into an extra row that `aggregate_padded` slices off.

Indices must lie inside the segment space (JAX drops an out-of-range
segment id; torch raises, and on the card traps). Max and min keep JAX's
semantics: an empty segment is −inf / +inf, and ties share the gradient
equally (``segment_max`` starts from −inf, so the starting value never ties
with a finite maximum).
"""
from __future__ import annotations

import torch

__all__ = [
    "aggregate",
    "aggregate_padded",
    "sym_norm_edge_weights",
    "degrees",
    "segment_sum",
    "segment_max",
    "segment_min",
    "multi_aggregate",
    "multi_aggregate_edges",
]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over the leading axis."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def _segment_extreme(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     reduce: str) -> torch.Tensor:
    # Start from the reduction's identity (−inf for a max): a segment's result
    # then ties only with its own entries, and the backward splits the
    # gradient over them as JAX does. Starting from zeros would count the
    # zero as one more tie wherever a segment's maximum is 0.
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce, include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: −inf for an empty segment."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: +inf for an empty segment."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def _zero_nonfinite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _std(sqsum: torch.Tensor, mean: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    # torch.maximum, not clamp_min: on a tie (a one-edge segment's variance
    # is exactly 0) JAX's maximum passes half the gradient, clamp_min all.
    var = torch.maximum(sqsum / cnt - mean * mean, torch.zeros_like(mean))
    return torch.sqrt(var + 1e-8)


def degrees(receivers: torch.Tensor, num_nodes: int) -> torch.Tensor:
    return segment_sum(
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
    reduce: str = "sum",
) -> torch.Tensor:
    """O[r] = reduce_{(s,r) ∈ E} w_sr · Z[s] — the GCN aggregation stage;
    ``reduce`` is "sum", "mean", "max" or "min" (an empty segment's max or
    min is −inf / +inf, as in JAX)."""
    msgs = features[senders.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if reduce == "sum":
        return segment_sum(msgs, receivers, num_nodes)
    if reduce == "mean":
        total = segment_sum(msgs, receivers, num_nodes)
        return total / degrees(receivers, num_nodes).clamp_min(1.0)[:, None]
    if reduce == "max":
        return segment_max(msgs, receivers, num_nodes)
    if reduce == "min":
        return segment_min(msgs, receivers, num_nodes)
    raise ValueError(f"unknown reduce: {reduce!r}")


def aggregate_padded(
    features: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
    reduce: str = "sum",
) -> torch.Tensor:
    """Aggregation when edges are ghost-padded: a zero ghost row is appended
    to the features, the segment space is num_nodes+1, and the ghost row is
    dropped."""
    feats = torch.cat([features, torch.zeros_like(features[:1])], dim=0)
    return aggregate(feats, senders, receivers, num_nodes + 1, edge_weight, reduce)[:num_nodes]


def multi_aggregate(
    features: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """PNA-style parallel aggregators computed off shared messages:
    mean / max / min / std (std via E[x²]−E[x]² on the same segments);
    an empty segment's max and min are 0."""
    msgs = features[senders.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    ssum = segment_sum(msgs, receivers, num_nodes)
    sqsum = segment_sum(msgs * msgs, receivers, num_nodes)
    cnt = degrees(receivers, num_nodes).clamp_min(1.0)[:, None]
    mean = ssum / cnt
    return {
        "mean": mean,
        "max": _zero_nonfinite(segment_max(msgs, receivers, num_nodes)),
        "min": _zero_nonfinite(segment_min(msgs, receivers, num_nodes)),
        "std": _std(sqsum, mean, cnt),
    }


def multi_aggregate_edges(
    messages: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """PNA aggregators over per-edge messages (already gathered/transformed).

    edge_mask: optional (E,) 0/1 validity — masked edges are excluded from
    every statistic (count, mean, std, max, min): they enter the max and
    min as ∓inf, so a segment whose edges are all masked is empty there too.
    Used by the halo path, whose plan pads edge lists with weight-0 edges,
    and by graph serving's ghost-padded blocks.
    """
    if edge_mask is None:
        msum = messages
        cnt = degrees(receivers, num_nodes).clamp_min(1.0)[:, None]
        mmax = mmin = messages
    else:
        m = edge_mask[:, None]
        msum = messages * m
        cnt = segment_sum(edge_mask, receivers, num_nodes).clamp_min(1.0)[:, None]
        valid = m > 0
        mmax = torch.where(valid, messages, float("-inf"))
        mmin = torch.where(valid, messages, float("inf"))
    ssum = segment_sum(msum, receivers, num_nodes)
    sqsum = segment_sum(msum * messages, receivers, num_nodes)
    mean = ssum / cnt
    return {
        "mean": mean,
        "max": _zero_nonfinite(segment_max(mmax, receivers, num_nodes)),
        "min": _zero_nonfinite(segment_min(mmin, receivers, num_nodes)),
        "std": _std(sqsum, mean, cnt),
    }
