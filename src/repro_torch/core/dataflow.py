"""COIN dataflow: feature-extraction-first matmul reordering (paper §IV-C3).

Twin of `repro.core.dataflow` (pure Python, copied). A GCN layer computes
O = A · X · W; the multiplication order changes the work:

  aggregation-first   : (A·X)·W
  feature-first (COIN): A·(X·W)

For the ``"bsr"`` backend the aggregation runs one 128×128 × 128×F product
per nonzero block, so its cost term is ``nnz_blocks · B² · F``. The halo
exchange has its own model (`ExchangeCost`): rows on the wire, scaled by the
payload's bits and the share of the exchange interior work hides. (The
reference's chooser also takes an exchange term, for its dry-run and
hillclimb accounting; it never changes the decision, and the port has no
caller for it yet.)
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "DataflowCost",
    "ExchangeCost",
    "dense_multiply_count",
    "sparse_multiply_count",
    "blocked_multiply_count",
    "exchange_cost",
    "choose_order",
]


@dataclasses.dataclass(frozen=True)
class DataflowCost:
    aggregation_first: float
    feature_first: float

    @property
    def reduction(self) -> float:
        """How many × fewer multiplies feature-first performs."""
        return self.aggregation_first / max(self.feature_first, 1.0)

    @property
    def best(self) -> str:
        return "feature_first" if self.feature_first <= self.aggregation_first else "aggregation_first"


def dense_multiply_count(n_nodes: int, d_in: int, d_out: int) -> DataflowCost:
    """Paper's accounting (§IV-C3): crossbars store A densely (no sparsity)."""
    n = float(n_nodes)
    agg_first = n * n * d_in + n * d_in * d_out
    feat_first = n * d_in * d_out + n * n * d_out
    return DataflowCost(aggregation_first=agg_first, feature_first=feat_first)


def sparse_multiply_count(n_nodes: int, n_edges: int, d_in: int, d_out: int) -> DataflowCost:
    """Aggregation as an E-edge segment sum."""
    n, e = float(n_nodes), float(n_edges)
    agg_first = e * d_in + n * d_in * d_out
    feat_first = n * d_in * d_out + e * d_out
    return DataflowCost(aggregation_first=agg_first, feature_first=feat_first)


def blocked_multiply_count(
    n_nodes: int, nnz_blocks: int, d_in: int, d_out: int, block: int = 128
) -> DataflowCost:
    """BSR-backend accounting: one B×B × B×F product per nonzero tile, so the
    aggregation term is ``nnz_blocks · B² · F``, not ``E · F``."""
    n, bb = float(n_nodes), float(nnz_blocks) * float(block) * float(block)
    agg_first = bb * d_in + n * d_in * d_out
    feat_first = n * d_in * d_out + bb * d_out
    return DataflowCost(aggregation_first=agg_first, feature_first=feat_first)


@dataclasses.dataclass(frozen=True)
class ExchangeCost:
    """The halo-exchange wire model: per-device per-layer rows crossing the
    wire, compressed by the payload format and hidden behind interior compute.

      wire_bytes    = rows · d · payload_bits / 8        (what crosses)
      exposed_bytes = wire_bytes · (1 − overlap_fraction) (what the critical
                      path still waits on)
    """

    rows: int                         # halo rows received per device per layer
    d: int                            # feature width crossing the wire
    payload_bits: int = 32            # fp32 32 | bf16 16 | int8 8
    overlap_fraction: float = 0.0     # HaloPlan.overlap_fraction()

    @property
    def wire_bytes(self) -> float:
        return self.rows * self.d * self.payload_bits / 8.0

    @property
    def exposed_bytes(self) -> float:
        return self.wire_bytes * (1.0 - self.overlap_fraction)

    @property
    def compression(self) -> float:
        """Wire-byte reduction vs the fp32 baseline (32 / payload_bits)."""
        return 32.0 / max(self.payload_bits, 1)


def exchange_cost(
    rows: int, d: int, payload_bits: int = 32, overlap_fraction: float = 0.0
) -> ExchangeCost:
    """Convenience constructor for :class:`ExchangeCost`."""
    return ExchangeCost(
        rows=int(rows), d=int(d), payload_bits=int(payload_bits),
        overlap_fraction=float(overlap_fraction),
    )


def choose_order(
    n_nodes: int, d_in: int, d_out: int, n_edges: int | None = None,
    backend: str = "segment", nnz_blocks: int | None = None, block: int = 128,
) -> str:
    """COIN's rule: run X·W first iff it shrinks the aggregated width.

    Under every cost model the comparison reduces to d_out vs d_in (the
    N·F·H term is shared); ties go to feature-first (the paper's order).
    """
    if backend == "bsr" and nnz_blocks is not None:
        cost = blocked_multiply_count(n_nodes, nnz_blocks, d_in, d_out, block)
    elif n_edges is not None:
        cost = sparse_multiply_count(n_nodes, n_edges, d_in, d_out)
    else:
        cost = dense_multiply_count(n_nodes, d_in, d_out)
    return cost.best
