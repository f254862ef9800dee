"""Bridges from the halo layer's accounting into the obs registry — twin of
the first three recorders of `repro.obs.instrument`.

Nothing here invents a number: every gauge is fed from a value an existing
layer already computes — `repro_torch.dist.halo.HaloPlan` wire properties,
`repro_torch.core.dataflow.exchange_cost`, `plan_cache_stats`,
`PlanBlockedAdjacency.stats` / `plan_blocked_shape`. Every recorder returns
at once when metrics are disabled, before it touches its source object.
The delta, relocalize and compact reports and ``overlap_timeline`` come
with the slices that port their sources (ROADMAP).

`repro_torch.dist` is imported inside the functions, because
`repro_torch.dist.halo` itself imports `repro_torch.obs`.
"""
from __future__ import annotations

from repro_torch.obs import metrics

__all__ = ["record_exchange", "observe_plan_cache", "record_blocked"]


def record_exchange(plan, d_feat: int, payload: str | None = None) -> None:
    """Fold one halo exchange's wire model for ``plan`` at feature width
    ``d_feat`` into the registry.

    Gauges (bytes are per device per exchange, from
    `repro_torch.core.dataflow.ExchangeCost`): ``halo.rows_per_device`` per
    tier, ``halo.wire_bytes_per_exchange``, ``halo.exposed_bytes_per_exchange``,
    ``halo.payload_bits``, ``halo.overlap_fraction``, ``halo.wire_fraction``,
    ``halo.compression_vs_fp32``, ``halo.boundary_rows_max_device``.
    Counter ``halo.exchanges`` counts recorded exchanges."""
    if not metrics.enabled():
        return
    from repro_torch.core.dataflow import exchange_cost
    from repro_torch.core.quant import payload_bits

    bits = payload_bits(payload)
    ov = plan.overlap_fraction()
    cost = exchange_cost(plan.halo_rows_per_device, d_feat, bits, ov)
    metrics.inc("halo.exchanges")
    metrics.set_gauge("halo.rows_per_device", plan.halo_rows_per_device,
                      (("tier", "total"),))
    metrics.set_gauge("halo.rows_per_device", plan.broadcast_rows_per_device,
                      (("tier", "broadcast"),))
    if plan.is_hierarchical:
        metrics.set_gauge("halo.rows_per_device", plan.inter_pod_rows_crossing,
                          (("tier", "inter_pod_crossing"),))
        metrics.set_gauge("halo.rows_per_device", plan.intra_pod_rows_per_device,
                          (("tier", "intra_pod"),))
    metrics.set_gauge("halo.payload_bits", bits)
    metrics.set_gauge("halo.overlap_fraction", ov)
    metrics.set_gauge("halo.wire_fraction", plan.wire_fraction())
    metrics.set_gauge("halo.wire_bytes_per_exchange", cost.wire_bytes)
    metrics.set_gauge("halo.exposed_bytes_per_exchange", cost.exposed_bytes)
    metrics.set_gauge("halo.compression_vs_fp32", cost.compression)
    bnd = plan.boundary_rows_per_device()
    metrics.set_gauge("halo.boundary_rows_max_device",
                      int(bnd.max()) if bnd.size else 0)


def observe_plan_cache() -> None:
    """Mirror `repro_torch.dist.halo.plan_cache_stats` into ``plan_cache.*``
    gauges (hits, misses, evictions, size)."""
    if not metrics.enabled():
        return
    from repro_torch.dist.halo import plan_cache_stats

    for key, v in plan_cache_stats().items():
        metrics.set_gauge(f"plan_cache.{key}", v)


def record_blocked(stats, scope: str = "plan") -> None:
    """Fold a blocked-adjacency accounting record into ``bsr.*`` gauges.

    ``stats`` is the dict from `repro_torch.graph.structure.blocked_stats` /
    `repro_torch.dist.halo.plan_blocked_shape`, or a materialized
    `repro_torch.dist.halo.PlanBlockedAdjacency` (its ``stats()`` is used;
    its ``lens.sum()`` IS ``nnz_blocks``, the executed-tile count). ``scope``
    labels the series (e.g. ``plan``, ``interior``, ``boundary``)."""
    if not metrics.enabled():
        return
    if not isinstance(stats, dict):
        stats = stats.stats()
    labels = (("scope", scope),)
    metrics.set_gauge("bsr.executed_tiles", stats["nnz_blocks"], labels)
    metrics.set_gauge("bsr.max_nnzb", stats["max_nnzb"], labels)
    metrics.set_gauge("bsr.padded_tile_fraction",
                      stats["padded_tile_fraction"], labels)
    if "dense_tiles" in stats:
        metrics.set_gauge("bsr.dense_tiles", stats["dense_tiles"], labels)
