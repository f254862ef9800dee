"""Bridges from the halo layer's accounting into the obs registry and
tracer — twin of `repro.obs.instrument`.

Nothing here invents a number: every gauge is fed from a value an existing
layer already computes — `repro_torch.dist.halo.HaloPlan` wire properties,
`repro_torch.core.dataflow.exchange_cost`, `plan_cache_stats`,
`PlanBlockedAdjacency.stats` / `plan_blocked_shape`, and the delta,
relocalize and compact reports (the plain dicts
`repro_torch.dist.delta.DeltaPlanner` returns). Every recorder returns at once when metrics
are disabled, before it touches its source object. `overlap_timeline`
draws the overlapped exchange schedule of one rank as a trace.

`repro_torch.dist` is imported inside the functions, because
`repro_torch.dist.halo` itself imports `repro_torch.obs`.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace

__all__ = [
    "record_exchange",
    "observe_plan_cache",
    "record_blocked",
    "record_delta_report",
    "record_relocalize_report",
    "record_compact_report",
    "overlap_timeline",
]


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


def record_delta_report(report: dict) -> None:
    """Fold a delta-apply report (``DeltaPlanner.apply``
    dict) into ``delta.*`` series: edit/remap counters, dirty-device gauge,
    the structural flag, repair latency (``delta.apply_ms`` histogram, if
    timed), and the executed-tile locality-drift gauge
    (``delta.drift_ratio``, if the report measured drift)."""
    if not metrics.enabled():
        return
    metrics.inc("delta.applies")
    metrics.inc("delta.inserts", float(report.get("inserts", 0)))
    metrics.inc("delta.deletes", float(report.get("deletes", 0)))
    metrics.inc("delta.senders_remapped", float(report.get("senders_remapped", 0)))
    metrics.inc("delta.blocked_patched", float(report.get("blocked_patched", 0)))
    dirty = report.get("dirty_devices") or ()
    metrics.set_gauge("delta.dirty_devices", len(dirty))
    metrics.set_gauge("delta.structural", 1.0 if report.get("structural") else 0.0)
    if "apply_ms" in report:
        metrics.observe("delta.apply_ms", float(report["apply_ms"]))
    if report.get("drift") is not None:
        d = report["drift"]
        metrics.set_gauge("delta.drift_ratio", d["drift_ratio"])
        metrics.set_gauge("delta.executed_tiles_current", d["executed_tiles_current"])
        metrics.set_gauge("delta.executed_tiles_reordered", d["executed_tiles_reordered"])


def record_relocalize_report(report: dict) -> None:
    """Fold a relocalize report (``DeltaPlanner.relocalize``) into
    ``delta.relocalize*`` series: a fire counter, the re-localization
    latency histogram, and the executed-tile counts the fresh order was
    installed against (before = the drifted layout it replaced)."""
    if not metrics.enabled():
        return
    metrics.inc("delta.relocalizes")
    if "relocalize_ms" in report:
        metrics.observe("delta.relocalize_ms", float(report["relocalize_ms"]))
    metrics.set_gauge("delta.relocalize_tiles_before", report.get("executed_tiles_before", 0))
    metrics.set_gauge("delta.relocalize_tiles_after", report.get("executed_tiles_after", 0))


def record_compact_report(report: dict) -> None:
    """Fold a compact report (``DeltaPlanner.compact``) into
    ``delta.compact*`` series plus the ``delta.pad_occupancy`` gauge (live
    slots / padded slots across tiers and store — 1.0 after a rebuildful
    compact, by construction)."""
    if not metrics.enabled():
        return
    metrics.inc("delta.compacts")
    metrics.inc("delta.pad_bytes_reclaimed", float(max(report.get("bytes_reclaimed", 0), 0)))
    occ = report.get("pad_occupancy") or {}
    metrics.set_gauge("delta.pad_occupancy", float(occ.get("frac", 1.0)))
    if "compact_ms" in report:
        metrics.observe("delta.compact_ms", float(report["compact_ms"]))


def overlap_timeline(plan, feats, group=None, tracer=None, payload: str | None = None,
                     steps: int = 3, via: str = "all_gather"):
    """Record a trace that shows one rank's boundary collective hiding
    behind its interior compute — the overlapped schedule of
    docs/communication.md as a Perfetto timeline. Called by every rank of
    the group.

    ``plan`` is the `HaloPlan`, ``feats`` this rank's ``(n_local, d)``
    block on its device, ``group`` the flat plan's process group (None: the
    default group) or, for a hierarchical plan, the rank's ``(pod group,
    model group)`` pair (`repro_torch.launch.mesh.halo_groups`). Each step:

      1. dispatches the boundary collective with ``async_op=True`` (a
         hierarchical plan's phase 1; phase 2 runs in the wait, since it
         relays phase 1's rows) — under gloo the wire's device-to-host copy
         comes first, since the collective reads the host copy;
      2. runs the wire-independent interior term of `split_halo_aggregate`
         inside a synced ``overlap.interior_compute`` span on the calling
         thread's track;
      3. waits, and records ``halo.exchange.boundary_collective`` on the
         ``wire`` track, from dispatch to the halo block on the device;
      4. adds the boundary term (``overlap.boundary_combine``).

    Span edges synchronize the CUDA stream, so nothing is drawn that did not
    happen; the wire span encloses the interior span whenever the
    collective was in flight while the interior ran. One untimed step runs
    first (``overlap.compile``: the kernels' and the group's first use).
    Returns the last step's ``(n_local, d)`` aggregate, equal to
    `halo_aggregate`'s (``split_halo_aggregate``'s terms)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.halo import _hier_phase1_start, _hier_phase2, _quantized_gather_start
    from repro_torch.graph.ops import aggregate

    hier = plan.is_hierarchical
    if hier and not (isinstance(group, tuple) and len(group) == 2):
        raise ValueError("a hierarchical plan's timeline needs group=(pod group, model group)")
    if tracer is None:
        tracer = trace.enable_tracing()
    arrs = plan.rank_arrays(dist.get_rank(), feats.device)
    send, (senders, receivers, edge_w) = arrs[:-3], arrs[-3:]
    senders = senders.long()
    n_local = plan.n_local
    remote = senders >= n_local
    zero = torch.zeros((), dtype=edge_w.dtype, device=edge_w.device)
    w_int, w_bnd = torch.where(remote, zero, edge_w), torch.where(remote, edge_w, zero)

    def dispatch():
        """Start the boundary collective; returns the wait that gives the
        halo block on the device."""
        if not hier:
            return _quantized_gather_start(feats[send[0].long()], group, via, payload)
        first = _hier_phase1_start(feats, send[1], group[0], via, payload)
        return lambda: _hier_phase2(feats, send[0], first(), group[1], via, payload)

    def interior():
        return aggregate(feats, senders.clamp_max(n_local - 1), receivers, n_local, w_int)

    def combine(halo, out_int):
        if halo.shape[0] == 0:
            return out_int
        return out_int + aggregate(halo, (senders - n_local).clamp(0, halo.shape[0] - 1), receivers,
                                   n_local, w_bnd)

    with tracer.span("overlap.compile") as h:
        h.sync = combine(dispatch()(), interior())
    wire_tid = tracer.track_tid("wire")
    out = None
    for i in range(steps):
        t0 = tracer.now_us()
        wait = dispatch()                               # the collective is in flight
        with tracer.span("overlap.interior_compute", args={"step": i}) as h:
            out_int = interior()
            h.sync = out_int
        halo = wait()
        trace._block(halo)
        tracer.complete(
            "halo.exchange.boundary_collective", t0, tracer.now_us() - t0, tid=wire_tid,
            args={"step": i, "rows_per_device": plan.halo_rows_per_device, "payload": payload or "fp32"},
        )
        with tracer.span("overlap.boundary_combine", args={"step": i}) as h:
            out = combine(halo, out_int)
            h.sync = out
    record_exchange(plan, int(feats.shape[-1]), payload)
    return out
