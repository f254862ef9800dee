"""The analytic wire accounting of a sharded GCN cell — the analytic half
of `repro.launch.dryrun` (its `exchange_accounting`).

The reference's dry run also compiles every (architecture × shape) cell on
a 16×16 and a 2×16×16 mesh and parses the compiled program's collectives;
that half, its cells and its CLI are not ported yet (ROADMAP.md queue 1).
What is here needs no compiler: the per-device wire rows and bytes a halo
plan ships, and the autotuner's prediction of the same fields
(`repro_torch.core.autotune.predict_config_cost`), which must agree with
them exactly — the calibration contract.
"""
from __future__ import annotations

from repro_torch.core.autotune import CandidateConfig, comm_stats_from_plan, predict_config_cost
from repro_torch.core.dataflow import exchange_cost
from repro_torch.core.quant import payload_bits
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.instrument import record_blocked, record_exchange

__all__ = ["exchange_accounting"]


def exchange_accounting(cell, shape) -> dict | None:
    """Analytic per-device wire rows of the GNN layer exchange.

    ``cell`` is duck-typed: ``halo_plan`` (a `repro_torch.dist.halo.HaloPlan`
    or None), ``comm``, and optionally ``halo_payload``, ``halo_overlap`` and
    ``bsr_stats``; ``shape.d_feat`` is the exchanged width.

    Halo cells carry their HaloPlan, so the reported bytes-moved reflects the
    boundary rows each device actually receives — not the ``(k−1)·n_local``
    a broadcast schedule would ship; both numbers are recorded so the wire
    cut is visible per record. Hierarchical (pod, model) plans additionally
    split the rows per tier — intra-pod (cheap links) vs inter-pod (rows
    crossing the expensive fabric) — alongside the flat single-axis baseline
    on the same partition. ``bsr_stats`` (`plan_blocked_shape`: nonzero
    128×128 tiles and the padded-tile fraction the ragged kernel skips) is
    carried through. Cells without a plan return just the comm tag.

    ``halo_wire_bytes_per_exchange`` is what crosses the wire under the
    cell's payload format (× bits/32 vs the fp32 total) and
    ``halo_exposed_bytes_per_exchange`` what the critical path still waits
    on (× (1 − overlap_fraction)). The ``predicted`` block is the
    autotuner's model evaluated on this cell's own config; every shared
    deterministic field must equal its measured twin.
    """
    plan = getattr(cell, "halo_plan", None)
    if plan is None:
        return {"comm": cell.comm} if getattr(cell, "comm", None) else None
    d = shape.d_feat or 0
    payload = getattr(cell, "halo_payload", None)
    bits = payload_bits(payload)
    overlap = bool(getattr(cell, "halo_overlap", False))
    ov_frac = plan.overlap_fraction() if overlap else 0.0
    ec = exchange_cost(plan.halo_rows_per_device, d, bits, ov_frac)
    out = {
        "comm": cell.comm,
        "halo_rows_per_device": plan.halo_rows_per_device,
        "broadcast_rows_per_device": plan.broadcast_rows_per_device,
        "wire_fraction": plan.wire_fraction(),
        "halo_bytes_per_exchange": plan.halo_rows_per_device * d * 4,
        "broadcast_bytes_per_exchange": plan.broadcast_rows_per_device * d * 4,
        "payload": payload or "fp32",
        "payload_bits": bits,
        "payload_compression": ec.compression,
        "overlap": overlap,
        "overlap_fraction": ov_frac,
        "halo_wire_bytes_per_exchange": ec.wire_bytes,
        "halo_exposed_bytes_per_exchange": ec.exposed_bytes,
        "boundary_rows_max_device": int(plan.boundary_rows_per_device().max(initial=0)),
        "interior_rows_min_device": int(plan.interior_rows_per_device().min(initial=0)),
    }
    if getattr(cell, "bsr_stats", None):
        out["bsr"] = dict(cell.bsr_stats)
    if _obs_metrics.enabled():
        # Mirror the prediction into the same series the runtime layers
        # measure into: prediction against observation is a snapshot diff.
        record_exchange(plan, d, payload)
        if getattr(cell, "bsr_stats", None):
            record_blocked(cell.bsr_stats, scope="dryrun")
    if plan.is_hierarchical:
        out.update(
            axes=list(plan.axes),
            pods=plan.n_pods,
            intra_pod_rows_per_device=plan.intra_pod_rows_per_device,
            inter_pod_rows_per_device=plan.inter_pod_rows_per_device,
            inter_pod_rows_crossing=plan.inter_pod_rows_crossing,
            flat_inter_pod_rows_crossing=plan.flat_inter_pod_rows_crossing,
            inter_pod_bytes_crossing=plan.inter_pod_rows_crossing * d * 4,
            flat_inter_pod_bytes_crossing=plan.flat_inter_pod_rows_crossing * d * 4,
        )
    bsr = getattr(cell, "bsr_stats", None) or {}
    if "interior" in bsr:  # split record: per-half tables (overlap schedule)
        nnz_blocks = bsr["interior"]["nnz_blocks"] + bsr["boundary"]["nnz_blocks"]
        block = int(bsr["interior"]["block"])
    else:
        nnz_blocks = bsr.get("nnz_blocks")
        block = int(bsr.get("block", 128))
    cfg = CandidateConfig(
        pods=plan.n_pods,
        block=block,
        backend="bsr" if bsr else "segment",
        payload=payload,
        overlap=overlap,
    )
    out["predicted"] = predict_config_cost(
        cfg, comm_stats_from_plan(plan), d_feat=d, n_nodes=plan.n_nodes,
        nnz_blocks=nnz_blocks,
        n_edges=int((plan.edge_w > 0).sum()),
    )
    return out
