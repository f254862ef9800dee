"""Sharded (halo) forwards of PNA, EGNN, GraphCast and EquiformerV2 over a
k-rank `torch.distributed` group — the halo branches of the reference's
``pna_forward`` / ``egnn_forward`` / ``graphcast_forward`` /
``equiformer_forward``, run the way tests/test_overlap_halo.py runs PNA's
inside ``shard_map``.

Every rank holds its block of the nodes (`repro_torch.dist.halo.
relocate_node_array`) and its slice of the plan's edges; each layer's
senders gather from ``policy.neighbor_table(...)`` — ``[local ‖ halo]``,
only the boundary rows crossing the wire, in the policy's wire format —
and the plan's padding edges (``edge_w == 0``) enter as ``edge_mask = 0``.
GraphCast's edge features are the endpoints' relative positions
(`repro_torch.models.graphcast.relative_edge_feats`), computed on each
rank from one exchange of the positions (always fp32: they are inputs,
exchanged once, not activations), so the sharded and unsharded runs see
the same features with no edge permutation. EquiformerV2 exchanges its
positions once a forward and its normed (n, (l_max+1)², C) irrep table
every layer, both through ``policy.neighbor_table`` in the policy's wire
format, as the reference's model does.

`gnn_halo_rank` is the rank body (`repro_torch.launch.mesh.run_group`),
shared by tests/test_torch_gnn_halo.py and ``chip_smoke.py``: it runs one
forward per (arch, wire format) and returns the rank's output rows, the
wire accounting of the forward, and, with ``time_reps``, the forward's
and one layer's exchange's ms on the card. `gnn_forward` is the
unsharded counterpart on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import payload_bits
from repro_torch.dist.halo import HaloPlan, relocate_node_array
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.nn.layers import params_from_numpy

__all__ = ["GNNHaloJob", "gnn_forward", "gnn_halo_jobs", "gnn_halo_rank", "exchange_width"]


@dataclasses.dataclass
class GNNHaloJob:
    """One rank's share: the plan, the rank's node blocks, and the models
    to run (``(arch, cfg, params as numpy trees)``), each with every wire
    format of ``payloads``."""

    plan: HaloPlan
    x: np.ndarray                       # (n_local, F) this rank's features
    pos: np.ndarray                     # (n_local, 3) this rank's positions
    models: tuple                       # ((arch, cfg, params), ...)
    payloads: tuple = (None, "bf16")
    time_reps: int = 0                  # > 0: time the forward and one exchange (card only)


def exchange_width(arch: str, cfg) -> int:
    """The elements of one layer's exchanged row: h (pna, graphcast),
    ``[x ‖ h]`` (egnn) or the (l_max+1)² × C irreps (equiformer-v2)."""
    if arch == "equiformer-v2":
        return cfg.k_comps * cfg.d_hidden
    return cfg.d_hidden + 3 if arch == "egnn" else cfg.d_hidden


def gnn_forward(arch: str, params: dict, cfg, x: torch.Tensor, pos: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, policy: ShardingPolicy = NO_POLICY,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The model's output rows (EGNN's features, not its coordinates)."""
    if arch == "pna":
        from repro_torch.models.pna import pna_forward

        return pna_forward(params, x, senders, receivers, cfg, policy, edge_mask=edge_mask)
    if arch == "egnn":
        from repro_torch.models.egnn import egnn_forward

        return egnn_forward(params, x, pos, senders, receivers, cfg, policy, edge_mask=edge_mask)[0]
    if arch == "graphcast":
        from repro_torch.models.graphcast import graphcast_forward, relative_edge_feats

        pos_table = dataclasses.replace(policy, halo_payload=None).neighbor_table(pos)
        feats = relative_edge_feats(pos_table, pos, senders, receivers)
        return graphcast_forward(params, x, feats, senders, receivers, cfg, policy, edge_mask=edge_mask)
    if arch == "equiformer-v2":
        from repro_torch.models.equiformer_v2 import equiformer_forward

        return equiformer_forward(params, x, pos, senders, receivers, cfg, policy, edge_mask=edge_mask)
    raise KeyError(arch)


def gnn_halo_jobs(plan: HaloPlan, x: np.ndarray, pos: np.ndarray, models, payloads=(None, "bf16"),
                  time_reps: int = 0) -> list[GNNHaloJob]:
    """One job per rank from the global features ``x`` (n_nodes, F) and
    positions ``pos`` (n_nodes, 3)."""
    xb, pb = relocate_node_array(plan, x), relocate_node_array(plan, pos)
    return [GNNHaloJob(plan=plan, x=xb[r], pos=pb[r], models=tuple(models), payloads=tuple(payloads),
                       time_reps=time_reps) for r in range(plan.k)]


def gnn_halo_rank(rank: int, k: int, device: torch.device, job: GNNHaloJob) -> dict:
    """Each model of ``job`` under each wire format, on this rank: its
    output rows (n_local, d_out), whether they are finite, the rows and
    bytes this rank received over the forward (obs counters
    ``halo.wire_rows`` / ``halo.wire_bytes``), the exchanges it ran, and
    with ``time_reps`` the forward's and one layer-width exchange's median
    ms (CUDA events after a group barrier); under ``"launches"``, the
    rank's K1–K4 launches over all of it (counted from zero)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.distributed_gcn import _cuda_ms
    from repro_torch.obs import metrics

    reset_launch_counts()
    send_idx, senders, receivers, edge_w = job.plan.rank_arrays(rank, device)
    x = torch.from_numpy(job.x).to(device, torch.float32)
    pos = torch.from_numpy(job.pos).to(device, torch.float32)
    mask = (edge_w > 0).to(torch.float32)
    out: dict[str, Any] = {}
    with torch.inference_mode():
        for arch, cfg, params_np in job.models:
            params = params_from_numpy(params_np, device)
            for payload in job.payloads:
                policy = ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(send_idx)

                def forward():
                    return gnn_forward(arch, params, cfg, x, pos, senders, receivers, policy, mask)

                registry = metrics.enable(metrics.MetricsRegistry())
                try:
                    y = forward()
                    counts = {name: registry.counter(name).value
                              for name in ("halo.wire_rows", "halo.wire_bytes", "halo.exchanges_run")}
                finally:
                    metrics.disable()
                width = exchange_width(arch, cfg)
                rec = dict(rows=y.float().cpu().numpy(), finite=bool(torch.isfinite(y).all()),
                           wire_rows=int(counts["halo.wire_rows"]), wire_bytes=float(counts["halo.wire_bytes"]),
                           exchanges=int(counts["halo.exchanges_run"]), exchange_width=width,
                           wire_bytes_per_layer=int(send_idx.numel()) * k * width * payload_bits(payload) / 8)
                if job.time_reps:
                    z = torch.randn((x.shape[0], width), generator=torch.Generator().manual_seed(rank)).to(device)
                    rec["forward_ms"] = _cuda_ms(forward, device, job.time_reps)
                    rec["exchange_ms"] = _cuda_ms(lambda: policy.halo_block(z), device, job.time_reps)
                out[f"{arch}/{payload or 'fp32'}"] = rec
            del params
    out["launches"] = launch_counts()
    return out
