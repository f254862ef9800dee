"""COIN's communication objective on a group of GPUs — the port's
counterpart of `repro.core.planner`.

The paper chooses the CE count k by minimizing an analytic model of
intra-CE + inter-CE communication energy. On a group of GPUs the same
decision is "how many model-parallel shards should hold the graph", with:

  intra term  → device-memory (HBM) traffic of the local aggregation on
                each shard,
  inter term  → the layer-output exchange over the inter-chip link.

One GCN layer under the COIN schedule on k shards:

  local extract : reads N/k·F, writes N/k·H          (HBM)
  exchange      : all-gather of Z (paper broadcast)  → (k−1)/k · N·H elements in,
                  or halo exchange                   → cut_edges(k)/k · H per shard
  local aggregate: reads E/k edges + gathered Z      (HBM)

and pick the k (divisor of the available devices) that minimizes
max(compute, intra) + inter — the same "balance intra vs inter" insight as
Eq. 3, in seconds instead of joules. The formulas are the reference's; the
hardware constants are the card's (`GPUHardware`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["GPUPlan", "coin_objective_gpu", "plan_gnn_sharding", "GPUHardware"]


@dataclasses.dataclass(frozen=True)
class GPUHardware:
    """One NVIDIA H100 SXM (80GB HBM3), from NVIDIA's data sheet at the full
    700 W power limit. None of these is measured by this repository: one
    card's machine has no link to measure, and the script's kernels are
    timed against these rates, not used to derive them."""

    peak_flops: float = 67e12           # fp32 FLOP/s outside the tensor cores (data sheet; the port's
                                        # kernels run IEEE fp32, TF32 off)
    hbm_bw: float = 3.35e12             # HBM3 bytes/s (data sheet)
    ici_bw: float = 450e9               # NVLink 4 bytes/s per direction (data sheet: 900 GB/s both ways)
    bytes_per_elt: float = 4.0          # fp32


@dataclasses.dataclass(frozen=True)
class GPUPlan:
    model_shards: int
    data_shards: int
    est_step_s: float
    intra_s: float                      # HBM-bound local time
    inter_s: float                      # link-bound exchange time
    compute_s: float
    schedule: str                       # "broadcast" (paper) or "halo"

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.intra_s, "collective": self.inter_s}
        return max(terms, key=terms.get)


def coin_objective_gpu(
    n_nodes: int,
    n_edges: int,
    feat_dims: Sequence[int],
    k: int,
    hw: GPUHardware = GPUHardware(),
    schedule: str = "broadcast",
    cut_fraction: float | None = None,
) -> tuple[float, float, float]:
    """(compute_s, intra_hbm_s, inter_link_s) for one forward pass on k shards.

    ``cut_fraction`` (edges crossing shards / total edges) parameterizes the
    halo schedule; the paper's broadcast schedule ignores it.
    """
    b = hw.bytes_per_elt
    compute = intra = inter = 0.0
    for d_in, d_out in zip(feat_dims[:-1], feat_dims[1:]):
        n_loc, e_loc = n_nodes / k, n_edges / k
        # local X·W (feature-first, paper dataflow)
        flops = 2.0 * n_loc * d_in * d_out
        compute += flops / hw.peak_flops
        intra += (n_loc * d_in + d_in * d_out + n_loc * d_out) * b / hw.hbm_bw
        # exchange of Z over the link
        if schedule == "broadcast":
            inter += (k - 1) / k * n_nodes * d_out * b / hw.ici_bw
        elif schedule == "halo":
            cf = 1.0 if cut_fraction is None else cut_fraction
            inter += (cf * n_edges / k) * d_out * b / hw.ici_bw
        else:
            raise ValueError(schedule)
        # local aggregation A_loc · Z
        compute += 2.0 * e_loc * d_out / hw.peak_flops
        intra += (e_loc * d_out * 2.0 + n_loc * d_out) * b / hw.hbm_bw
    return compute, intra, inter


def plan_gnn_sharding(
    n_nodes: int,
    n_edges: int,
    feat_dims: Sequence[int],
    n_devices: int,
    hw: GPUHardware = GPUHardware(),
    schedule: str = "broadcast",
    cut_fraction: float | None = None,
) -> GPUPlan:
    """Choose the model-parallel degree by the COIN balance criterion.

    Candidates are divisors of n_devices; the remaining factor becomes data
    (replica/feature) parallelism. The estimated step time is
    max(compute, intra) + inter (exchange not overlapped — paper's serial
    layer schedule); the minimizer balances the terms exactly as Eq. 3 does.
    """
    best: GPUPlan | None = None
    for k in _divisors(n_devices):
        comp, intra, inter = coin_objective_gpu(
            n_nodes, n_edges, feat_dims, k, hw, schedule, cut_fraction
        )
        step = max(comp, intra) + inter
        plan = GPUPlan(
            model_shards=k,
            data_shards=n_devices // k,
            est_step_s=step,
            intra_s=intra,
            inter_s=inter,
            compute_s=comp,
            schedule=schedule,
        )
        if best is None or plan.est_step_s < best.est_step_s:
            best = plan
    assert best is not None
    return best


def _divisors(n: int) -> list[int]:
    out = []
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            out.append(d)
            if d != n // d:
                out.append(n // d)
    return sorted(out)
