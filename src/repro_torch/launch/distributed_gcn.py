"""Sharded (halo) GCN inference over a k-rank `torch.distributed` group —
twin of the plan printout and the halo evaluation of
``examples/train_distributed_gcn.py``.

    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --k 4 --payload bf16 --backend bsr

The graph (``make_dataset("cora", reduced=True)``, symmetrized, with
self-loops and sym-norm weights) is partitioned over ``--k`` ranks (BFS +
refinement), the cached `HaloPlan` relocates it into per-rank blocks, and
every rank runs `gcn_forward` on its block with an armed halo policy: each
layer's aggregation receives only the boundary rows, ``k·s_max`` per rank
instead of the broadcast schedule's ``(k−1)·n_local``. The script prints
the reference's ``graph:`` and ``wire/device/layer:`` lines, the group it
starts, and the accuracy of the halo forward with its largest logit
difference from the unsharded forward. Parameters come from a seeded
`torch.Generator` and are not trained: halo training is the next slice
(``--steps N`` with N > 0 says so).

The ranks run on ``--device`` (the CUDA card unless ``--device cpu``); on
one card all k ranks share it and the group's backend is ``gloo``, whose
wire goes through the host. `halo_rank` is the rank body, shared with
`chip_smoke.py` and the tests: it runs a list of `HaloVariant`s and returns
each one's logits, kernel launches and wire rows, and optionally its times.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.partition import partition_graph
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.dist.halo import (
    HaloPlan,
    get_halo_plan,
    plan_blocked_rank,
    plan_blocked_shape,
    plan_split_blocked_shape,
    relocate_node_array,
    restore_node_array,
)
from repro_torch.dist.policy import ShardingPolicy
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.structure import to_padded
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init
from repro_torch.obs import metrics
from repro_torch.obs.trace import device_time_summary

__all__ = ["HaloVariant", "RankJob", "halo_rank", "rank_jobs", "table_widths", "main"]


@dataclasses.dataclass(frozen=True)
class HaloVariant:
    """One sharded forward: backend, wire format, table form, quantization."""

    name: str
    backend: str = "bsr"                 # "bsr" | "segment"
    payload: str | None = None           # wire: None/"fp32" | "bf16" | "int8"
    split: bool = False                  # bsr: the interior/boundary table pair
    quant: bool = False                  # fake quant on (the job's QuantConfig)
    overlap: bool = True                 # segment: split_halo_aggregate
    dataflow: str = "auto"
    via: str = "all_gather"              # exchange lowering


@dataclasses.dataclass
class RankJob:
    """What one rank needs, and nothing of the other ranks' tiles: the plan
    (host index tables, small), this rank's feature block, the parameters,
    the shared tile-table widths and the variants to run."""

    plan: HaloPlan
    x: np.ndarray                        # (n_local, F) this rank's block
    params: dict
    layer_dims: tuple[int, ...]
    variants: tuple[HaloVariant, ...]
    max_nnzb: dict                       # table form → tile-table width every rank shares
    quant: QuantConfig = QuantConfig()
    time_reps: int = 0                   # > 0: time each variant and the exchange


def table_widths(plan: HaloPlan) -> dict:
    """The tile-table width T of each table form, shared by all ranks (O(E)
    host statistics, no tiles)."""
    split = plan_split_blocked_shape(plan)
    return {"combined": plan_blocked_shape(plan)["max_nnzb"],
            "interior": split["interior"]["max_nnzb"], "boundary": split["boundary"]["max_nnzb"]}


def rank_jobs(plan: HaloPlan, x: np.ndarray, params: dict, layer_dims, variants,
              **kw) -> list[RankJob]:
    """One `RankJob` per rank from the global features ``x`` (n_nodes, F)."""
    xb = relocate_node_array(plan, x)
    widths = table_widths(plan)
    return [RankJob(plan=plan, x=xb[r], params=params, layer_dims=tuple(layer_dims),
                    variants=tuple(variants), max_nnzb=widths, **kw) for r in range(plan.k)]


def _cuda_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of ``fn`` between CUDA events, each run started after a
    barrier of the group (the ranks share the card: not a multi-card time)."""
    times = []
    for _ in range(reps):
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(fn, device: torch.device) -> dict:
    """`device_time_summary` of one run of ``fn`` after one warm-up run under
    the profiler (so its start-up stays out of the window), started after a
    barrier. The profile sees this rank's kernels only."""
    from torch.profiler import ProfilerActivity, profile, schedule

    summary: dict = {}
    dist.barrier()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: summary.update(device_time_summary(list(p.events()), top=8))
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize(device)
            prof.step()
    return summary


def halo_rank(rank: int, k: int, device: torch.device, job: RankJob) -> dict:
    """The body of one rank (`repro_torch.launch.mesh.run_group`): build
    this rank's tables, run every variant once, and report.

    Per variant: the logits (fp32 numpy, ``n_local`` rows) and their
    dtype, the launches of each kernel in that forward
    (`repro_torch.kernels.fused_gcn.LAUNCHES`), and the rows and bytes this
    rank received over the wire (``halo.wire_rows``). With
    ``job.time_reps``: each variant's forward ms, each payload's exchange ms
    on a block of the hidden width (what both layers of a 2-layer GCN
    exchange under the COIN order), a `torch.profiler` summary of one
    forward of the first variant (this rank's device time by kernel and
    its idle share), and this rank's peak device memory.
    """
    from repro_torch.kernels import fused_gcn as fg

    plan = job.plan
    send_idx, senders, receivers, edge_w = plan.rank_arrays(rank, device)
    x = torch.from_numpy(job.x).to(device).float()
    params = {name: torch.from_numpy(np.asarray(v)).to(device) for name, v in job.params.items()}
    tables = {}

    def table(part: str):
        if part not in tables:
            ba = plan_blocked_rank(plan, rank, part=part, max_nnzb=job.max_nnzb[part])
            tables[part] = ba.arrays(device=device)
        return tables[part]

    registry = metrics.enable(metrics.MetricsRegistry())
    wire = registry.counter("halo.wire_rows")
    wire_bytes = registry.counter("halo.wire_bytes")
    out: dict = {"rank": rank, "variants": {}}
    runs = {}
    for v in job.variants:
        cfg = GCNConfig(layer_dims=job.layer_dims, dataflow=v.dataflow, backend=v.backend,
                        quant=job.quant if v.quant else QuantConfig(enabled=False))
        policy = ShardingPolicy(comm="halo", halo_via=v.via, halo_payload=v.payload,
                                halo_overlap=v.overlap).bind_halo(send_idx)
        kw = {}
        if v.backend == "bsr":
            kw["adjacency"] = table("interior" if v.split else "combined")
            if v.split:
                kw["adjacency_boundary"] = table("boundary")

        def forward(cfg=cfg, policy=policy, kw=kw):
            return gcn_forward(params, x, senders, receivers, edge_w, cfg, policy, **kw)

        with torch.inference_mode():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            fg.reset_launch_counts()
            rows0, bytes0 = wire.value, wire_bytes.value
            logits = forward()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launches = {name: n for name, n in fg.LAUNCHES.items() if n}
            out["variants"][v.name] = {
                "logits": logits.float().cpu().numpy(), "dtype": str(logits.dtype).removeprefix("torch."),
                "launches": launches, "wire_rows": int(wire.value - rows0),
                "wire_bytes": int(wire_bytes.value - bytes0), "finite": bool(torch.isfinite(logits).all())}
        runs[v.name] = forward
    metrics.disable()

    if job.time_reps and device.type == "cuda":
        with torch.inference_mode():
            for name, forward in runs.items():
                out["variants"][name]["forward_ms"] = _cuda_ms(forward, device, job.time_reps)
            z = torch.randn((plan.n_local, job.layer_dims[1]),
                            generator=torch.Generator().manual_seed(rank)).to(device)
            out["exchange_ms"] = {}
            for payload in (None, "bf16", "int8"):
                pol = ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(send_idx)
                out["exchange_ms"][payload or "fp32"] = _cuda_ms(lambda: pol.halo_block(z), device,
                                                                  job.time_reps)
            out["profile"] = _profile(runs[job.variants[0].name], device)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    dist.barrier()
    return out


def _plan_lines(spec, gs, plan) -> list[str]:
    lines = [f"graph: {spec.name} n={gs.n_nodes} e={gs.n_edges} → k={plan.k} "
             f"n_local={plan.n_local} s_max={plan.s_max}"]
    if plan.k > 1:
        lines.append(
            f"wire/device/layer: halo {plan.halo_rows_per_device} rows vs "
            f"broadcast {plan.broadcast_rows_per_device} rows "
            f"({plan.wire_fraction():.3f}× — DESIGN.md §8)")
    return lines


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=4, help="ranks of the group")
    ap.add_argument("--payload", choices=["fp32", "bf16", "int8"], default="fp32",
                    help="halo wire format")
    ap.add_argument("--backend", choices=["segment", "bsr"], default="segment")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=True,
                    help="overlapped schedule: split_halo_aggregate (segment) or the "
                         "interior/boundary table pair (bsr)")
    ap.add_argument("--steps", type=int, default=0,
                    help="training steps; halo training is not ported yet")
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.steps > 0:
        raise NotImplementedError(
            "halo training is not ported yet: ROADMAP.md, port slice 4 (halo training); "
            "this command evaluates the halo forward (--steps 0)")
    device = resolve_device(args.device)

    spec, g = make_dataset("cora", reduced=True)
    gs = g.symmetrized().with_self_loops()
    w = gs.sym_normalized_weights()
    part = partition_graph(gs.n_nodes, gs.edge_index, args.k, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, gs.edge_index, w)
    for line in _plan_lines(spec, gs, plan):
        print(line)

    cfg = GCNConfig(layer_dims=(spec.n_features, spec.hidden, spec.n_labels))
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    variant = HaloVariant(name="eval", backend=args.backend,
                          payload=None if args.payload == "fp32" else args.payload,
                          split=args.backend == "bsr" and args.overlap, overlap=args.overlap)
    x = g.features.astype(np.float32)
    jobs = rank_jobs(plan, x, {n: p.numpy() for n, p in params.items()}, cfg.layer_dims, [variant])
    group = GroupSpec(k=args.k, backend="gloo", devices=(str(device if device.type == "cpu" else "cuda:0"),))
    if device.type == "cuda" and args.backend == "bsr":
        # Build once here: the ranks then only load the library.
        from repro_torch.kernels import _build

        _build.build(["fused_gcn"])
    print(f"group: {group.describe()}")
    results = run_group(group, halo_rank, jobs)
    logits = restore_node_array(plan, np.stack([r["variants"]["eval"]["logits"] for r in results]))

    with torch.inference_mode():
        pg = to_padded(gs, weights=w, device=device)
        ref = gcn_forward({n: p.to(device) for n, p in params.items()},
                          torch.from_numpy(x).to(device), pg.senders, pg.receivers, pg.edge_weight,
                          cfg).cpu().numpy()
    acc = float((logits.argmax(-1) == g.labels).mean())
    diff = float(np.abs(logits - ref).max())
    rows = results[0]["variants"]["eval"]["wire_rows"]
    print(f"eval: halo forward backend={args.backend} payload={args.payload} overlap={args.overlap} "
          f"acc={acc:.3f} (untrained); max |logit − unsharded| = {diff:.2e}; "
          f"wire rows/rank/forward = {rows} ({cfg.n_layers} × k·s_max)")
    return {"acc": acc, "max_abs_diff": diff, "wire_rows": rows, "plan": plan}


if __name__ == "__main__":
    main()
