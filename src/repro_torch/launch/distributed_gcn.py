"""Sharded (halo) GCN training and inference over a k-rank
`torch.distributed` group — twin of ``examples/train_distributed_gcn.py``.

    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu --steps 60
    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --k 4 --payload bf16 --backend bsr
    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu --pods 2 \
        --steps 12 --trace trace.json --metrics metrics.json

The graph (``make_dataset("cora", reduced=True)``, symmetrized, with
self-loops and sym-norm weights) is partitioned over ``--k`` ranks (BFS +
refinement), the cached `HaloPlan` relocates it into per-rank blocks, and
every rank runs `gcn_forward` on its block with an armed halo policy: each
layer's aggregation receives only the boundary rows, ``k·s_max`` per rank
instead of the broadcast schedule's ``(k−1)·n_local``. The script prints
the reference's ``graph:`` and ``wire/device/layer:`` lines and the group
it starts. With ``--steps N`` (N > 0) every rank trains its own `Trainer`
(AdamW, lr 1e-2, checkpoints written by rank 0 into ``--ckpt-dir``) on the
example's sharded loss (`halo_loss`), and the script prints the
reference's resume, ``done:`` and ``plan cache:`` lines and checks its two
asserts: the loss falls, and the plan cache saw a hit and a miss. With
``--steps 0`` it evaluates the halo forward of untrained parameters
instead, with its largest logit difference from the unsharded forward.
Parameters come from a seeded `torch.Generator`.

``--pods P`` (P > 1, dividing ``--k``) switches to the hierarchical (pod,
model) schedule: the plan splits each rank's boundary set into intra- and
inter-pod tiers, the exchange runs in two phases over the rank's subgroups
(`repro_torch.launch.mesh.halo_groups`), and the script prints the
reference's ``s_loc``/``s_rem`` line and the rows that cross the inter-pod
tier, hierarchical against flat. ``--metrics`` / ``--trace``
(`repro_torch.launch.obsflags`) record rank 0's telemetry: the training
steps, the plan's wire accounting and cache stats, and — at the end of a
traced run — `overlap_timeline`, whose ``halo.exchange.boundary_collective``
span on the ``wire`` track encloses ``overlap.interior_compute``.

The ranks run on ``--device`` (the CUDA card unless ``--device cpu``); on
one card all k ranks share it and the group's backend is ``gloo``, whose
wire goes through the host. `halo_rank` (forwards) and `halo_train_rank`
(training) are the rank bodies, shared with `chip_smoke.py` and the tests:
they run lists of `HaloVariant`s and return each one's logits or
gradients and losses, its kernel launches and wire rows, and optionally
its times; `halo_ranks` runs `halo_rank` on several plans in one group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import statistics
import tempfile
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.partition import partition_graph
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.dist.halo import (
    HaloPlan,
    get_halo_plan,
    node_mask,
    plan_blocked_rank,
    plan_blocked_shape,
    plan_split_blocked_shape,
    plan_cache_stats,
    relocate_node_array,
    restore_node_array,
)
from repro_torch.dist.policy import ShardingPolicy
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.structure import to_padded
from repro_torch.launch.mesh import GroupSpec, halo_groups, run_group
from repro_torch.launch.obsflags import add_obs_args, obs_session
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init
from repro_torch.obs import metrics, trace
from repro_torch.obs.trace import device_time_summary
from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
from repro_torch.train.optimizer import adamw

__all__ = ["HaloVariant", "RankJob", "DeltaJob", "halo_loss", "halo_rank", "halo_ranks", "halo_train_rank",
           "delta_rank", "rank_jobs", "table_widths", "main"]


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
    round_logits: bool = False           # training: the loss reads the logits rounded to bf16 (a
                                         # yardstick for the fused bf16 layer, whose output is bf16)


@dataclasses.dataclass
class RankJob:
    """What one rank needs, and nothing of the other ranks' tiles: the plan
    (host index tables, small), this rank's feature block, the parameters,
    the shared tile-table widths and the variants to run — forwards
    (`halo_rank`) and, with labels and a mask, training runs
    (`halo_train_rank`, or `halo_rank` after its forwards)."""

    plan: HaloPlan
    x: np.ndarray                        # (n_local, F) this rank's block
    params: dict
    layer_dims: tuple[int, ...]
    variants: tuple[HaloVariant, ...]
    max_nnzb: dict                       # table form → tile-table width every rank shares
    quant: QuantConfig = QuantConfig()
    time_reps: int = 0                   # > 0: time each variant and the exchange
    labels: np.ndarray | None = None     # (n_local,) this rank's labels
    mask: np.ndarray | None = None       # (n_local,) this rank's loss weights (0 on padding)
    train_variants: tuple[HaloVariant, ...] = ()
    steps: int = 0                       # Trainer steps per training variant
    lr: float = 1e-3                     # AdamW learning rate
    ckpt_dir: str | None = None          # rank 0 writes, every rank resumes
    ckpt_every: int = 50
    verbose: bool = False                # rank 0 prints the resume line and a log line every 20 steps
    obs_metrics: bool = False            # rank 0 records metrics and returns its registry
    obs_trace: bool = False              # rank 0 traces, ends with overlap_timeline, returns its recorder


def table_widths(plan: HaloPlan) -> dict:
    """The tile-table width T of each table form, shared by all ranks (O(E)
    host statistics, no tiles)."""
    split = plan_split_blocked_shape(plan)
    return {"combined": plan_blocked_shape(plan)["max_nnzb"],
            "interior": split["interior"]["max_nnzb"], "boundary": split["boundary"]["max_nnzb"]}


def rank_jobs(plan: HaloPlan, x: np.ndarray, params: dict, layer_dims, variants,
              labels: np.ndarray | None = None, mask: np.ndarray | None = None,
              **kw) -> list[RankJob]:
    """One `RankJob` per rank from the global features ``x`` (n_nodes, F)
    and, for training, the global ``labels`` (n_nodes,) and loss ``mask``
    (n_nodes,; every node when None), zero on each rank's padding rows."""
    xb = relocate_node_array(plan, x)
    widths = table_widths(plan)
    lb = mb = [None] * plan.k
    if labels is not None:
        lb = relocate_node_array(plan, np.asarray(labels, np.int64))
        mb = node_mask(plan) if mask is None else (
            relocate_node_array(plan, np.asarray(mask, np.float32)) * node_mask(plan))
    return [RankJob(plan=plan, x=xb[r], params=params, layer_dims=tuple(layer_dims),
                    variants=tuple(variants), max_nnzb=widths, labels=lb[r], mask=mb[r], **kw)
            for r in range(plan.k)]


def halo_loss(params: dict, batch: dict, cfg: GCNConfig, policy: ShardingPolicy,
              round_logits: bool = False, **fw_kwargs) -> torch.Tensor:
    """The sharded loss of ``examples/train_distributed_gcn.py`` (its
    ``loss_fn`` body), on one rank: the masked cross-entropy summed over the
    rank's rows, ``psum(wsum) / max(psum(wcnt), 1)``, over parameters
    replicated across the group (`ShardingPolicy.replicate`). Every rank
    gets the same loss, and its gradient is the unsharded one.
    ``round_logits`` rounds the logits to bf16 first (and so, in the
    backward, their cotangent), as a bf16 output of the fused layer is."""
    logits = gcn_forward(policy.replicate(params), batch["x"], batch["senders"], batch["receivers"],
                         batch["edge_w"], cfg, policy, **fw_kwargs)
    if round_logits:
        logits = logits.to(torch.bfloat16)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, batch["labels"][:, None])[:, 0]
    wsum = ((lse - gold) * batch["mask"]).sum()
    return policy.psum(wsum) / policy.psum(batch["mask"].sum()).clamp_min(1.0)


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


class _Rank:
    """One rank's share of a `RankJob` on its device: the plan's index
    tables, the feature block, the parameters and, built on first use, the
    rank's tile tables; and the model setup of each `HaloVariant`."""

    def __init__(self, rank: int, device: torch.device, job: RankJob):
        self.rank, self.device, self.job = rank, device, job
        arrs = job.plan.rank_arrays(rank, device)
        send, (senders, receivers, edge_w) = arrs[:-3], arrs[-3:]
        # Flat: send_idx; hierarchical: send_loc, send_rem and the rank's (pod, model) groups.
        self.send = {"send_loc": send[0], "send_rem": send[1]} if len(send) == 2 else {"send_idx": send[0]}
        self.groups = halo_groups(job.plan.n_pods)
        self.batch = {"x": torch.from_numpy(job.x).to(device).float(), "senders": senders,
                      "receivers": receivers, "edge_w": edge_w}
        if job.labels is not None:
            self.batch["labels"] = torch.from_numpy(job.labels).to(device).long()
            self.batch["mask"] = torch.from_numpy(job.mask).to(device).float()
        self.params = {name: torch.from_numpy(np.asarray(v)).to(device) for name, v in job.params.items()}
        self._tables = {}

    def table(self, part: str):
        if part not in self._tables:
            ba = plan_blocked_rank(self.job.plan, self.rank, part=part, max_nnzb=self.job.max_nnzb[part])
            self._tables[part] = ba.arrays(device=self.device)
        return self._tables[part]

    def policy(self, **kw) -> ShardingPolicy:
        """An armed halo policy of this rank (flat or hierarchical, as the
        plan is) with the fields ``kw``."""
        return ShardingPolicy(comm="halo", halo_groups=self.groups, **kw).bind_halo(**self.send)

    def setup(self, v: HaloVariant) -> tuple[GCNConfig, ShardingPolicy, dict]:
        """The config, armed policy and table arguments of ``v``."""
        cfg = GCNConfig(layer_dims=self.job.layer_dims, dataflow=v.dataflow, backend=v.backend,
                        quant=self.job.quant if v.quant else QuantConfig(enabled=False))
        policy = self.policy(halo_via=v.via, halo_payload=v.payload, halo_overlap=v.overlap)
        kw = {}
        if v.backend == "bsr":
            kw["adjacency"] = self.table("interior" if v.split else "combined")
            if v.split:
                kw["adjacency_boundary"] = self.table("boundary")
        return cfg, policy, kw

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _launches() -> dict:
    from repro_torch.kernels import fused_gcn as fg

    return {name: n for name, n in fg.LAUNCHES.items() if n}


@contextlib.contextmanager
def _wire_counter():
    """Yields ``read()``: the wire rows and bytes this rank has received so
    far (``halo.wire_rows``, ``halo.wire_bytes``, and the hierarchical
    exchange's rows per phase), to be read as differences, from the
    registry already enabled (``--metrics``) or from one enabled for the
    block."""
    own = not metrics.enabled()
    registry = metrics.enable(metrics.MetricsRegistry()) if own else metrics.default_registry()
    counters = {"wire_rows": registry.counter("halo.wire_rows"),
                "wire_bytes": registry.counter("halo.wire_bytes"),
                "wire_rows_inter_pod": registry.counter("halo.wire_rows", (("phase", "inter_pod"),)),
                "wire_rows_intra_pod": registry.counter("halo.wire_rows", (("phase", "intra_pod"),))}
    try:
        yield lambda: {name: int(c.value) for name, c in counters.items()}
    finally:
        if own:
            metrics.disable()


def _since(now: dict, then: dict) -> dict:
    return {name: now[name] - then[name] for name in now}


def _obs_start(rank: int, job: RankJob) -> None:
    """Rank 0 turns on the telemetry the job asks for."""
    if rank == 0 and job.obs_metrics:
        metrics.enable(metrics.MetricsRegistry())
    if rank == 0 and job.obs_trace:
        trace.set_default_tracer(trace.TraceRecorder(process_name="repro_torch rank 0"))


def _obs_end(r: "_Rank", out: dict) -> None:
    """End of a rank's run with telemetry: rank 0 folds the plan's wire
    model into its registry; every rank runs `overlap_timeline` (its
    collective needs the whole group), and rank 0 records it. Rank 0's
    registry and recorder go into ``out``."""
    from repro_torch.obs.instrument import overlap_timeline, record_exchange

    job = r.job
    if r.rank == 0 and job.obs_metrics:
        record_exchange(job.plan, int(r.batch["x"].shape[1]))
    if job.obs_trace:
        tracer = trace.default_tracer() if r.rank == 0 else trace.TraceRecorder()
        overlap_timeline(job.plan, r.batch["x"], r.groups, tracer=tracer)
    if r.rank == 0:
        out["obs"] = {"registry": metrics.default_registry() if job.obs_metrics else None,
                      "tracer": trace.default_tracer() if job.obs_trace else None}


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
    its idle share), and this rank's peak device memory. With
    ``job.train_variants``, then also `halo_train_rank`'s report under
    ``"train"``, on the same tables.
    """
    from repro_torch.kernels import fused_gcn as fg

    _obs_start(rank, job)
    r = _Rank(rank, device, job)
    plan, b = job.plan, r.batch
    out: dict = {"rank": rank, "variants": {}}
    runs = {}
    with _wire_counter() as wire:
        for v in job.variants:
            cfg, policy, kw = r.setup(v)

            def forward(cfg=cfg, policy=policy, kw=kw):
                return gcn_forward(r.params, b["x"], b["senders"], b["receivers"], b["edge_w"], cfg, policy, **kw)

            with torch.inference_mode():
                r.sync()
                fg.reset_launch_counts()
                before = wire()
                logits = forward()
                r.sync()
                out["variants"][v.name] = {
                    "logits": logits.float().cpu().numpy(), "dtype": str(logits.dtype).removeprefix("torch."),
                    "launches": _launches(), **_since(wire(), before),
                    "finite": bool(torch.isfinite(logits).all())}
            runs[v.name] = forward

    if job.time_reps and device.type == "cuda":
        with torch.inference_mode():
            for name, forward in runs.items():
                out["variants"][name]["forward_ms"] = _cuda_ms(forward, device, job.time_reps)
            z = torch.randn((plan.n_local, job.layer_dims[1]),
                            generator=torch.Generator().manual_seed(rank)).to(device)
            out["exchange_ms"] = {}
            for payload in (None, "bf16", "int8"):
                pol = r.policy(halo_payload=payload)
                out["exchange_ms"][payload or "fp32"] = _cuda_ms(lambda: pol.halo_block(z), device,
                                                                  job.time_reps)
            if plan.is_hierarchical:
                out["exchange_phase_ms"] = _phase_ms(r, z)
            out["profile"] = _profile(runs[job.variants[0].name], device)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if job.train_variants:
        out["train"] = _train_variants(r)
    if job.obs_metrics or job.obs_trace:
        _obs_end(r, out)
    dist.barrier()
    return out


def halo_ranks(rank: int, k: int, device: torch.device, jobs: tuple[RankJob, ...]) -> list[dict]:
    """`halo_rank` on each of ``jobs`` in turn, in one group: plans of the
    same k and pods (a default and an autotuned pod map) without starting
    another group. Each job's tables are freed before the next one's are
    built, and each job's peak memory is its own."""
    out = []
    for job in jobs:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        out.append(halo_rank(rank, k, device, job))
    return out


def _phase_ms(r: "_Rank", z: torch.Tensor) -> dict:
    """CUDA-event ms of each phase of the hierarchical exchange of ``z`` per
    payload: phase 1 gathers the ``send_rem`` rows over the pod group,
    phase 2 the ``[send_loc ‖ phase-1]`` block over the model group."""
    from repro_torch.dist.halo import _hier_phase1_start, _hier_phase2

    pod, model = r.groups
    loc, rem = r.send["send_loc"], r.send["send_rem"]
    out = {}
    for payload in (None, "bf16", "int8"):
        inter = _hier_phase1_start(z, rem, pod, "all_gather", payload)()
        out[payload or "fp32"] = {
            "inter_pod": _cuda_ms(lambda: _hier_phase1_start(z, rem, pod, "all_gather", payload)(), r.device,
                                  r.job.time_reps),
            "intra_pod": _cuda_ms(lambda: _hier_phase2(z, loc, inter, model, "all_gather", payload), r.device,
                                  r.job.time_reps)}
    return out


def halo_train_rank(rank: int, k: int, device: torch.device, job: RankJob) -> dict:
    """The training body of one rank: `_train_variants` of ``job``, then
    the telemetry's end (``job.obs_metrics``, ``job.obs_trace``)."""
    _obs_start(rank, job)
    r = _Rank(rank, device, job)
    out = {"rank": rank, "train": _train_variants(r)}
    if job.obs_metrics or job.obs_trace:
        _obs_end(r, out)
    dist.barrier()
    return out


def _train_variants(r: _Rank) -> dict:
    """Train every one of ``job.train_variants`` on this rank, each from the
    job's parameters, on `halo_loss`.

    Per variant: the loss and the gradient (numpy) at the job's
    parameters; a `Trainer` (AdamW at ``job.lr``, resumed from
    ``job.ckpt_dir`` if a checkpoint is there, which only rank 0 writes)
    taking ``job.steps`` steps, with the kernel launches and the wire rows
    and bytes (forward and backward exchanges) of those steps, counted from
    zero just before and read just after; the losses, the step reached, the
    straggler events, the trained parameters and the logits of one forward
    with them. With ``job.time_reps`` on the card: the median step ms (host
    clock, each step after a group barrier, after two warm-ups), the ms of
    one exchange's backward per payload (a block of the hidden width, the
    width both layers exchange), and this rank's peak device memory over
    the training runs."""
    from repro_torch.kernels import fused_gcn as fg

    job, device, b = r.job, r.device, r.batch
    if job.labels is None:
        raise ValueError("training variants need labels and a mask in the RankJob")
    log = print if (job.verbose and r.rank == 0) else (lambda line: None)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out: dict = {}
    for v in job.train_variants:
        cfg, policy, kw = r.setup(v)

        def loss_fn(params, batch, cfg=cfg, policy=policy, kw=kw, rnd=v.round_logits):
            return halo_loss(params, batch, cfg, policy, round_logits=rnd, **kw)

        loss0, grads = value_and_grad(loss_fn, r.params, b)
        tr = Trainer(loss_fn, adamw(job.lr), r.params,
                     TrainerConfig(ckpt_dir=job.ckpt_dir, ckpt_every=job.ckpt_every, log_every=20))
        resumed = tr.resume()
        log(f"checkpoints → {job.ckpt_dir} (resumed={resumed}, step={tr.step})")
        with _wire_counter() as counts:
            before = counts()
            r.sync()
            fg.reset_launch_counts()
            step0 = tr.step
            losses = tr.fit(iter(lambda: b, None), max_steps=job.steps, log=log)
            r.sync()
            launches = _launches()
            wire = _since(counts(), before)
        with torch.inference_mode():
            logits = gcn_forward(tr.params, b["x"], b["senders"], b["receivers"], b["edge_w"], cfg, policy, **kw)
        rec = {"loss0": float(loss0), "grads": {n: g.float().cpu().numpy() for n, g in grads.items()},
               "losses": losses, "steps_run": tr.step - step0, "step": tr.step, "resumed": resumed,
               "stragglers": len(tr.straggler_events), "launches": launches, **wire,
               "params": {n: p.float().cpu().numpy() for n, p in tr.params.items()},
               "logits": logits.float().cpu().numpy(),
               "finite": bool(np.isfinite(losses).all() and all(torch.isfinite(g).all() for g in grads.values())
                              and torch.isfinite(logits.float()).all())}
        if job.time_reps and cuda:
            rec["step_ms"] = _step_ms(tr, b, device, job.time_reps)
        out[v.name] = rec
        del tr, grads
    if job.time_reps and cuda:
        out["exchange_backward_ms"] = _exchange_backward_ms(r)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def _step_ms(tr: Trainer, batch: dict, device: torch.device, reps: int, warmup: int = 2) -> float:
    """Median host-clock ms of one `Trainer` step (ending in ``float(loss)``
    and a synchronize), each started after a group barrier."""
    times = []
    for i in range(warmup + reps):
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(tr.params, tr.opt_state, tr.residual, batch)
        float(loss)
        torch.cuda.synchronize(device)
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _exchange_backward_ms(r: _Rank) -> dict:
    """CUDA-event ms of the backward of one exchange of a hidden-width block,
    per payload (the cotangent crosses the group; int8 sends only the
    scales' cotangents)."""
    job = r.job
    z = torch.randn((job.plan.n_local, job.layer_dims[1]),
                    generator=torch.Generator().manual_seed(r.rank)).to(r.device).requires_grad_(True)
    out = {}
    for payload in (None, "bf16", "int8"):
        pol = r.policy(halo_payload=payload)
        halo = pol.halo_block(z)
        ct = torch.ones_like(halo)
        out[payload or "fp32"] = _cuda_ms(
            lambda: torch.autograd.grad(halo, z, ct, retain_graph=True), r.device, job.time_reps)
    return out


# ==================================================== a mutating graph's ranks
@dataclasses.dataclass
class DeltaJob:
    """What one rank needs to follow a mutating graph (`delta_rank`): the
    inputs of its `DeltaPlanner` replica — every rank builds its own from
    the same ``(part, edge_index, w)`` and applies the same pickled
    deltas, so the replicas stay identical and no process holds another
    rank's tiles —, this rank's blocks under the first layout, the
    parameters, and the mutation script: each of ``deltas`` followed by
    ``train_steps[i]`` AdamW steps (one `Trainer` throughout), then the
    ``burst`` under a `RelocalizePolicy` of fields ``policy``, then
    `DeltaPlanner.compact`."""

    part: Any
    edge_index: np.ndarray
    w: np.ndarray
    x: np.ndarray                        # (n_local, F) this rank's features, first layout
    labels: np.ndarray                   # (n_local,)
    mask: np.ndarray                     # (n_local,) loss weights, 0 on padding
    params: dict
    layer_dims: tuple[int, ...]
    deltas: tuple = ()
    train_steps: tuple[int, ...] = ()
    lr: float = 1e-3
    pods: int = 2                        # the hierarchical plan beside the flat one (1: flat only)
    policy: dict | None = None
    burst: tuple = ()
    time_reps: int = 0                   # > 0 on the card: forward and step ms
    graph_key: str = "delta"


def rewire_weight(planner, edge_index: np.ndarray) -> np.ndarray:
    """Weights of inserted edges: an edge the graph already holds gets the
    weight of its instances, a new one a pure function of (u, v). Every
    instance of an edge then has one weight, so whichever instance a delete
    takes — a re-localized store orders parallel instances anew — every
    replica and the plain edge list agree."""
    ei = np.asarray(edge_index, np.int64)
    w = (0.1 + (ei[0] * 131 + ei[1] * 17) % 97 / 97.0).astype(np.float32)
    cur = planner.edge_index()
    key_cur = cur[0] * planner.n + cur[1]
    order = np.argsort(key_cur, kind="stable")
    key_ins = ei[0] * planner.n + ei[1]
    pos = np.minimum(np.searchsorted(key_cur[order], key_ins), max(order.size - 1, 0))
    if order.size:
        hit = key_cur[order][pos] == key_ins
        w[hit] = planner.edge_weights()[order][pos[hit]]
    return w


def patch_delta(planner, rng: np.random.Generator, n_ops: int):
    """A delta no tier can grow on: delete ``n_ops`` existing edges and
    insert ``n_ops`` edges between two nodes of one device — the tile-patch
    path (new tiles append, emptied tiles are tombstoned)."""
    from repro_torch.dist.delta import GraphDelta

    ei = planner.edge_index()
    drop = rng.choice(ei.shape[1], n_ops, replace=False)
    a = planner.assignment
    dev = rng.integers(0, planner.k, n_ops)
    members = [np.flatnonzero(a == d) for d in range(planner.k)]
    ins = np.stack([np.array([m[rng.integers(0, m.size)] for m in (members[d] for d in dev)]),
                    np.array([m[rng.integers(0, m.size)] for m in (members[d] for d in dev)])])
    return GraphDelta(edge_inserts=ins, edge_deletes=ei[:, drop], insert_w=rewire_weight(planner, ins))


def structural_delta(planner):
    """A delta that grows the flat export pad (a structural repair): the
    device with the most exported rows gets new cut edges from rows it does
    not export yet, one more than the pad has room for, each into the first
    row of the next device."""
    from repro_torch.dist.delta import GraphDelta

    ei = planner.edge_index()
    a = planner.assignment
    cut = a[ei[0]] != a[ei[1]]
    pad = int(planner.plan().s_max)
    exported = [np.unique(ei[0][cut & (a[ei[0]] == d)]) for d in range(planner.k)]
    d = int(np.argmax([e.size for e in exported]))
    fresh = np.setdiff1d(np.flatnonzero(a == d), exported[d])[: pad - exported[d].size + 1]
    dst = np.full(fresh.size, int(np.flatnonzero(a == (d + 1) % planner.k)[0]), np.int64)
    ins = np.stack([fresh.astype(np.int64), dst])
    return GraphDelta(edge_inserts=ins, insert_w=rewire_weight(planner, ins))


def rewire_delta(planner, rng: np.random.Generator, members: int, max_edges: int):
    """The rewiring churn of the reference's online-maintenance test: sever
    up to ``max_edges`` edges incident to ``members`` random nodes and
    re-insert as many among those nodes (no self-loops) — locality decays
    while E stays fixed."""
    from repro_torch.dist.delta import GraphDelta

    cur = planner.edge_index()
    mem = rng.choice(planner.n, members, replace=False)
    inc = np.flatnonzero(np.isin(cur[0], mem) | np.isin(cur[1], mem))[:max_edges]
    s = mem[rng.integers(0, mem.size, inc.size)]
    d = mem[rng.integers(0, mem.size, inc.size)]
    bad = s == d
    d[bad] = mem[(np.searchsorted(np.sort(mem), d[bad]) + 1) % mem.size]
    ins = np.stack([s, d])
    return GraphDelta(edge_inserts=ins, edge_deletes=cur[:, inc], insert_w=rewire_weight(planner, ins))


def mutation_script(part, edge_index: np.ndarray, w: np.ndarray, *, pods: int = 2, seed: int = 0,
                    patch_ops: int = 64, members: int = 20, max_edges: int = 24, policy: dict,
                    max_burst: int = 24, graph_key: str = "delta") -> dict:
    """The mutation script of a `DeltaJob`, made and checked on a replica
    of the ranks' planner (flat and, with ``pods`` > 1, hierarchical plans;
    no tables): a `patch_delta` that must not be structural, a
    `structural_delta` that must be, then `rewire_delta`s under a
    `RelocalizePolicy` of fields ``policy`` until it fires and one delta
    more (inside the cooldown, so that `compact` finds slack), then
    `compact`. Returns the deltas, the burst, each stage's edges, weights,
    layout and `plan_checksum` (the stages `delta_rank` reports), the
    reports and the drift readings of the burst. Raises if the policy never
    fires within ``max_burst`` deltas."""
    from repro_torch.dist.delta import DeltaPlanner, RelocalizePolicy
    from repro_torch.dist.halo import plan_layout

    rng = np.random.default_rng(seed)
    planner = DeltaPlanner(part, edge_index, w, graph_key=graph_key)
    plans = {"flat": planner.plan()}
    if pods > 1:
        plans["hier"] = planner.plan(("pod", "model"), pods=pods)
    stages = {}

    def snap(name):
        stages[name] = {"edge_index": planner.edge_index(), "w": planner.edge_weights(),
                        "layout": plan_layout(planner), "checksum": plan_checksum(planner, plans),
                        "version": planner.version}

    snap("v0")
    deltas = (patch_delta(planner, rng, patch_ops), None)
    reports = [planner.apply(deltas[0])]
    snap("delta1")
    deltas = (deltas[0], structural_delta(planner))
    reports.append(planner.apply(deltas[1]))
    snap("delta2")
    if reports[0]["structural"] or not reports[1]["structural"]:
        raise RuntimeError(f"mutation script: expected a tile-patch then a structural delta, got "
                           f"{[r['structural'] for r in reports]}")
    planner.relocalize_policy = RelocalizePolicy(**policy)
    burst, drift, fired = [], [], None
    while len(burst) < max_burst:
        burst.append(rewire_delta(planner, rng, members, max_edges))
        rep = planner.apply(burst[-1])
        reports.append(rep)
        drift.append(rep["drift"]["drift_ratio"])
        if rep["relocalized"] is not None:
            fired = len(burst)
            snap("relocalized")
            burst.append(rewire_delta(planner, rng, members, max_edges))
            reports.append(planner.apply(burst[-1]))
            break
    if fired is None:
        raise RuntimeError(f"mutation script: the policy never fired over {max_burst} deltas "
                           f"(drift readings {drift})")
    compact = planner.compact()
    snap("compact")
    return {"deltas": deltas, "burst": tuple(burst), "stages": stages, "reports": reports,
            "drift": drift, "compact": compact, "fired_at": fired, "planner": planner}


TABLE_KERNEL_RTOL = 1e-4                 # kernel vs plain on a patched table: max |diff| ≤ this · max |plain|


def plan_checksum(planner, plans: dict) -> str:
    """sha1 over the planner's version, layout and every plan's index
    tables — equal on every rank iff the replicas agree."""
    h = hashlib.sha1(np.int64(planner.version).tobytes())
    h.update(np.ascontiguousarray(planner.perm).tobytes())
    for name in sorted(plans):
        p = plans[name]
        for a in (p.send_idx, p.send_loc, p.send_rem, p.senders_l, p.receivers_l, p.edge_w):
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def array_checksum(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def same_tiles(a, b) -> bool:
    """Two `BlockedAdjacency` tables hold the same tiles: per block-row the
    same set of column blocks, each with the same 128×128 tile, whatever
    their order in the ragged row and whatever the padding width — what
    densifying both would compare, tile for tile."""
    if not np.array_equal(a.row_nnzb, b.row_nnzb) or a.n_block_cols != b.n_block_cols:
        return False

    def valid(t):
        mask = np.arange(t.max_nnzb)[None, :] < t.row_nnzb[:, None]
        rows, slots = np.nonzero(mask)
        keys = rows * t.n_block_cols + t.block_cols[rows, slots]
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order], slots[order]

    ka, ra, sa = valid(a)
    kb, rb, sb = valid(b)
    if not np.array_equal(ka, kb):
        return False
    step = 512                               # compare in chunks: no second copy of every tile
    return all(np.array_equal(a.block_vals[ra[i:i + step], sa[i:i + step]],
                              b.block_vals[rb[i:i + step], sb[i:i + step]])
               for i in range(0, ka.size, step))


def table_kernel_checks(ba, x: torch.Tensor, params: dict, rtol: float, device: torch.device,
                        seed: int = 0) -> dict:
    """K2's three kernels and K1 on one rank's table ``ba`` against their
    plain versions (max |diff| ≤ ``rtol`` · max |plain|), then with NaN in
    every padding tile (`poison_padding`): finite and bit-equal to the
    clean run. Operands at the rank's shapes: its feature block ``x``
    (layer 1's transform), random 16-wide tables over the table's column
    space (the aggregations and K1), the parameters of both layers. On the
    CPU, where no kernel runs, the plain versions stand in for the kernels
    (the poisoned runs still prove that no padding tile is read)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = ba.arrays(device=device)
    g = torch.Generator().manual_seed(seed)
    w0, b0, w1, b1 = (params[n] for n in ("w0", "b0", "w1", "b1"))
    x_pad = torch.zeros((ba.n_padded, x.shape[1]), device=device)
    x_pad[: x.shape[0]] = x
    z = torch.randn((ba.n_col_padded, w0.shape[1]), generator=g).to(device)
    table = torch.randn((ba.n_col_padded, w1.shape[0]), generator=g).to(device)
    out: dict = {}

    def hold(name, got, ref):
        err = float((got.float() - ref.float()).abs().nan_to_num(nan=float("inf")).max())
        scale = float(ref.float().abs().max())
        out[name] = {"max_abs_err": err, "max_abs_ref": scale, "ok": err <= rtol * scale}

    cuda = device.type == "cuda"
    ff_transform, ff_aggregate, af_layer, bsr_spmm = (
        (fg.ff_transform, fg.ff_aggregate, fg.af_layer, k1.bsr_spmm) if cuda
        else (fg.ff_transform_plain, fg.ff_aggregate_plain, fg.af_layer_plain, k1.bsr_spmm_plain))
    with torch.inference_mode():
        hold("k2_ff_transform", ff_transform(x_pad, w0), fg.ff_transform_plain(x_pad, w0))
        runs = {
            "k2_ff_aggregate": (lambda v: ff_aggregate(v, cols, lens, z, b0, True),
                                fg.ff_aggregate_plain(vals, cols, lens, z, b0, True)),
            "k2_af_layer": (lambda v: af_layer(v, cols, lens, table, w1, b1, True),
                            fg.af_layer_plain(vals, cols, lens, table, w1, b1, True)),
            "k1_bsr_spmm": (lambda v: bsr_spmm(v, cols, lens, table),
                            k1.bsr_spmm_plain(vals, cols, lens, table)),
        }
        poisoned = poison_padding(vals, lens)
        for name, (run, ref) in runs.items():
            clean = run(vals)
            hold(name, clean, ref)
            dirty = run(poisoned)
            out[name + " (poisoned padding)"] = {
                "finite": bool(torch.isfinite(dirty).all()), "same_bits": bool(torch.equal(dirty, clean)),
                "ok": bool(torch.isfinite(dirty).all()) and bool(torch.equal(dirty, clean))}
    return out


def delta_rank(rank: int, k: int, device: torch.device, job: DeltaJob) -> dict:
    """The body of one rank following a mutating graph (`run_group`).

    The rank builds its `DeltaPlanner` replica, the flat plan and (``pods``
    > 1) the hierarchical one, and its own rank table of each
    (`DeltaPlanner.rank_table`: its tiles, every rank's index). At every
    stage — before any delta, after each of ``deltas``, after the
    relocalize the burst's policy fires, after `compact` — it re-binds its
    send tables, ``(senders, receivers, edge_w)`` and tables, and runs the
    bsr forward (fp32, quant off) of each schedule, with the kernel
    launches counted from zero just before and read just after. After each
    of ``deltas`` it takes ``train_steps[i]`` AdamW steps of one `Trainer`
    on `halo_loss` (flat schedule), launches counted likewise. After a
    re-localization its feature, label and mask blocks move to the new
    layout through `relocate_state_tree` (the blocks of every rank
    all-gathered, moved, this rank's taken).

    Returns per stage: the logits per schedule, launches, each table's
    maintenance (``patched`` / ``unchanged`` / ``rebuilt``, its ms, width,
    growths), the planner's version and `plan_checksum`; on rank 0 also
    each table against a fresh `plan_blocked_rank` of the repaired
    plan (`same_tiles`; after `compact`, array-equal at the width a fresh
    build shares) and, after each of ``deltas``, `table_kernel_checks` on
    its flat table; every apply's report and, for the burst's deltas,
    each table's maintenance, width and host bytes; the training losses
    and launches; checksums of the moved blocks; with ``time_reps`` on the
    card: forward ms per stage and schedule, step ms before the deltas and
    after `compact`, and the rank's peak device memory."""
    from repro_torch.dist.delta import DeltaPlanner, RelocalizePolicy
    from repro_torch.dist.halo import plan_layout
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.train.elastic import relocate_state_tree

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    planner = DeltaPlanner(job.part, job.edge_index, job.w, graph_key=job.graph_key)
    plans = {"flat": planner.plan()}
    if job.pods > 1:
        plans["hier"] = planner.plan(("pod", "model"), pods=job.pods)
    groups = {name: halo_groups(p.n_pods) for name, p in plans.items()}
    tables = {name: planner.rank_table(p, rank) for name, p in plans.items()}
    cfg = GCNConfig(layer_dims=job.layer_dims, backend="bsr", quant=QuantConfig(enabled=False))
    params = {n: torch.from_numpy(np.asarray(v)).to(device) for n, v in job.params.items()}
    state = {"x": np.asarray(job.x, np.float32), "labels": np.asarray(job.labels, np.int64),
             "mask": np.asarray(job.mask, np.float32)}
    out: dict = {"rank": rank, "stages": [], "reports": [], "train": [], "moved": None}
    checking = rank == 0                 # rank 0 holds its tables against fresh builds

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def bind() -> dict:
        x = torch.from_numpy(state["x"]).to(device)
        labels = torch.from_numpy(state["labels"]).to(device)
        mask = torch.from_numpy(state["mask"]).to(device)
        batches = {}
        for name, p in plans.items():
            arrs = p.rank_arrays(rank, device)
            send = ({"send_loc": arrs[0], "send_rem": arrs[1]} if p.is_hierarchical
                    else {"send_idx": arrs[0]})
            batches[name] = {
                "x": x, "senders": arrs[-3], "receivers": arrs[-2], "edge_w": arrs[-1],
                "labels": labels, "mask": mask,
                "policy": ShardingPolicy(comm="halo", halo_groups=groups[name]).bind_halo(**send),
                "adjacency": tables[name].blocked().arrays(device=device)}
        return batches

    def forward(b):
        return gcn_forward(params, b["x"], b["senders"], b["receivers"], b["edge_w"], cfg, b["policy"],
                           adjacency=b["adjacency"])

    def loss_fn(p, b):
        return halo_loss(p, b, cfg, b["policy"], adjacency=b["adjacency"])

    def stage(name: str, kernels: bool = False, final: bool = False) -> dict:
        batches = bind()
        rec = {"name": name, "version": planner.version, "checksum": plan_checksum(planner, plans),
               "pads": {n: {"s_max": p.s_max, "s_loc": p.s_loc, "s_rem": p.s_rem, "n_local": p.n_local,
                            "e_local": p.e_local} for n, p in plans.items()},
               "tables": {n: {"last": t.last, "ms": t.maintain_ms, "max_nnzb": t.max_nnzb,
                              "tiles": int(t.lens[rank].sum()), "grown": t.grown,
                              "host_gb": t.nbytes / 1e9} for n, t in tables.items()},
               "logits": {}}
        with torch.inference_mode():
            sync()
            fg.reset_launch_counts()
            for n, b in batches.items():
                rec["logits"][n] = forward(b).float().cpu().numpy()
            sync()
            rec["launches"] = _launches()
            if job.time_reps and cuda:
                rec["forward_ms"] = {n: _cuda_ms(lambda b=b: forward(b), device, job.time_reps)
                                     for n, b in batches.items()}
        if checking:
            rec["table_check"] = {}
            for n, p in plans.items():
                t0 = time.perf_counter()
                if final:
                    width = plan_blocked_shape(p)["max_nnzb"]
                    fresh = plan_blocked_rank(p, rank, max_nnzb=width)
                    mine = tables[n].blocked()
                    same = (tables[n].max_nnzb == width and np.array_equal(mine.block_vals, fresh.block_vals)
                            and np.array_equal(mine.block_cols, fresh.block_cols)
                            and np.array_equal(mine.row_nnzb, fresh.row_nnzb))
                else:
                    fresh = plan_blocked_rank(p, rank)
                    same = same_tiles(tables[n].blocked(), fresh)
                rec["table_check"][n] = {"same": bool(same), "fresh_build_ms": (time.perf_counter() - t0) * 1e3}
                del fresh
            if kernels:
                rec["kernels"] = table_kernel_checks(tables["flat"].blocked(), batches["flat"]["x"], params,
                                                     TABLE_KERNEL_RTOL, device, seed=len(out["stages"]))
        out["stages"].append(rec)
        return batches

    def move_state(old_layout) -> dict:
        """All-gather every rank's blocks, move them into the new layout,
        keep this rank's; returns their checksums."""
        tree = {}
        for key, arr in state.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            parts = [torch.empty_like(t) for _ in range(k)]
            dist.all_gather(parts, t)
            tree[key] = np.stack([q.numpy() for q in parts])
        moved = relocate_state_tree(old_layout, plan_layout(planner), tree)
        state.update({key: np.ascontiguousarray(v[rank]) for key, v in moved.items()})
        return {key: array_checksum(v) for key, v in state.items()}

    def timed_steps() -> float | None:
        if not (job.time_reps and cuda):
            return None
        tr = Trainer(loss_fn, adamw(job.lr), params, TrainerConfig(log_every=1 << 30))
        return _step_ms(tr, bind()["flat"], device, job.time_reps)

    batches = stage("v0")
    out["step_ms_before"] = timed_steps()
    trainer = Trainer(loss_fn, adamw(job.lr), params, TrainerConfig(log_every=1 << 30))
    for i, delta in enumerate(job.deltas):
        out["reports"].append(planner.apply(delta))
        batches = stage(f"delta{i + 1}", kernels=True)
        steps = job.train_steps[i] if i < len(job.train_steps) else 0
        if steps:
            sync()
            fg.reset_launch_counts()
            losses = trainer.fit(iter(lambda: batches["flat"], None), max_steps=trainer.step + steps)
            sync()
            out["train"].append({"after": f"delta{i + 1}", "losses": losses, "launches": _launches()})
    if job.policy is not None:
        planner.relocalize_policy = RelocalizePolicy(**job.policy)
    out["burst_tables"] = []
    for delta in job.burst:
        rep = planner.apply(delta)
        out["reports"].append(rep)
        out["burst_tables"].append({n: {"last": t.last, "ms": t.maintain_ms, "max_nnzb": t.max_nnzb,
                                        "grown": t.grown, "host_gb": t.nbytes / 1e9} for n, t in tables.items()})
        if rep["relocalized"] is not None:
            out["moved"] = move_state(rep["relocalized"]["old_layout"])
            stage("relocalized")
    if job.burst:
        out["compact"] = planner.compact()
        stage("compact", final=True)
        out["step_ms_after"] = timed_steps()
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    dist.barrier()
    return out


def _plan_lines(spec, gs, plan) -> list[str]:
    hier = plan.is_hierarchical
    lines = [f"graph: {spec.name} n={gs.n_nodes} e={gs.n_edges} → k={plan.k} n_local={plan.n_local} "
             + (f"s_loc={plan.s_loc} s_rem={plan.s_rem}" if hier else f"s_max={plan.s_max}")]
    if plan.k > 1:
        lines.append(
            f"wire/device/layer: halo {plan.halo_rows_per_device} rows vs "
            f"broadcast {plan.broadcast_rows_per_device} rows "
            f"({plan.wire_fraction():.3f}× — DESIGN.md §8)")
    if hier:
        lines.append(
            f"inter-pod crossing/device/layer: {plan.inter_pod_rows_crossing} rows "
            f"hierarchical vs {plan.flat_inter_pod_rows_crossing} flat (docs/communication.md)")
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
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps (0: evaluate the halo forward of untrained parameters)")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoints (a fresh temporary directory if unset)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods for the hierarchical (pod, model) halo schedule "
                         "(must divide --k; 1 = flat single-group)")
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu'")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.steps < 0:
        raise ValueError(f"--steps must be ≥ 0, got {args.steps}")
    if args.pods < 1 or args.k % args.pods:
        raise SystemExit(f"--pods {args.pods} must divide the rank count {args.k}")
    with obs_session(args):
        return run(args)


def run(args) -> dict:
    """The example's body, inside the obs session of `main`."""
    device = resolve_device(args.device)
    spec, g = make_dataset("cora", reduced=True)
    gs = g.symmetrized().with_self_loops()
    w = gs.sym_normalized_weights()
    part = partition_graph(gs.n_nodes, gs.edge_index, args.k, method="bfs", seed=0, refine=True)
    pods_kw = {"pods": args.pods} if args.pods > 1 else {}
    plan = get_halo_plan(part, gs.edge_index, w, **pods_kw)   # miss: builds the relocation
    plan = get_halo_plan(part, gs.edge_index, w, **pods_kw)   # hit: every reuse is free
    for line in _plan_lines(spec, gs, plan):
        print(line)

    cfg = GCNConfig(layer_dims=(spec.n_features, spec.hidden, spec.n_labels))
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    variant = HaloVariant(name="run", backend=args.backend,
                          payload=None if args.payload == "fp32" else args.payload,
                          split=args.backend == "bsr" and args.overlap, overlap=args.overlap)
    x = g.features.astype(np.float32)
    np_params = {n: p.numpy() for n, p in params.items()}
    group = GroupSpec(k=args.k, backend="gloo", devices=(str(device if device.type == "cpu" else "cuda:0"),))
    if device.type == "cuda" and args.backend == "bsr":
        # Build once here: the ranks then only load the library.
        from repro_torch.kernels import _build

        _build.build(["fused_gcn"])
    print(f"group: {group.describe()}" + (f" as {plan.n_pods} pods × {plan.k_model}" if args.pods > 1 else ""))
    obs = {"obs_metrics": bool(args.metrics), "obs_trace": bool(args.trace)}
    if args.trace:
        print("tracing overlap: boundary collective (wire track) vs interior compute")
    if args.steps > 0:
        return _train(args, spec, g, plan, cfg, np_params, variant, group, obs)

    jobs = rank_jobs(plan, x, np_params, cfg.layer_dims, [variant], **obs)
    results = run_group(group, halo_rank, jobs)
    _install_rank0_obs(results[0])
    logits = restore_node_array(plan, np.stack([r["variants"]["run"]["logits"] for r in results]))
    with torch.inference_mode():
        pg = to_padded(gs, weights=w, device=device)
        ref = gcn_forward({n: p.to(device) for n, p in params.items()},
                          torch.from_numpy(x).to(device), pg.senders, pg.receivers, pg.edge_weight,
                          cfg).cpu().numpy()
    acc = float((logits.argmax(-1) == g.labels).mean())
    diff = float(np.abs(logits - ref).max())
    rows = results[0]["variants"]["run"]["wire_rows"]
    print(f"eval: halo forward backend={args.backend} payload={args.payload} overlap={args.overlap} "
          f"acc={acc:.3f} (untrained); max |logit − unsharded| = {diff:.2e}; "
          f"wire rows/rank/forward = {rows} ({cfg.n_layers} × {'k_model·B + n_pods·s_rem' if args.pods > 1 else 'k·s_max'})")
    return {"acc": acc, "max_abs_diff": diff, "wire_rows": rows, "plan": plan}


def _install_rank0_obs(rank0: dict) -> None:
    """Make rank 0's registry and recorder (the run's telemetry) the ones
    the obs session exports, then mirror this process's plan cache into
    the registry (the plans are built here, not in the ranks)."""
    from repro_torch.obs.instrument import observe_plan_cache

    obs = rank0.get("obs") or {}
    if obs.get("registry") is not None:
        metrics.set_default_registry(obs["registry"])
        observe_plan_cache()
    if obs.get("tracer") is not None:
        trace.set_default_tracer(obs["tracer"])


def _train(args, spec, g, plan, cfg, params, variant, group, obs) -> dict:
    """The training half of ``examples/train_distributed_gcn.py`` over the
    group: every rank's `Trainer` (AdamW, lr 1e-2, checkpoints every 50
    steps by rank 0) on `halo_loss`, then the halo forward of the trained
    parameters."""
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="coin_ckpt_")
    jobs = rank_jobs(plan, g.features.astype(np.float32), params, cfg.layer_dims, (), labels=g.labels,
                     train_variants=(variant,), steps=args.steps, lr=1e-2, ckpt_dir=ckpt_dir, verbose=True,
                     **obs)
    results = run_group(group, halo_train_rank, jobs)
    _install_rank0_obs(results[0])
    runs = [r["train"]["run"] for r in results]
    losses = runs[0]["losses"]
    logits = restore_node_array(plan, np.stack([run["logits"] for run in runs]))
    acc = float((logits.argmax(-1) == g.labels).mean())
    stats = plan_cache_stats()
    print(f"done: step={runs[0]['step']} loss {losses[0]:.4f} → {losses[-1]:.4f} acc={acc:.3f}; "
          f"stragglers observed: {runs[0]['stragglers']}")
    print(f"plan cache: {stats['hits']} hits / {stats['misses']} misses "
          f"({stats['size']} cached) — one relocation serves all layers/steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("training must make progress")
    if not (stats["hits"] >= 1 and stats["misses"] >= 1):
        raise AssertionError(f"the plan cache must see a hit and a miss: {stats}")
    return {"acc": acc, "losses": losses, "ranks": runs, "plan": plan, "ckpt_dir": ckpt_dir,
            "cache": stats}


if __name__ == "__main__":
    main()
