"""Sharded (halo) GCN training and inference over a k-rank
`torch.distributed` group — twin of ``examples/train_distributed_gcn.py``.

    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --device cpu --steps 60
    PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --k 4 --payload bf16 --backend bsr

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

The ranks run on ``--device`` (the CUDA card unless ``--device cpu``); on
one card all k ranks share it and the group's backend is ``gloo``, whose
wire goes through the host. `halo_rank` (forwards) and `halo_train_rank`
(training) are the rank bodies, shared with `chip_smoke.py` and the tests:
they run lists of `HaloVariant`s and return each one's logits or
gradients and losses, its kernel launches and wire rows, and optionally
its times.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import tempfile
import time

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
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init
from repro_torch.obs import metrics
from repro_torch.obs.trace import device_time_summary
from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
from repro_torch.train.optimizer import adamw

__all__ = ["HaloVariant", "RankJob", "halo_loss", "halo_rank", "halo_train_rank", "rank_jobs",
           "table_widths", "main"]


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
        send_idx, senders, receivers, edge_w = job.plan.rank_arrays(rank, device)
        self.send_idx = send_idx
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

    def setup(self, v: HaloVariant) -> tuple[GCNConfig, ShardingPolicy, dict]:
        """The config, armed policy and table arguments of ``v``."""
        cfg = GCNConfig(layer_dims=self.job.layer_dims, dataflow=v.dataflow, backend=v.backend,
                        quant=self.job.quant if v.quant else QuantConfig(enabled=False))
        policy = ShardingPolicy(comm="halo", halo_via=v.via, halo_payload=v.payload,
                                halo_overlap=v.overlap).bind_halo(self.send_idx)
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

    r = _Rank(rank, device, job)
    plan, b = job.plan, r.batch
    registry = metrics.enable(metrics.MetricsRegistry())
    wire = registry.counter("halo.wire_rows")
    wire_bytes = registry.counter("halo.wire_bytes")
    out: dict = {"rank": rank, "variants": {}}
    runs = {}
    for v in job.variants:
        cfg, policy, kw = r.setup(v)

        def forward(cfg=cfg, policy=policy, kw=kw):
            return gcn_forward(r.params, b["x"], b["senders"], b["receivers"], b["edge_w"], cfg, policy, **kw)

        with torch.inference_mode():
            r.sync()
            fg.reset_launch_counts()
            rows0, bytes0 = wire.value, wire_bytes.value
            logits = forward()
            r.sync()
            out["variants"][v.name] = {
                "logits": logits.float().cpu().numpy(), "dtype": str(logits.dtype).removeprefix("torch."),
                "launches": _launches(), "wire_rows": int(wire.value - rows0),
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
                pol = ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(r.send_idx)
                out["exchange_ms"][payload or "fp32"] = _cuda_ms(lambda: pol.halo_block(z), device,
                                                                  job.time_reps)
            out["profile"] = _profile(runs[job.variants[0].name], device)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if job.train_variants:
        out["train"] = _train_variants(r)
    dist.barrier()
    return out


def halo_train_rank(rank: int, k: int, device: torch.device, job: RankJob) -> dict:
    """The training body of one rank: `_train_variants` of ``job``."""
    out = {"rank": rank, "train": _train_variants(_Rank(rank, device, job))}
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
        registry = metrics.enable(metrics.MetricsRegistry())
        r.sync()
        fg.reset_launch_counts()
        step0 = tr.step
        losses = tr.fit(iter(lambda: b, None), max_steps=job.steps, log=log)
        r.sync()
        launches = _launches()
        wire = {"wire_rows": int(registry.counter("halo.wire_rows").value),
                "wire_bytes": int(registry.counter("halo.wire_bytes").value)}
        metrics.disable()
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
        pol = ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(r.send_idx)
        halo = pol.halo_block(z)
        ct = torch.ones_like(halo)
        out[payload or "fp32"] = _cuda_ms(
            lambda: torch.autograd.grad(halo, z, ct, retain_graph=True), r.device, job.time_reps)
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
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps (0: evaluate the halo forward of untrained parameters)")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoints (a fresh temporary directory if unset)")
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.steps < 0:
        raise ValueError(f"--steps must be ≥ 0, got {args.steps}")
    device = resolve_device(args.device)

    spec, g = make_dataset("cora", reduced=True)
    gs = g.symmetrized().with_self_loops()
    w = gs.sym_normalized_weights()
    part = partition_graph(gs.n_nodes, gs.edge_index, args.k, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, gs.edge_index, w)   # miss: builds the relocation
    plan = get_halo_plan(part, gs.edge_index, w)   # hit: every reuse is free
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
    print(f"group: {group.describe()}")
    if args.steps > 0:
        return _train(args, spec, g, plan, cfg, np_params, variant, group)

    jobs = rank_jobs(plan, x, np_params, cfg.layer_dims, [variant])
    results = run_group(group, halo_rank, jobs)
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
          f"wire rows/rank/forward = {rows} ({cfg.n_layers} × k·s_max)")
    return {"acc": acc, "max_abs_diff": diff, "wire_rows": rows, "plan": plan}


def _train(args, spec, g, plan, cfg, params, variant, group) -> dict:
    """The training half of ``examples/train_distributed_gcn.py`` over the
    group: every rank's `Trainer` (AdamW, lr 1e-2, checkpoints every 50
    steps by rank 0) on `halo_loss`, then the halo forward of the trained
    parameters."""
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="coin_ckpt_")
    jobs = rank_jobs(plan, g.features.astype(np.float32), params, cfg.layer_dims, (), labels=g.labels,
                     train_variants=(variant,), steps=args.steps, lr=1e-2, ckpt_dir=ckpt_dir, verbose=True)
    results = run_group(group, halo_train_rank, jobs)
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
