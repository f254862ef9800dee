"""The dry run — twin of `repro.launch.dryrun`: every (architecture × input
shape) cell traced for one rank of the 16 × 16 and the 2 × 16 × 16 grid,
with what one step costs that rank.

The reference lowers and compiles each cell over a 256- or 512-device host
mesh and reads FLOPs and bytes from ``cost_analysis`` and the collectives
from the compiled HLO. PyTorch has no such compiler, so here one process
stands in for one rank of the grid:

* the group is a ``fake`` process group of the grid's size
  (`repro_torch.launch.mesh.fake_group`): every collective returns at
  once;
* the parameters, optimizer state and batch are meta tensors
  (`repro_torch.launch.steps.Cell.abstract_inputs`), so nothing is
  allocated or computed; the kernels' custom ops have fake versions
  (`repro_torch.kernels.ops`);
* the step runs once eagerly, forward and backward, under three counters
  (`count_step`), which the same code reads on a real step too:
  - ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
    (matmuls, convolutions, attention, and each kernel's registered
    formula);
  - ``hbm_bytes_per_device``: the bytes of every operation's inputs and
    outputs — the traffic of the unfused program, an upper bound on what
    a fused one moves (XLA's ``bytes accessed`` counts after fusion);
  - ``collective_bytes_per_device``: the port's own counting point
    (`repro_torch.dist.policy.COLLECTIVES`): per kind the bytes of each
    collective's result on this rank — the reference's
    ``collective_bytes`` — with ``total``; ``collectives_per_device``
    keeps the count and the bytes handed in beside them;
* ``memory``: the argument and output bytes of the step and a peak of the
  live meta storages (arguments included; the caching allocator's slack
  and the workspace of a kernel are not in it);
* ``lower_s`` is the trace's seconds; ``compile_s`` is null: nothing is
  compiled.

The roofline terms use the H100 SXM data sheet, not a measurement
(`repro_torch.core.planner.GPUHardware`): 67 TFLOP/s fp32 or 989 TFLOP/s
bf16 dense by the cell's parameter dtype, 3.35 TB/s of HBM3 and 450 GB/s
of NVLink a direction. ``exchange`` is the analytic wire accounting of a
halo cell (`exchange_accounting`), with the autotuner's prediction beside
it, which must equal it field by field.

The reference's ``extrapolated_cost`` and ``Cell.cost_cells`` have no
counterpart: they correct XLA's counting of a rolled ``lax.scan`` body
once; the port traces every layer, so nothing needs correcting.

Usage (the CPU suffices; the default output is ``results/dryrun_torch.json``,
never the reference's ``results/dryrun.json``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pna --shape full_graph_sm
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --optimized
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.autotune import CandidateConfig, comm_stats_from_plan, predict_config_cost
from repro_torch.core.dataflow import exchange_cost
from repro_torch.core.planner import GPUHardware
from repro_torch.core.quant import payload_bits
from repro_torch.launch.obsflags import add_obs_args, obs_session
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.obs.instrument import record_blocked, record_exchange

__all__ = ["run_cell", "collective_bytes", "count_step", "step_terms", "exchange_accounting", "load_results", "main",
           "mesh_tag", "RESULTS_PATH", "StepJob", "real_steps", "meta_steps"]

RESULTS_PATH = "results/dryrun_torch.json"
# The reference's results schema: {"schema": 2, "records": [...]}.
RESULTS_SCHEMA = 2

_HW = GPUHardware()
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet: bf16 dense on the tensor cores (a bf16 cell's compute term)
RATES = {"fp32_flops_per_s": _HW.peak_flops, "bf16_flops_per_s": BF16_FLOPS_PER_S,
         "hbm_bytes_per_s": _HW.hbm_bw, "link_bytes_per_s": _HW.ici_bw,
         "source": "NVIDIA H100 SXM data sheet (repro_torch.core.planner.GPUHardware, and 989 TFLOP/s bf16 "
                   "dense); not measured"}


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


# ------------------------------------------------------------ the counters
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpBytes(TorchDispatchMode):
    """Adds up the bytes of every operation's tensor inputs and outputs, and
    follows the live storages the step creates (freed when their last user
    goes) for a peak above the arguments."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _drop(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._seen or any(i.untyped_storage()._cdata == key for i in ins):
                continue
            n = storage.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._drop, key, n)
        return out


def collective_bytes(counts: dict) -> dict[str, float]:
    """The reference's ``collective_bytes`` record from the port's counter
    (`repro_torch.dist.policy.COLLECTIVES` over one step): per kind the
    bytes of every collective's result on this rank, and their ``total``."""
    from repro_torch.dist.policy import KINDS

    out = {kind: float(counts.get(kind, {}).get("bytes_out", 0)) for kind in KINDS}
    out["total"] = sum(out.values())
    return out


def count_step(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` once under the three counters; returns its output
    and ``flops``, ``collectives`` (kind → count, bytes_in, bytes_out, plus
    ``total``), ``op_bytes`` and ``peak_bytes`` (the live storages the step
    made, above its arguments), and ``seconds``."""
    from repro_torch.dist.policy import counting_collectives

    t0 = time.perf_counter()
    with counting_collectives() as coll, FlopCounterMode(display=False) as flops, _OpBytes() as ops:
        out = fn(*args)
    return dict(out=out, flops=float(flops.get_total_flops()), collectives={k: dict(v) for k, v in coll.items()},
                op_bytes=float(ops.bytes), peak_bytes=float(ops.peak), seconds=time.perf_counter() - t0)


def step_terms(fn, args: tuple) -> dict:
    """One step's counts and roofline terms: ``fn(*args)`` traced once
    under `count_step` (on a bound cell's meta inputs, in a fake group, for
    the dry run). Returns ``flops``, ``hbm_bytes`` (the unfused program's
    operand bytes), ``collective_bytes`` (`collective_bytes`: result bytes
    by kind and ``total``), ``collectives`` (count, bytes in and out by
    kind), ``memory`` (argument and output bytes; ``peak_bytes`` = the
    arguments + the live storages the step made at their peak), and
    ``roofline``: the three terms at the data-sheet `RATES` — the compute
    rate is bf16's when a leaf of ``args[0]`` (the parameters) is bf16 —,
    the dominant one; and ``out``, the step's output. `run_cell` and
    `repro_torch.launch.hillclimb` both read their records from here."""
    run = count_step(fn, args)
    arg_bytes = sum(_nbytes(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    out_bytes = sum(_nbytes(t) for t in tree_leaves(run["out"]) if isinstance(t, torch.Tensor))
    coll = collective_bytes(run["collectives"])
    flops, bytes_hbm = run["flops"], run["op_bytes"]
    bf16 = any(t.dtype == torch.bfloat16 for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor))
    peak = RATES["bf16_flops_per_s"] if bf16 else RATES["fp32_flops_per_s"]
    compute_s = flops / peak
    memory_s = bytes_hbm / RATES["hbm_bytes_per_s"]
    collective_s = coll["total"] / RATES["link_bytes_per_s"]
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                   key=lambda kv: kv[1])[0]
    return dict(
        out=run["out"], flops=flops, hbm_bytes=bytes_hbm, collective_bytes=coll, collectives=run["collectives"],
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes, "temp_bytes": None,
                "peak_bytes": arg_bytes + run["peak_bytes"]},
        roofline={"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s,
                  "dominant": dominant, "flops_per_s": peak, "dtype": "bf16" if bf16 else "fp32",
                  "rates": RATES, "measured": False},
        seconds=run["seconds"])


# ------------------------------------------------------------ one record
def mesh_tag(grid, optimized: bool = False, comm: str | None = None, payload: str | None = None) -> str:
    """``16x16`` / ``2x16x16`` (the grid's sizes) with ``+opt``,
    ``+broadcast``, ``+bf16``, ``+int8``: the reference's record key."""
    return ("x".join(str(n) for n in grid.sizes) + ("+opt" if optimized else "") + (f"+{comm}" if comm else "")
            + (f"+{payload}" if payload else ""))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, verbose: bool = True, optimized: bool = False,
             comm: str | None = None, payload: str | None = None, grid=None) -> dict:
    """One cell's record for rank 0 of ``grid`` (by default the production
    grid, `repro_torch.launch.mesh.production_grid`): ``OK`` with the
    step's counts, ``SKIP`` for a shape with a ``skip_reason``, or ``FAIL``
    with the exception's message. Runs
    inside a fake group of the grid's size, so the caller must not be in a
    process group."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import fake_group, production_grid
    from repro_torch.launch.steps import build_cell

    grid = grid or production_grid(multi_pod)
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_tag(grid, optimized, comm, payload),
                 "ts": time.time()}
    try:
        spec = get_arch(arch_id)
        shape = spec.shapes[shape_name]
        if shape.skip_reason:
            rec.update(status="SKIP", reason=shape.skip_reason)
            return rec
        t0 = time.perf_counter()
        with fake_group(grid):
            cell = build_cell(spec, shape, grid, optimized=optimized, comm=comm, payload=payload)
            with _obs_trace.span("dryrun.lower", args={"arch": arch_id, "shape": shape_name}):
                bound = cell.bind()
                terms = step_terms(bound.fn, bound.abstract_inputs())
        t_lower = time.perf_counter() - t0
        if _obs_metrics.enabled():
            _obs_metrics.observe("dryrun.lower_s", t_lower)
            _obs_metrics.inc("dryrun.cells")
        flops, bytes_hbm, coll = terms["flops"], terms["hbm_bytes"], terms["collective_bytes"]
        dominant = terms["roofline"]["dominant"]
        rec.update(
            status="OK",
            kind=cell.kind,
            n_chips=grid.size,
            lower_s=round(t_lower, 2),
            compile_s=None,
            compile_note="nothing is compiled: one eager trace on meta tensors in a fake process group",
            flops_per_device=flops,
            hbm_bytes_per_device=bytes_hbm,
            hbm_bytes_note="the bytes of every operation's inputs and outputs (the unfused program)",
            collective_bytes_per_device=coll,
            collectives_per_device=terms["collectives"],
            memory=terms["memory"],
            roofline=terms["roofline"],
            model_flops=cell.model_flops,
            useful_flops_ratio=(cell.model_flops / (flops * grid.size)) if flops else None,
            note=cell.note,
            exchange=exchange_accounting(cell, shape),
        )
        if verbose:
            print(f"[{rec['mesh']}] {arch_id} × {shape_name}: OK (trace {t_lower:.1f}s, dominant={dominant})")
            print(f"    memory: {rec['memory']}")
            print(f"    counts: flops/dev={flops:.4g} bytes/dev={bytes_hbm:.4g} coll_bytes/dev={coll['total']:.4g}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}", trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{rec['mesh']}] {arch_id} × {shape_name}: FAIL {type(e).__name__}: {e}")
    return rec


# ------------------------------------------------ meta against a real step
@dataclasses.dataclass(frozen=True)
class StepJob:
    """One GNN cell to run for one train step, on a real group and on the
    meta device: its arch and shape, the grid (axes, sizes), and
    `build_cell`'s arguments; ``quant_off`` turns coin_gcn's fake quant
    off (its per-rank calibration makes the sharded cell another function
    than the unsharded one); ``dtype`` is the parameters' and the batch's
    float dtype (``"float64"``: PNA's gradient, ill-conditioned in fp32, is
    held in float64); ``keep`` returns the loss, the updated parameters
    and the step's gradient."""

    arch: str
    shape: str
    axes: tuple = ("data", "model")
    sizes: tuple = (1, 1)
    comm: str | None = None
    payload: str | None = None
    optimized: bool = False
    quant_off: bool = False
    dtype: str = "float32"
    seed: int = 0
    keep: bool = True

    def grid(self):
        from repro_torch.launch.mesh import Grid

        return Grid(tuple(self.axes), tuple(self.sizes))

    def cell(self, grid=None):
        from repro_torch.configs.registry import get_arch
        from repro_torch.launch.steps import build_cell

        spec = get_arch(self.arch)
        if self.quant_off:
            make = spec.make_config
            spec = dataclasses.replace(spec, make_config=lambda shape=None: dataclasses.replace(
                make(shape), quant=dataclasses.replace(make(shape).quant, enabled=False)))
        return build_cell(spec, spec.shapes[self.shape], grid or self.grid(), dtype=getattr(torch, self.dtype),
                          optimized=self.optimized, comm=self.comm, payload=self.payload)

    def tag(self) -> str:
        return (f"{self.arch}/{self.shape}/{'x'.join(map(str, self.sizes))}/{self.comm or 'halo'}"
                f"/{self.payload or 'fp32'}" + ("/opt" if self.optimized else "")
                + ("/quant_off" if self.quant_off else "") + ("" if self.dtype == "float32" else f"/{self.dtype}"))


ADAM_B1 = 0.9      # the cells' AdamW b1 (repro_torch.train.optimizer.adamw's default)


def _step_record(run: dict, keep: bool, trees: bool = True) -> dict:
    rec = {k: run[k] for k in ("flops", "collectives", "op_bytes", "seconds")}
    if keep:
        params, opt_state, loss = run["out"]
        rec["loss"] = float(loss)
    if keep and trees:
        rec["params"] = tree_map(lambda t: t.detach().float().cpu().numpy(), params)
        # After one AdamW step the first moment is (1 − b1)·g: the step's gradient.
        rec["grads"] = tree_map(lambda t: t.detach().float().cpu().numpy() / (1 - ADAM_B1), opt_state["m"])
    return rec


def real_steps(rank: int, k: int, device, jobs: list) -> dict:
    """The rank body (`repro_torch.launch.mesh.run_group`): each job's cell
    bound to this rank, one train step on the rank's real inputs under
    `count_step`; per job its counts and, with ``keep``, its loss (and on
    rank 0 the updated parameters and the gradient, numpy); ``launches``:
    K1–K4 over all of them."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = {}
    for job in jobs:
        cell = job.cell().bind()
        args = cell.make_inputs(job.seed, device)
        out[job.tag()] = _step_record(count_step(cell.fn, args), job.keep, trees=rank == 0)
        del args, cell
    out["launches"] = launch_counts()
    return out


def meta_steps(jobs: list, rank: int = 0) -> dict:
    """The same jobs' counts for rank ``rank`` on the meta device, each in
    a fake group of its grid's size (the caller must be in no group)."""
    from repro_torch.launch.mesh import fake_group

    out = {}
    for job in jobs:
        grid = job.grid()
        with fake_group(grid, rank):
            cell = job.cell(grid).bind()
            out[job.tag()] = _step_record(count_step(cell.fn, cell.abstract_inputs()), False)
    return out


def load_results(path: str = RESULTS_PATH) -> list[dict]:
    """Load a results file in either schema: the v1 bare list or the v2
    ``{"schema": 2, "records": [...]}`` wrapper. Missing file → []."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    if isinstance(data, dict):
        return list(data.get("records", []))
    return list(data)


def _save(path: str, records: list[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schema": RESULTS_SCHEMA, "records": records}, f, indent=1, default=str)


def main(argv=None) -> int:
    from repro_torch.configs.registry import ALL_ARCHS, get_arch
    from repro_torch.launch.mesh import production_grid

    ap = argparse.ArgumentParser(description="The port's dry run: one rank of each cell, traced on meta tensors.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--optimized", action="store_true", help="apply the reference's §Perf findings")
    ap.add_argument("--comm", choices=["default", "halo", "broadcast"], default="default",
                    help="full-graph GNN schedule: 'halo' is the default (same records, no tag suffix); "
                         "'broadcast' (Fig. 5c) records under a '+broadcast' mesh tag")
    ap.add_argument("--payload", choices=["fp32", "bf16", "int8"], default="fp32",
                    help="halo wire format: 'fp32' is the default (no tag suffix); 'bf16'/'int8' record "
                         "under a '+bf16'/'+int8' mesh tag. Halo GNN cells only.")
    ap.add_argument("--autotune-config", default=None,
                    help="JSON written by repro_torch.launch.autotune --out: its payload, backend and pods "
                         "override --payload / --optimized / --mesh")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.autotune_config:
        with open(args.autotune_config) as f:
            tuned = json.load(f)["config"]
        args.payload = tuned.get("payload") or "fp32"
        args.optimized = tuned.get("backend") == "bsr"
        args.mesh = "multi" if tuned.get("pods", 1) > 1 else "single"
    comm = "broadcast" if args.comm == "broadcast" else None
    payload = None if args.payload == "fp32" else args.payload

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    records = load_results(args.out)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records if r.get("status") in ("OK", "SKIP")}
    failures = 0
    with obs_session(args):
        for arch_id in archs:
            shapes = [args.shape] if args.shape else list(get_arch(arch_id).shapes)
            for shape_name in shapes:
                for multi in meshes:
                    key = (arch_id, shape_name, mesh_tag(production_grid(multi), args.optimized, comm, payload))
                    if key in done and not args.force:
                        print(f"[cached] {key}")
                        continue
                    rec = run_cell(arch_id, shape_name, multi, optimized=args.optimized, comm=comm, payload=payload)
                    records = [r for r in records if (r["arch"], r["shape"], r["mesh"]) != key]
                    records.append(rec)
                    _save(args.out, records)
                    if rec["status"] == "FAIL":
                        failures += 1
    print(f"dry-run sweep complete; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
