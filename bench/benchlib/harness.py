"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the reference, and the result line.

``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``

With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the first `TRACE_SECONDS` of the window run under
`torch.profiler` and the result carries its per-layer metrics, the device's
busy and window seconds and a breakdown. Both compare what the timed path
produced with the plain reference once the window has closed and the
program's state is freed. The last lines on standard error, and the
result's last key, give each number compared beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time

import torch

from benchlib import spec as specmod
from benchlib.traceread import TraceView

TRACE_SECONDS = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    cell: specmod.Cell
    setup_s: float
    window: object = None
    trace: TraceView | None = None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def read_metrics(entries: list[dict], ctx: Context) -> dict:
    out = {}
    for m in entries:
        value = specmod.reader(m["name"], ctx.cell.bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(limits: dict, readings: dict) -> tuple[bool, dict]:
    checks = {}
    for name, limit in limits.items():
        value = float(readings.get(name, float("inf")))
        checks[name] = {"value": value, "limit": float(limit)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(cell: specmod.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float) -> dict:
    """Everything but the look for a card and the printing: the result."""
    family = importlib.import_module(f"families.{cell.config['family']}.cell")
    cuda = device.type == "cuda"
    t_session = time.perf_counter()
    session = family.Session(cell.config, cell.traffic, device, cell.limits)
    t_start = time.perf_counter()
    run = session.start(seed)
    ctx = Context(cell=cell, setup_s=time.perf_counter() - t0)
    split = dict(before_session_s=t_session - t0, **session.setup_split, warmup_s=ctx.setup_s - (t_start - t0))
    print(f"setup {json.dumps(split)}", file=sys.stderr)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            ctx.window = run.window(min(seconds, TRACE_SECONDS), trace=True)
    else:
        ctx.window = run.window(seconds)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    facts = run.facts()
    if prof is not None:
        ctx.trace = TraceView(prof.events(), family.SPAN[run.unit], run.unit, facts)
        del prof
    run.finish()
    session.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = judge(cell.limits, run.readings())
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    result = {
        "correct": correct,
        "attempted": ctx.window.completed,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
            "card": power_limit() if cuda else None,
        },
    }
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = specmod.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); {have} available", file=sys.stderr)
        return 3
    tf32 = bool(cell.config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
