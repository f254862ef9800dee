"""Readings that set a cell's limits: the program on many seeds, the control
(the reference with TF32 products in the program's place) and, for a
training cell, a fault planted in the program, all in one process.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]
                               [--fault-seeds 7,8,9] [--seconds 1.5] [--out FILE]

The configuration's set-up is made once; each seed draws its weights and
requests, runs a short window at the cell's own load and reads the numbers
the cell compares (`bench/limits/<workload>.json` holds the limits set from
them). Prints one JSON line per reading. Needs the card, as a run does.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchlib.paths import setup_paths  # noqa: E402

setup_paths()

import torch  # noqa: E402

from benchlib import spec  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def half_batch(session) -> None:
    """The fault: half of the training nodes left out of the loss, the mean
    taken over the rest."""
    mask = session.program.mask
    kept = mask.nonzero()[:, 0]
    mask[kept[::2]] = 0.0


def reading(session, seed: int, seconds: float, kind: str) -> dict:
    t0 = time.perf_counter()
    run = session.start(seed)
    window = run.window(seconds)
    run.finish()
    got = run.readings(control=kind == "control")
    if session.loop == "infer":
        session.reset()
    return dict(kind=kind, seed=seed, **got, completed=window.completed,
                ms=window.seconds / max(window.completed, 1) * 1e3, seconds=time.perf_counter() - t0)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=1.5)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = importlib.import_module(f"families.{cell.config['family']}.cell")
    session = family.Session(cell.config, cell.traffic, torch.device("cuda", 0), cell.limits)
    out = open(args.out, "a") if args.out else None
    plan = [(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
    for seed, kind in plan:
        line = json.dumps(dict(workload=cell.name, **reading(session, seed, args.seconds, kind)))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if args.fault_seeds:
        half_batch(session)
        for seed in args.fault_seeds:
            line = json.dumps(dict(workload=cell.name, **reading(session, seed, args.seconds, "half_batch")))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    print(json.dumps(dict(workload=cell.name, total_s=time.perf_counter() - T0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
