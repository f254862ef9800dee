#!/usr/bin/env python3
"""Host time of the port's public kernel wrappers (`repro_torch.kernels.ops`)
and of DeepFM's serving forward on one CUDA card.

    python3 tools/ops_bench.py [--src DIR] [--calls 200] [--reps 7] [--requests 200]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be timed in one run on
one card, in turns (parent, change, change, parent). Prints the card's name
and power limit, then one JSON line:

- ``wrappers``: host microseconds a call of `ops.fm_interaction` at DeepFM's
  serve_p99 (512 × 39 × 10), `ops.bsr_spmm` on a one-block-row table
  (128 × 64; forward alone, and forward with the gradient of Z), and
  `ops.flash_attention` at 8 heads × 256 × 64 fp32, launched back to back
  with one synchronisation after ``--calls`` calls, so the host's cost is
  what is timed; the median of ``--reps`` repetitions;
- ``deepfm_serve``: DeepFM FULL's forward at serve_p99 (batch 512) under
  ``inference_mode``, each request synchronised, host clock: p50 and p90
  over ``--requests`` requests after three warm-ups.

Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def per_call_us(fn, calls: int, reps: int) -> float:
    def once() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    fn()                                                    # warm-up (and the kernel's build)
    return statistics.median(once() for _ in range(reps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ops_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.configs.deepfm import FULL
    from repro_torch.graph.structure import blocked_adjacency
    from repro_torch.kernels import ops
    from repro_torch.models.deepfm import deepfm_forward, deepfm_init

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    r = np.random.default_rng(0)
    emb = torch.from_numpy(r.standard_normal((512, 39, 10)).astype(np.float32)).to(device)
    ei = r.integers(0, 128, size=(2, 1024)).astype(np.int32)
    vals, cols, lens = blocked_adjacency(128, ei, r.standard_normal(1024).astype(np.float32)).arrays(device=device)
    z = torch.from_numpy(r.standard_normal((128, 64)).astype(np.float32)).to(device).requires_grad_(True)
    q, k, v = (torch.from_numpy(r.standard_normal((8, 256, 64)).astype(np.float32)).to(device) for _ in range(3))

    def bsr_grad():
        return torch.autograd.grad(ops.bsr_spmm(vals, cols, z, lens=lens).sum(), z)

    wrappers = {}
    with torch.inference_mode():
        wrappers["fm_interaction"] = per_call_us(lambda: ops.fm_interaction(emb), args.calls, args.reps)
        wrappers["bsr_spmm"] = per_call_us(lambda: ops.bsr_spmm(vals, cols, z, lens=lens), args.calls, args.reps)
        wrappers["flash_attention"] = per_call_us(lambda: ops.flash_attention(q, k, v), args.calls, args.reps)
    wrappers["bsr_spmm_with_grad"] = per_call_us(bsr_grad, args.calls, args.reps)

    params = deepfm_init(torch.Generator(device=device).manual_seed(0), FULL, device=device)
    ids = torch.from_numpy(r.integers(0, FULL.rows_per_field, (512, FULL.n_fields))).to(device, torch.int64)
    request_ms = []
    with torch.inference_mode():
        for _ in range(3):
            deepfm_forward(params, ids, FULL)
        torch.cuda.synchronize()
        for _ in range(args.requests):
            t0 = time.perf_counter()
            deepfm_forward(params, ids, FULL)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
    q10 = statistics.quantiles(request_ms, n=10)
    print(json.dumps(dict(src=args.src, card=card, wrappers_us=wrappers, calls=args.calls, reps=args.reps,
                          deepfm_serve=dict(p50_ms=statistics.median(request_ms), p90_ms=q10[-1],
                                            requests=args.requests, batch=512))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
