#!/usr/bin/env python3
"""Time K4 (the LM's flash attention) on one CUDA card at gemma3-12b's
attention shape for one sequence: 16 query heads over 8 key/value heads,
d = 240, fp32 and bf16, the global and the local (1,024) window.

    python3 tools/k4_bench.py [--src DIR] [--seq 4096] [--reps 20] [--sdpa]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be timed in one run on
one card, in turns. Prints the card's name and power limit, then one JSON
line per case: K4's CUDA-event median over ``--reps`` launches after two
warm-ups, the bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s in
fp32 and 989 TFLOP/s in bf16, whichever is larger) and, with ``--sdpa``,
one `scaled_dot_product_attention` call on the same inputs (k and v
expanded per group; the port never calls it). Needs a card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S, FP32_FLOP_PER_S, BF16_FLOP_PER_S = 3.35e12, 67e12, 989e12
H, HK, D, GLOBAL, LOCAL = 16, 8, 240, 2 ** 30, 1024


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(S: int, window: int, elem: int) -> float:
    q = np.arange(S, dtype=np.int64)
    pairs = int((q + 1 - np.maximum(q - window + 1, 0)).sum())
    t_bytes = elem * S * D * (2 * H + 2 * HK) / HBM_BYTES_PER_S
    t_flop = 4.0 * D * H * pairs / (FP32_FLOP_PER_S if elem == 4 else BF16_FLOP_PER_S)
    return max(t_bytes, t_flop) * 1e3


def sdpa(q, k, v, window: int):
    import torch.nn.functional as F

    S = q.shape[1]
    qh, kh, vh = q[None], k.repeat_interleave(H // HK, 0)[None], v.repeat_interleave(H // HK, 0)[None]
    if window >= S:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import flash_attention as k4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((n, args.seq, D), generator=gen, device="cuda") for n in (H, HK, HK))
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            for tag, window in (("global", GLOBAL), ("local", LOCAL)):
                row = dict(tag=args.tag, src=args.src, dtype=str(dtype).replace("torch.", ""), window=window,
                           S=args.seq, ms=cuda_ms(lambda: k4.flash_attention(qd, kd, vd, window=window), args.reps),
                           bound_ms=bound_ms(args.seq, min(window, args.seq), 4 if dtype == torch.float32 else 2))
                if args.sdpa:
                    row["sdpa_ms"] = cuda_ms(sdpa(qd, kd, vd, window), max(args.reps // 4, 3))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
