#!/usr/bin/env python3
"""Time the ragged kernels (K1 `bsr_spmm`, K2's two aggregations) on one CUDA
card at the shapes of the GCN's main paths on Nell (Table I: 5,414 → 16 →
210, `make_dataset("nell", seed=0)` after `locality_block_order`):

- unsharded: K1 over Ã·h1 (F = 16), K2's feature-first aggregation (Z
  16 wide) and aggregation-first layer (16 → 210), fp32;
- rank 0 of the 4-rank halo plan (`partition_graph(k=4, bfs, refine)`, its
  [local ‖ halo] table): K1 fp32, with a bf16 table and all bf16;
  ``k2_af_layer`` fp32, with a bf16 table and all bf16; K2's feature-first
  aggregation with a bf16 output and all bf16.

    python3 tools/ragged_bench.py [--src DIR] [--reps 20] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed and
builds the tables (by default this checkout's), so that two checkouts can
be timed on one card in one call, in turns (parent, change, change,
parent). Prints the card's name and power limit, then one JSON line per
case: the kernel's CUDA-event median over ``--reps`` launches after two
warm-ups, and the bound (each valid tile, table row and output element
once at 3.35 TB/s, or the FMAs at 67 TFLOP/s fp32 (989 TFLOP/s where
every operand is bf16), whichever is larger).
Operands are random from a seed. Needs a card; imports nothing of JAX.
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
SEED, HIDDEN, LABELS = 0, 16, 210


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


def bound_ms(nnz: int, R: int, src_rows: int, f_src: int, f_out: int, src_bytes: int, out_bytes: int,
             w_flop: int = 0, val_bytes: int = 4) -> float:
    """Valid tiles, the index tables, the source rows and the output once
    over the HBM rate, or the products over the fp32 rate (the bf16 rate
    when the tiles are bf16, as every operand then is)."""
    n_bytes = (val_bytes * nnz * 128 * 128 + 4.0 * (R + nnz) + src_bytes * src_rows * f_src
               + out_bytes * R * 128 * f_out)
    n_flop = 2.0 * nnz * 128 * 128 * f_src + w_flop
    rate = FP32_FLOP_PER_S if val_bytes == 4 else BF16_FLOP_PER_S
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / rate) * 1e3


def nell_tables(device):
    """Nell's blocked adjacency on the card, and rank 0's [local ‖ halo]
    table of the 4-rank halo plan."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.halo import get_halo_plan, plan_blocked_rank
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.structure import blocked_adjacency, locality_block_order, permute_edge_index
    from repro_torch.launch.distributed_gcn import table_widths

    _, g = make_dataset("nell", seed=SEED)
    gs = g.symmetrized().with_self_loops()
    weights = gs.sym_normalized_weights()
    perm = locality_block_order(g.n_nodes, gs.edge_index)
    ba = blocked_adjacency(g.n_nodes, permute_edge_index(perm, gs.edge_index), weights)
    nell = ba.arrays(device=device)
    part = partition_graph(g.n_nodes, gs.edge_index, 4, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, gs.edge_index, weights)
    rb = plan_blocked_rank(plan, 0, max_nnzb=table_widths(plan)["combined"])
    return (nell, ba.n_col_padded, ba.nnz_blocks), (rb.arrays(device=device), rb.n_col_padded, rb.nnz_blocks)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ragged_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")
    ((vals, cols, lens), rows, nnz), ((rv, rc, rl), rrows, rnnz) = nell_tables(device)
    gen = torch.Generator().manual_seed(SEED + 1)
    h1 = torch.randn((rows, HIDDEN), generator=gen).to(device)
    z = torch.randn((rows, HIDDEN), generator=gen).to(device)
    b1 = torch.randn(HIDDEN, generator=gen).to(device)
    w2 = (torch.randn((HIDDEN, LABELS), generator=gen) * (2.0 / (HIDDEN + LABELS)) ** 0.5).to(device)
    b2 = torch.randn(LABELS, generator=gen).to(device)
    table = torch.randn((rrows, HIDDEN), generator=gen).to(device)
    bf16 = torch.bfloat16
    t16, rv16, w16 = table.to(bf16), rv.to(bf16), w2.to(bf16)
    R, rR = cols.shape[0], rc.shape[0]
    wf = 2 * 128 * HIDDEN * LABELS
    cases = [
        ("k1_bsr_spmm", "nell", lambda: k1.bsr_spmm(vals, cols, lens, h1), bound_ms(nnz, R, rows, HIDDEN, HIDDEN, 4, 4)),
        ("k2_ff_aggregate", "nell", lambda: fg.ff_aggregate(vals, cols, lens, z, b1, True),
         bound_ms(nnz, R, rows, HIDDEN, HIDDEN, 4, 4)),
        ("k2_af_layer", "nell", lambda: fg.af_layer(vals, cols, lens, h1, w2, b2, True),
         bound_ms(nnz, R, rows, HIDDEN, LABELS, 4, 4, R * wf)),
        ("k1_bsr_spmm", "rank 0", lambda: k1.bsr_spmm(rv, rc, rl, table),
         bound_ms(rnnz, rR, rrows, HIDDEN, HIDDEN, 4, 4)),
        ("k1_bsr_spmm_bf16", "rank 0", lambda: k1.bsr_spmm(rv, rc, rl, t16),
         bound_ms(rnnz, rR, rrows, HIDDEN, HIDDEN, 2, 2)),
        ("k2_af_layer", "rank 0", lambda: fg.af_layer(rv, rc, rl, table, w2, b2, True),
         bound_ms(rnnz, rR, rrows, HIDDEN, LABELS, 4, 4, rR * wf)),
        ("k2_af_layer_bf16", "rank 0", lambda: fg.af_layer(rv, rc, rl, t16, w2, b2, True),
         bound_ms(rnnz, rR, rrows, HIDDEN, LABELS, 2, 2, rR * wf)),
        ("k1_bsr_spmm_bf16_all", "rank 0", lambda: k1.bsr_spmm(rv16, rc, rl, t16),
         bound_ms(rnnz, rR, rrows, HIDDEN, HIDDEN, 2, 2, val_bytes=2)),
        ("k2_af_layer_bf16_all", "rank 0", lambda: fg.af_layer(rv16, rc, rl, t16, w16, b2, True),
         bound_ms(rnnz, rR, rrows, HIDDEN, LABELS, 2, 2, rR * wf, val_bytes=2)),
        ("k2_ff_aggregate_bf16", "rank 0", lambda: fg.ff_aggregate(rv, rc, rl, table, b1, True, bf16),
         bound_ms(rnnz, rR, rrows, HIDDEN, HIDDEN, 4, 2)),
        ("k2_ff_aggregate_bf16_all", "rank 0", lambda: fg.ff_aggregate(rv16, rc, rl, t16, b1, True, bf16),
         bound_ms(rnnz, rR, rrows, HIDDEN, HIDDEN, 2, 2, val_bytes=2)),
    ]
    with torch.inference_mode():
        for name, shape, fn, bound in cases:
            row = dict(tag=args.tag, src=args.src, kernel=name, shape=shape, ms=cuda_ms(fn, args.reps), bound_ms=bound)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
