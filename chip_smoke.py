#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root (it imports ``src/repro_torch`` beside this
file). It needs one CUDA card and exits non-zero without one, or without
the package, before printing any result. It imports nothing of JAX and
nothing of the JAX package `repro`.

Four paths of the paper's GCN (``coin_gcn``) run at the widths of Nell
(Table I: 65,755 nodes, 5,414 → 16 → 210, 4-bit fake quant) with the
blocked (bsr) backend: full-graph inference, full-graph training, and
sharded (halo) inference and training over 4 ranks. The forward of each unsharded layer
runs the hand-written CUDA kernels of `repro_torch.kernels.fused_gcn` (K2):
layer 1 feature-first (``k2_ff_transform`` then ``k2_ff_aggregate``),
layer 2 aggregation-first (``k2_af_layer``). The backward of layer 2
recomputes Ã·h1 through `repro_torch.kernels.bsr_spmm` (K1,
``k1_bsr_spmm``). The sharded forward runs K1 on each rank's
``[local ‖ halo]`` table for layer 1 and K2's aggregation-first kernel for
layer 2 — under the bf16 wire its bf16-operand instantiation
(``k2_af_layer_bf16``: fp32 tiles, bf16 table, fp32 W). Sharded training
runs the exchange's backward (a reduce-scatter through the group) and,
in layer 2's backward, K1 on the same table — under the bf16 wire its
bf16 instantiation (``k1_bsr_spmm_bf16``, the running sum rounded to
bf16 per tile as the TPU kernel does). Weights are random, from a seed.

Phases, one JSON line each; any failed check ends the run with exit code 1:

  build    compile the kernels from src/repro_torch/kernels/csrc (nvcc)
  data     make_dataset("nell") → symmetrize, self-loops, sym-norm weights →
           locality_block_order → blocked_adjacency → the card
  plan     partition_graph(k=4, bfs, refine) → get_halo_plan on the same
           graph; the plan's sizes and both table forms' shapes, printed
           before any tile of them exists
  kernels  each kernel against its plain PyTorch version on the card at
           Nell's layer shapes: relu on and off, NaN-poisoned padding tiles,
           an empty block-row, the 91-row tail block; K1 also on a
           rectangular Z with extra source block-rows; at rank 0's halo
           shapes K1 and fp32 ``k2_af_layer`` over its [local ‖ halo]
           table, K1 over its interior and boundary tables (the split
           pair), and K2's and K1's bf16 instantiations (K1's: within one
           bf16 step of the largest value, ≥ 99 % bit-equal, also with
           NaN-poisoned padding and an emptied block-row)
  main     inference: gcn_forward(backend="bsr") three times under
           inference_mode with the launch counts zeroed just before and read
           just after; the quant-off logits against the segment (index_add_)
           path on the card, the quant-on argmax agreement, the test accuracy
  train    training: one quant-off gcn_loss gradient with bsr and with
           segment; a Trainer taking five AdamW steps, quant on, with the
           launch counts zeroed just before and read just after (one launch
           of each kernel per step); five quant-off steps with bsr and with
           segment, loss against loss
  times    CUDA-event medians: each kernel, its plain version, the library
           call where one computes the same function, the whole forward, the
           backward's torch parts; host-clock medians of the training step;
           peak device memory
  profile  torch.profiler over three training steps (bsr, quant on): device
           time by kernel and the device's idle share of the window
  halo     the parent frees the card, then 4 ranks on cuda:0 in one gloo
           group (the wire goes through the host; NCCL takes one rank per
           card) each run gcn_forward on their block: (a) combined table,
           fp32 wire; (b) bf16 wire; (c) split tables; (d) int8 wire;
           (e) quant on, bf16 wire, bsr and segment. Gathered and restored
           logits against the unsharded bsr forward ((e): bsr against
           segment, argmax agreement with ties), launches and wire rows
           per rank, forward and exchange times per rank after a barrier
           (4 ranks share one card: not a multi-card time), peak memory
  halo_train  in the same group, after the forwards: five AdamW steps
           (lr 1e-3) of every rank's Trainer on the sharded loss
           (`halo_loss`) in each of (t1) combined table, fp32 wire; (t2)
           bf16 wire; (t3) split tables; (t4) quant on, bf16 wire, bsr and
           segment; the training mask is the train phase's node set. The
           first gradients and the losses of (t1), (t3) against the train
           phase's unsharded bsr ones (1e-4), (t2)'s gradients at the bf16
           tolerance (5e-2) against the unsharded ones with the logits
           rounded to bf16 (the fused bf16 layer's output, whose rounding
           and its cotangent's move the bias gradient by up to ~6 % of its
           largest entry), (t4) bsr against segment with its logits rounded
           alike; launches per step
           counted from zero just before the steps and read just after;
           wire rows per step (forward and backward exchanges); step ms,
           one exchange's backward ms and peak memory per rank

then the card's name and power limit (nvidia-smi), the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``. A kernel's
``launches`` there is its count over the four main-path runs (inference
forwards, training steps, the halo forwards and the halo training steps
of all ranks), each counted with the counts zeroed just before and read
just after.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

DATASET = "nell"
SEED = 0
PASSES = 3                     # main-path forwards
TRAIN_STEPS = 5                # Trainer steps of the train phase
KERNEL_RTOL = 1e-4             # kernel vs plain: max |diff| ≤ KERNEL_RTOL · max |plain|
GRAD_RTOL = 1e-4               # bsr vs segment gradients, same rule per parameter
LOSS_RTOL = 1e-4               # bsr vs segment quant-off losses, relative, every step
LOGIT_RTOL = 1e-4              # quant-off logits, bsr kernels vs segment path, same rule
ARGMAX_AGREEMENT = 0.999       # quant on: a 4-bit bucket may flip on a rounding difference;
                               # ties within LOGIT_RTOL count as agreement
BF16_KERNEL_RTOL = 1e-2        # a bf16 output: max |diff| ≤ 1e-2 · max |plain|
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh"
REPLACES = {
    "k2_ff_transform": "src/repro/kernels/fused_gcn.py:45",
    "k2_ff_aggregate": "src/repro/kernels/fused_gcn.py:45",
    "k2_af_layer": "src/repro/kernels/fused_gcn.py:70",
    "k1_bsr_spmm": "src/repro/kernels/bsr_spmm.py:87",
}
REPLACES.update({f"{k}{sfx}": REPLACES[k] for sfx in ("_bf16", "_bf16_all") for k in list(REPLACES)})
K2 = ("k2_ff_transform", "k2_ff_aggregate", "k2_af_layer")
FP32_KERNELS = K2 + ("k1_bsr_spmm",)
# (vals, x, w) dtypes of K2's bf16 instantiations, by launch-name suffix.
BF16_COMBOS = {"_bf16": (torch.float32, torch.bfloat16, torch.float32),
               "_bf16_all": (torch.bfloat16, torch.bfloat16, torch.bfloat16)}
# (vals, Z) dtypes of K1's bf16 instantiations, by launch-name suffix.
K1_BF16_COMBOS = {"_bf16": (torch.float32, torch.bfloat16), "_bf16_all": (torch.bfloat16, torch.bfloat16)}
K1_BF16_STEP = 2.0 ** -7       # K1 bf16 vs plain: max |diff| ≤ one bf16 step of max |plain| ...
K1_BF16_BIT_EQUAL = 0.99       # ... and at least 99 % of the elements bit-equal (the sums' order inside
                               # a tile may flip a per-tile rounding)

HALO_K = 4
HALO_REPS = 5                  # timed forwards / exchanges per variant and rank
HALO_TIMEOUT_S = 480.0
HALO_LOGIT_RTOL = 1e-4         # (a), (c): fp32 wire vs the unsharded bsr forward, · max |logit|
HALO_BF16_RTOL = 1e-2          # (b): the reference's bf16 bound (tests/test_overlap_halo.py:241-242), · max |logit|
HALO_INT8_ABS = 5e-2           # (d): the reference's int8 bounds (tests/test_overlap_halo.py:243-250):
HALO_INT8_REL_L2 = 1e-2        #      5e-2 max-abs and 1e-2 relative L2
HALO_TRAIN_STEPS = 5           # AdamW steps (lr 1e-3) per halo training variant
HALO_TRAIN_LR = 1e-3
HALO_GRAD_RTOL = 1e-4          # (t1), (t3): first gradients vs the unsharded bsr ones, · max per parameter
HALO_LOSS_RTOL = 1e-4          # (t1), (t3): five-step losses vs the unsharded bsr ones, relative
HALO_BF16_GRAD_RTOL = 5e-2     # (t2) vs unsharded, (t4) bsr vs segment: the reference suite's bf16 tolerance
HALO_QUANT_LOSS_RTOL = 1e-2    # (t4) bsr vs segment losses, relative (bf16 logits of the fused layer)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, phase: str, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: phase {phase!r} failed: {what}")


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |out − ref|, max |ref|), NaN in ``out`` counting as infinite."""
    diff = (out - ref).abs().nan_to_num(nan=float("inf"))
    return float(diff.max()), float(ref.abs().max())


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
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


def wall_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the host clock, each run ending in
    ``torch.cuda.synchronize()``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: float, n_flop: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """Least time on the card (ms): bytes over the HBM rate or operations
    over the peak rate for their type (fp32 on the CUDA cores unless
    ``flop_per_s`` says otherwise), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def argmax_agreement(out: torch.Tensor, ref: torch.Tensor, tie_rtol: float) -> tuple[float, float, int]:
    """(agreement up to ties, raw argmax equality, nodes with tied tops).

    A node agrees when the class ``out`` picks is a top logit of ``ref``
    within ``tie_rtol · max |ref|``: quantized activations are often all
    zero on a node, and then every logit ties and argmax is decided by
    noise."""
    top = ref.max(-1).values
    picked = ref.gather(1, out.argmax(-1, keepdim=True))[:, 0]
    tie_tol = tie_rtol * float(ref.abs().max())
    agree = float((picked >= top - tie_tol).float().mean())
    raw = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    tied = int(((ref >= top[:, None] - tie_tol).sum(-1) > 1).sum())
    return agree, raw, tied


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_gcn as fg

    t0 = time.perf_counter()
    reports = _build.build(["fused_gcn"])
    lib = fg._lib()          # binds every launcher of LAUNCHES: a missing symbol raises
    seconds = time.perf_counter() - t0
    smem_ok = all(lib.k2_layer_smem_bytes(f) == fg.layer_smem_bytes(f) for f in (7, 16, 50, 210, fg.AF_MAX_F_IN))
    ptxas = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", ok=smem_ok, seconds=seconds, built=sorted(reports), ptxas=ptxas)
    require(smem_ok, "build", "shared-memory formula of the .cuh and the wrapper disagree")


def load_graph(device: torch.device) -> dict:
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.structure import (
        GraphData, blocked_adjacency, locality_block_order, permute_edge_index,
        relocate_rows, restore_rows, to_padded,
    )

    t0 = time.perf_counter()
    spec, g = make_dataset(DATASET, seed=SEED)
    gs = g.symmetrized().with_self_loops()
    weights = gs.sym_normalized_weights()
    perm = locality_block_order(g.n_nodes, gs.edge_index)
    ei = permute_edge_index(perm, gs.edge_index)
    ba = blocked_adjacency(g.n_nodes, ei, weights)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, cols, lens = ba.arrays(device=device)
    pg = to_padded(GraphData(g.n_nodes, ei), weights=weights, device=device)
    x = torch.from_numpy(relocate_rows(perm, g.features)).to(device).float()
    test = relocate_rows(perm, np.arange(g.n_nodes) % 4 == 0)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    emit("data", ok=True, dataset=spec.name, n_nodes=g.n_nodes, n_edges=gs.n_edges,
         n_features=spec.n_features, n_labels=spec.n_labels, block_rows=ba.n_block_rows,
         tile_table_width=ba.max_nnzb, nnz_tiles=ba.nnz_blocks,
         mean_tiles_per_row=ba.nnz_blocks / ba.n_block_rows,
         median_tiles_per_row=float(np.median(ba.row_nnzb)), max_tiles_per_row=int(ba.row_nnzb.max()),
         padded_table_gb=ba.block_vals.nbytes / 1e9, valid_tiles_gb=ba.nnz_blocks * 128 * 128 * 4 / 1e9,
         tail_rows=g.n_nodes % 128, host_build_s=host_s, upload_s=upload_s)
    return dict(spec=spec, n=g.n_nodes, vals=vals, cols=cols, lens=lens, pg=pg, x=x,
                labels=torch.from_numpy(relocate_rows(perm, g.labels)).to(device),
                test=torch.from_numpy(test).to(device),
                host=dict(edge_index=gs.edge_index, weights=weights, features=g.features, perm=perm,
                          labels=g.labels, train_mask=restore_rows(perm, ~test).astype(np.float32)))


def build_plan(data: dict) -> dict:
    """The halo plan of the same graph over HALO_K ranks, and the shapes of
    its per-rank tables, before any tile of them exists."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.halo import get_halo_plan, plan_blocked_shape, plan_split_blocked_shape
    from repro_torch.launch.distributed_gcn import table_widths

    host = data["host"]
    t0 = time.perf_counter()
    part = partition_graph(data["n"], host["edge_index"], HALO_K, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, host["edge_index"], host["weights"])
    host_s = time.perf_counter() - t0
    shape, split = plan_blocked_shape(plan), plan_split_blocked_shape(plan)
    tile = 128 * 128 * 4

    def padded_gb(st):
        return st["n_block_rows"] * st["max_nnzb"] * tile / 1e9

    per_rank = dict(combined=padded_gb(shape), interior=padded_gb(split["interior"]),
                    boundary=padded_gb(split["boundary"]))
    emit("plan", ok=True, k=plan.k, part_sizes=plan.part_sizes.tolist(), n_local=plan.n_local,
         s_max=plan.s_max, e_local=plan.e_local, halo_rows_per_rank=plan.halo_rows_per_device,
         broadcast_rows_per_rank=plan.broadcast_rows_per_device, wire_fraction=plan.wire_fraction(),
         overlap_fraction=plan.overlap_fraction(), neighbor_table_rows=plan.neighbor_table_rows,
         blocked_combined=shape, blocked_split=split, padded_table_gb_per_rank=per_rank,
         padded_tables_gb_all_ranks=plan.k * sum(per_rank.values()),
         valid_tiles_gb_max_rank=dict(combined=shape["nnz_blocks_max_device"] * tile / 1e9,
                                      interior=split["interior"]["nnz_blocks_max_device"] * tile / 1e9,
                                      boundary=split["boundary"]["nnz_blocks_max_device"] * tile / 1e9),
         host_build_s=host_s)
    return dict(plan=plan, widths=table_widths(plan))


def rank_operands(data: dict, halo: dict, ops: dict, generator: torch.Generator) -> dict:
    """Rank 0's combined [local ‖ halo] table and operands at its Nell
    shapes, for K2's bf16 instantiations: layer 1's feature block, layer 2's
    16-wide table (what the bf16 wire hands `k2_af_layer_bf16`)."""
    from repro_torch.dist.halo import plan_blocked_rank

    plan, device = halo["plan"], data["x"].device
    ba = plan_blocked_rank(plan, 0, max_nnzb=halo["widths"]["combined"])
    vals, cols, lens = ba.arrays(device=device)
    rows, hidden = ba.n_col_padded, ops["w1"].shape[1]
    n0 = int(plan.part_sizes[0])            # rank 0's nodes are the first n0 of the plan's order
    x0 = torch.zeros((ba.n_padded, data["spec"].n_features), device=device)
    x0[:n0] = torch.from_numpy(data["host"]["features"][plan.perm[:n0]]).to(device).float()
    return dict(vals=vals, cols=cols, lens=lens, x=x0, nnz=ba.nnz_blocks,
                table=(torch.randn((rows, hidden), generator=generator)).to(device),
                z=(torch.randn((rows, hidden), generator=generator)).to(device))


def layer_operands(data: dict, generator: torch.Generator) -> dict:
    """Random operands at the shapes of the two Nell layers, with nonzero
    biases and signed inputs so that bias and ReLU both matter."""
    spec, device = data["spec"], data["x"].device
    hidden, f_in, f_out = spec.hidden, spec.n_features, spec.n_labels
    rows = data["cols"].shape[0] * 128

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    x = torch.zeros((rows, f_in), device=device)
    x[: data["n"]] = data["x"]
    return dict(
        x=x, w1=randn(f_in, hidden, scale=(2.0 / (f_in + hidden)) ** 0.5), b1=randn(hidden),
        h1=randn(rows, hidden), w2=randn(hidden, f_out, scale=(2.0 / (hidden + f_out)) ** 0.5),
        b2=randn(f_out),
    )


def check_kernels(data: dict, ops: dict, rank: dict, halo: dict) -> dict:
    """Each kernel against its plain version; returns the worst error per
    kernel. The halo path's shapes are rank 0's (``rank``, ``halo``)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    h1 = ops["h1"]
    worst = {name: 0.0 for name in fg.LAUNCHES}
    cases = []

    def hold(kernel, case, out, ref, rtol=KERNEL_RTOL):
        err, scale = max_err(out.float(), ref.float())
        ok = bool(err <= rtol * scale and out.dtype == ref.dtype)
        cases.append(dict(kernel=kernel, case=case, max_abs_err=err, max_abs_ref=scale, rtol=rtol,
                          dtype=str(out.dtype).removeprefix("torch."), ok=ok))
        worst[kernel] = max(worst[kernel], err)
        return ok

    with torch.inference_mode():
        z = fg.ff_transform(ops["x"], ops["w1"])
        hold("k2_ff_transform", "nell layer 1", z, fg.ff_transform_plain(ops["x"], ops["w1"]))
        for relu in (True, False):
            hold("k2_ff_aggregate", f"relu={relu}", fg.ff_aggregate(vals, cols, lens, z, ops["b1"], relu),
                 fg.ff_aggregate_plain(vals, cols, lens, z, ops["b1"], relu))
            hold("k2_af_layer", f"relu={relu}",
                 fg.af_layer(vals, cols, lens, ops["h1"], ops["w2"], ops["b2"], relu),
                 fg.af_layer_plain(vals, cols, lens, ops["h1"], ops["w2"], ops["b2"], relu))
        hold("k1_bsr_spmm", "nell recompute Ã·h1 (F=16)", k1.bsr_spmm(vals, cols, lens, h1),
             k1.bsr_spmm_plain(vals, cols, lens, h1))
        # Rectangular Z: twice the block-rows of the output, every other
        # tile pointing into the second half, which holds other values.
        R, T = cols.shape
        cols_rect = (cols + R * (torch.arange(T, dtype=torch.int32, device=cols.device) % 2)).contiguous()
        z_rect = torch.cat([h1, 2.0 * h1 + 1.0])
        hold("k1_bsr_spmm", "rectangular Z (2R block-rows)", k1.bsr_spmm(vals, cols_rect, lens, z_rect),
             k1.bsr_spmm_plain(vals, cols_rect, lens, z_rect))
        del cols_rect, z_rect
        # NaN in every padding tile, and block-row 1 emptied (its tiles are
        # padding now, so NaN too): finite output, equal to the clean plain
        # version, and act(b) on the empty row (zeros for K1).
        empty = 1
        lens_e = lens.clone()
        lens_e[empty] = 0
        poisoned = poison_padding(vals, lens_e)
        rows = slice(empty * 128, (empty + 1) * 128)
        for kernel, out, ref, b in (
            ("k2_ff_aggregate", fg.ff_aggregate(poisoned, cols, lens_e, z, ops["b1"], True),
             fg.ff_aggregate_plain(vals, cols, lens_e, z, ops["b1"], True), ops["b1"]),
            ("k2_af_layer", fg.af_layer(poisoned, cols, lens_e, ops["h1"], ops["w2"], ops["b2"], True),
             fg.af_layer_plain(vals, cols, lens_e, ops["h1"], ops["w2"], ops["b2"], True), ops["b2"]),
            ("k1_bsr_spmm", k1.bsr_spmm(poisoned, cols, lens_e, h1),
             k1.bsr_spmm_plain(vals, cols, lens_e, h1), torch.zeros_like(h1[0])),
        ):
            finite = bool(torch.isfinite(out).all())
            empty_ok = bool(torch.equal(out[rows], b.clamp_min(0).expand(128, -1)))
            ok = hold(kernel, "poisoned padding + empty block-row", out, ref)
            cases[-1].update(finite=finite, empty_row_is_act_b=empty_ok, ok=ok and finite and empty_ok)
        del poisoned
        check_rank_kernels(rank, halo, ops, hold)
        check_bf16_kernels(rank, ops, hold, cases)
        check_k1_bf16(rank, hold, cases)
        torch.cuda.empty_cache()
    ok = all(c["ok"] for c in cases)
    emit("kernels", ok=ok, rtol=KERNEL_RTOL, tail_rows=data["n"] % 128, cases=cases)
    require(ok, "kernels", "a kernel disagrees with its plain version")
    return worst


def check_rank_kernels(rank: dict, halo: dict, ops: dict, hold) -> None:
    """K1 and fp32 ``k2_af_layer`` against their plain versions at the
    shapes the halo forward gives them on rank 0: both over its
    [local ‖ halo] table (16 wide, fp32 wire), and K1 over the split pair —
    the interior table on the local block and the boundary table on the
    k·s_max-row halo block, each row-padded to the block grid as
    `repro_torch.kernels.ops.bsr_spmm` pads it."""
    from repro_torch.dist.halo import plan_blocked_rank
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    vals, cols, lens, table = rank["vals"], rank["cols"], rank["lens"], rank["table"]
    hold("k1_bsr_spmm", "rank 0 [local ‖ halo] table (F=16)", k1.bsr_spmm(vals, cols, lens, table),
         k1.bsr_spmm_plain(vals, cols, lens, table))
    for relu in (True, False):
        hold("k2_af_layer", f"rank 0 [local ‖ halo] table, relu={relu}",
             fg.af_layer(vals, cols, lens, table, ops["w2"], ops["b2"], relu),
             fg.af_layer_plain(vals, cols, lens, table, ops["w2"], ops["b2"], relu))
    plan, device = halo["plan"], table.device
    for part, n_rows in (("interior", plan.n_local), ("boundary", plan.k * plan.s_max)):
        ba = plan_blocked_rank(plan, 0, part=part, max_nnzb=halo["widths"][part])
        pv, pc, pl = ba.arrays(device=device)
        z = torch.zeros((ba.n_col_padded, table.shape[1]), device=device)
        z[:n_rows] = table[:n_rows]
        hold("k1_bsr_spmm", f"rank 0 {part} table over {n_rows} rows (F=16)", k1.bsr_spmm(pv, pc, pl, z),
             k1.bsr_spmm_plain(pv, pc, pl, z))
        del ba, pv, pc, pl, z


def check_bf16_kernels(rank: dict, ops: dict, hold, cases: list) -> None:
    """K2's bf16 instantiations against their plain versions at rank 0's
    shapes: layer 1's transform of its feature block, the feature-first
    aggregation and the aggregation-first layer over its [local ‖ halo]
    table (16 wide), relu on and off; the halo path's instantiation also
    with NaN-poisoned padding and an emptied block-row."""
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = rank["vals"], rank["cols"], rank["lens"]
    for sfx, (vd, xd, wd) in BF16_COMBOS.items():
        rv = vals.to(vd)
        rtol = KERNEL_RTOL if vd == torch.float32 else BF16_KERNEL_RTOL   # Z is stored in vals' dtype
        x, w1 = rank["x"].to(xd), ops["w1"].to(wd)
        hold(f"k2_ff_transform{sfx}", "rank 0 layer 1", fg.ff_transform(x, w1, vd), fg.ff_transform_plain(x, w1, vd),
             rtol)
        z, t, w2 = rank["z"].to(vd), rank["table"].to(xd), ops["w2"].to(wd)
        for relu in (True, False):
            hold(f"k2_ff_aggregate{sfx}", f"rank 0 table, relu={relu}",
                 fg.ff_aggregate(rv, cols, lens, z, ops["b1"], relu, xd),
                 fg.ff_aggregate_plain(rv, cols, lens, z, ops["b1"], relu, xd), BF16_KERNEL_RTOL)
            hold(f"k2_af_layer{sfx}", f"rank 0 table, relu={relu}",
                 fg.af_layer(rv, cols, lens, t, w2, ops["b2"], relu),
                 fg.af_layer_plain(rv, cols, lens, t, w2, ops["b2"], relu), BF16_KERNEL_RTOL)
        del rv, x, w1, z, t, w2
    empty = 1
    lens_e = lens.clone()
    lens_e[empty] = 0
    t = rank["table"].to(torch.bfloat16)
    out = fg.af_layer(poison_padding(vals, lens_e), cols, lens_e, t, ops["w2"], ops["b2"], True)
    ref = fg.af_layer_plain(vals, cols, lens_e, t, ops["w2"], ops["b2"], True)
    finite = bool(torch.isfinite(out.float()).all())
    empty_ok = bool(torch.equal(out[empty * 128:(empty + 1) * 128],
                                ops["b2"].clamp_min(0).to(torch.bfloat16).expand(128, -1)))
    ok = hold("k2_af_layer_bf16", "rank 0 table, poisoned padding + empty block-row", out, ref, BF16_KERNEL_RTOL)
    cases[-1].update(finite=finite, empty_row_is_act_b=empty_ok, ok=ok and finite and empty_ok)


def check_k1_bf16(rank: dict, hold, cases: list) -> None:
    """K1's bf16 instantiations against their plain version (the
    reference's per-tile rounding of the running sum) at rank 0's shape:
    its [local ‖ halo] table and a 16-wide bf16 table (what the bf16 wire
    hands the aggregation-first recompute), clean and with NaN-poisoned
    padding and an emptied block-row. Within one bf16 step of the largest
    value, and at least K1_BF16_BIT_EQUAL of the elements bit-equal."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = rank["vals"], rank["cols"], rank["lens"]
    t = rank["table"].to(torch.bfloat16)
    empty = 1
    lens_e = lens.clone()
    lens_e[empty] = 0
    for sfx, (vd, zd) in K1_BF16_COMBOS.items():
        rv = vals.to(vd)
        for case, kv, kl in (("rank 0 table (F=16)", rv, lens),
                             ("rank 0 table, poisoned padding + empty block-row", poison_padding(rv, lens_e), lens_e)):
            out = k1.bsr_spmm(kv, cols, kl, t)
            ref = k1.bsr_spmm_plain(rv, cols, kl, t)
            ok = hold(f"k1_bsr_spmm{sfx}", case, out, ref, K1_BF16_STEP)
            bit_equal = float((out == ref).float().mean())
            finite = bool(torch.isfinite(out.float()).all())
            empty_ok = kl is lens or bool((out[empty * 128:(empty + 1) * 128] == 0).all())
            cases[-1].update(bit_equal=bit_equal, bit_equal_min=K1_BF16_BIT_EQUAL, finite=finite,
                             empty_row_is_zero=empty_ok, ok=ok and bit_equal >= K1_BF16_BIT_EQUAL and finite and empty_ok)
            del kv, out, ref
        del rv


def run_main_path(data: dict) -> dict:
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.models.gcn import gcn_forward, gcn_init

    device = data["x"].device
    pg = data["pg"]
    cfg = dataclasses.replace(make_config(dataset=DATASET), backend="bsr")
    params = gcn_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    adjacency = (data["vals"], data["cols"], data["lens"])

    def forward(c):
        return gcn_forward(params, data["x"], pg.senders, pg.receivers, pg.edge_weight, c,
                           adjacency=adjacency if c.backend == "bsr" else None)

    with torch.inference_mode():
        torch.cuda.synchronize()
        fg.reset_launch_counts()
        for _ in range(PASSES):
            logits = forward(cfg)
        torch.cuda.synchronize()
        launches = dict(fg.LAUNCHES)
        quant_off = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
        logits_off = forward(quant_off)
        err, scale = max_err(logits_off, forward(dataclasses.replace(quant_off, backend="segment")))
        ref_q = forward(dataclasses.replace(cfg, backend="segment"))
    expected = {name: PASSES if name in K2 else 0 for name in fg.LAUNCHES}   # K1 runs in training only
    # Agreement up to ties: a node agrees when the class the kernel path
    # picks is a top logit of the plain path within the logit tolerance.
    agree, raw_agree, tied = argmax_agreement(logits, ref_q, LOGIT_RTOL)
    pred = logits.argmax(-1) == data["labels"]
    acc = float(pred[data["test"]].float().mean())
    checks = dict(
        launches=launches == expected,
        shape=tuple(logits.shape) == (data["n"], data["spec"].n_labels),
        finite=bool(torch.isfinite(logits).all()),
        quant_off_logits=bool(err <= LOGIT_RTOL * scale),
        quant_on_argmax=agree >= ARGMAX_AGREEMENT,
    )
    emit("main", ok=all(checks.values()), checks=checks, passes=PASSES, launches=launches,
         expected_launches=expected, quant_off_max_abs_err=err, quant_off_max_abs_logit=scale,
         logit_rtol=LOGIT_RTOL, quant_on_max_abs_diff=max_err(logits, ref_q)[0],
         quant_on_argmax_agreement=agree, argmax_agreement_min=ARGMAX_AGREEMENT,
         quant_on_raw_argmax_equal=raw_agree, quant_on_nodes_with_tied_top_logits=tied,
         test_accuracy=acc, note="random weights: accuracy is near chance")
    require(all(checks.values()), "main", f"checks {checks}")
    return dict(launches=launches, forward=forward, cfg=cfg, logits_quant_off=logits_off.cpu().numpy())


def run_training(data: dict) -> dict:
    """The training path: one quant-off gradient on each backend, five
    quant-on AdamW steps of a `Trainer` with the launch counts zeroed just
    before and read just after, five quant-off steps on each backend."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.models.gcn import gcn_forward, gcn_init, gcn_loss
    from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
    from repro_torch.train.optimizer import adamw

    device = data["x"].device
    pg = data["pg"]
    cfg = dataclasses.replace(make_config(dataset=DATASET), backend="bsr")
    quant_off = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
    adjacency = (data["vals"], data["cols"], data["lens"])
    batch = dict(x=data["x"], labels=data["labels"], mask=(~data["test"]).float())

    def loss_fn(c):
        kw = {"adjacency": adjacency} if c.backend == "bsr" else {}

        def loss(p, b):
            return gcn_loss(p, b["x"], pg.senders, pg.receivers, pg.edge_weight, b["labels"], b["mask"],
                            c, **kw)
        return loss

    def trainer(c):
        params = gcn_init(torch.Generator().manual_seed(SEED), c, device=device)
        return Trainer(loss_fn(c), adamw(), params, TrainerConfig(log_every=TRAIN_STEPS + 1))

    def fit(tr):
        return tr.fit(iter(lambda: batch, None), max_steps=TRAIN_STEPS)

    # One quant-off gradient through the kernels and the reference's VJP,
    # against autograd through the segment path.
    grads = {}
    for backend in ("bsr", "segment"):
        c = dataclasses.replace(quant_off, backend=backend)
        params = gcn_init(torch.Generator().manual_seed(SEED), c, device=device)
        _, grads[backend] = value_and_grad(loss_fn(c), params, batch)
    grad_err = {k: max_err(grads["bsr"][k], grads["segment"][k]) for k in grads["bsr"]}
    grads_bsr = {k: g.cpu().numpy() for k, g in grads["bsr"].items()}    # the sharded gradients' reference
    del grads

    # The same gradient with the logits rounded to bf16 before the loss (and
    # so their cotangent), as the sharded bf16 path's fused layer emits them:
    # the reference of that path's gradient.
    def bf16_logits_loss(p, b):
        logits = gcn_forward(p, b["x"], pg.senders, pg.receivers, pg.edge_weight, quant_off,
                             adjacency=adjacency).to(torch.bfloat16).float()
        gold = torch.gather(logits, 1, b["labels"].long()[:, None])[:, 0]
        return ((torch.logsumexp(logits, dim=-1) - gold) * b["mask"]).sum() / b["mask"].sum()

    params = gcn_init(torch.Generator().manual_seed(SEED), quant_off, device=device)
    grads_bsr_bf16 = {k: g.cpu().numpy() for k, g in value_and_grad(bf16_logits_loss, params, batch)[1].items()}

    tr = trainer(cfg)
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    losses = fit(tr)
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)
    del tr

    trajectory = {b: fit(trainer(dataclasses.replace(quant_off, backend=b))) for b in ("bsr", "segment")}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(trajectory["bsr"], trajectory["segment"])]
    expected = {name: TRAIN_STEPS if name in FP32_KERNELS else 0 for name in fg.LAUNCHES}
    checks = dict(
        launches=launches == expected,
        gradients=all(err <= GRAD_RTOL * scale for err, scale in grad_err.values()),
        finite_losses=len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
        quant_off_trajectory=len(loss_rel) == TRAIN_STEPS and max(loss_rel) <= LOSS_RTOL,
    )
    emit("train", ok=all(checks.values()), checks=checks, steps=TRAIN_STEPS, optimizer="adamw(lr=1e-3)",
         launches=launches, expected_launches=expected, losses_bsr_quant_on=losses,
         grad_max_abs_err={k: e for k, (e, _) in grad_err.items()},
         grad_max_abs={k: s for k, (_, s) in grad_err.items()}, grad_rtol=GRAD_RTOL,
         losses_quant_off=trajectory, loss_max_rel_diff=max(loss_rel), loss_rtol=LOSS_RTOL)
    require(all(checks.values()), "train", f"checks {checks}")
    return dict(launches=launches, trainer=trainer, batch=batch, cfg=cfg, quant_off=quant_off,
                grads_bsr_quant_off=grads_bsr, grads_bsr_quant_off_bf16_logits=grads_bsr_bf16,
                losses_bsr_quant_off=trajectory["bsr"])


def time_everything(data: dict, ops: dict, main: dict, train: dict) -> dict:
    from repro_torch.core.quant import fake_quant
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ops import _bsr_t_apply, _tile_mask

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    nnz = int(lens.sum())
    R, B = cols.shape[0], 128
    x, w1, b1, h1, w2, b2 = (ops[k] for k in ("x", "w1", "b1", "h1", "w2", "b2"))
    M, K = x.shape
    hidden, f_out = w1.shape[1], w2.shape[1]
    tiles, idx = 4.0 * nnz * B * B, 4.0 * (R + nnz)
    with torch.inference_mode():
        z = fg.ff_transform(x, w1)
        rows = {
            "k2_ff_transform": dict(
                ms=cuda_ms(lambda: fg.ff_transform(x, w1)),
                plain_ms=cuda_ms(lambda: fg.ff_transform_plain(x, w1)),
                library_ms=cuda_ms(lambda: torch.mm(x, w1)),
                bound=bound(4.0 * (M * K + K * hidden + M * hidden), 2.0 * M * K * hidden)),
            "k2_ff_aggregate": dict(
                ms=cuda_ms(lambda: fg.ff_aggregate(vals, cols, lens, z, b1, True)),
                plain_ms=cuda_ms(lambda: fg.ff_aggregate_plain(vals, cols, lens, z, b1, True)),
                library_ms=None,
                bound=bound(tiles + idx + 4.0 * (z.numel() + hidden + R * B * hidden),
                            2.0 * nnz * B * B * hidden + R * B * hidden)),
            "k2_af_layer": dict(
                ms=cuda_ms(lambda: fg.af_layer(vals, cols, lens, h1, w2, b2, True)),
                plain_ms=cuda_ms(lambda: fg.af_layer_plain(vals, cols, lens, h1, w2, b2, True)),
                library_ms=None,
                bound=bound(tiles + idx + 4.0 * (h1.numel() + w2.numel() + f_out + R * B * f_out),
                            2.0 * nnz * B * B * hidden + 2.0 * R * B * hidden * f_out)),
            "k1_bsr_spmm": dict(
                ms=cuda_ms(lambda: k1.bsr_spmm(vals, cols, lens, h1)),
                plain_ms=cuda_ms(lambda: k1.bsr_spmm_plain(vals, cols, lens, h1)),
                library_ms=None,
                bound=bound(tiles + idx + 4.0 * (h1.numel() + R * B * hidden), 2.0 * nnz * B * B * hidden)),
        }
        # The backward's torch parts at Nell's shapes: both layers' blocked
        # transposes take a 16-wide cotangent (layer 1's dpre, layer 2's
        # dm = g·W2ᵀ), and layer 1's dw = Xᵀ·dz is the one large matmul.
        pairs = _tile_mask(cols, lens).nonzero(as_tuple=True)
        g1, g2 = torch.randn_like(h1), torch.randn_like(h1)
        backward = dict(
            bsr_t_apply_layer1_ms=cuda_ms(lambda: _bsr_t_apply(vals, cols, pairs, g1, M)),
            bsr_t_apply_layer2_ms=cuda_ms(lambda: _bsr_t_apply(vals, cols, pairs, g2, M)),
            dw_xt_dz_ms=cuda_ms(lambda: x.T @ g1),
        )
        del pairs, g1, g2
        forward, cfg = main["forward"], main["cfg"]
        seg = dataclasses.replace(cfg, backend="segment")
        torch.cuda.reset_peak_memory_stats()
        totals = dict(
            forward_bsr_quant_ms=cuda_ms(lambda: forward(cfg), reps=5),
            forward_bsr_noquant_ms=cuda_ms(
                lambda: forward(dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, enabled=False))),
                reps=5),
            forward_segment_quant_ms=cuda_ms(lambda: forward(seg), reps=5),
            fake_quant_x_ms=cuda_ms(lambda: fake_quant(data["x"], 4, percentile=99.9), reps=5),
            peak_memory_forward_gb=torch.cuda.max_memory_allocated() / 1e9,
        )

    def step_ms(c):
        tr = train["trainer"](c)

        def one():
            tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(
                tr.params, tr.opt_state, tr.residual, train["batch"])
            float(loss)
        return wall_ms(one)

    cfg, quant_off = train["cfg"], train["quant_off"]
    torch.cuda.reset_peak_memory_stats()
    totals["train_step_bsr_quant_ms"] = step_ms(cfg)
    totals["peak_memory_train_step_gb"] = torch.cuda.max_memory_allocated() / 1e9
    totals["train_step_bsr_noquant_ms"] = step_ms(quant_off)
    totals["train_step_segment_quant_ms"] = step_ms(dataclasses.replace(cfg, backend="segment"))
    emit("times", ok=True, reps=dict(kernel=10, forward=5, train_step=5), **totals, backward=backward,
         resident_tile_table_gb=vals.numel() * 4 / 1e9,
         kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()})
    return rows


def time_bf16_kernels(rank: dict, ops: dict) -> dict:
    """CUDA-event medians of K2's and K1's bf16 instantiations at rank 0's shapes,
    their plain versions and, where one PyTorch call computes the same
    function, that call; with ``k2_af_layer`` (fp32) at the same shape
    beside the halo path's ``k2_af_layer_bf16``. Bounds count each element
    at its own width (2 bytes for bf16)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    vals, cols, lens, nnz = rank["vals"], rank["cols"], rank["lens"], rank["nnz"]
    R, B = cols.shape[0], 128
    size = {torch.float32: 4.0, torch.bfloat16: 2.0}
    idx = 4.0 * (R + nnz)
    rows = {}
    with torch.inference_mode():
        for sfx, (vd, xd, wd) in BF16_COMBOS.items():
            rate = BF16_FLOP_PER_S if (vd, xd, wd) == (torch.bfloat16,) * 3 else FP32_FLOP_PER_S
            rv, x, w1, w2 = vals.to(vd), rank["x"].to(xd), ops["w1"].to(wd), ops["w2"].to(wd)
            z, t, b1, b2 = rank["z"].to(vd), rank["table"].to(xd), ops["b1"], ops["b2"]
            M, K = x.shape
            hidden, f_out = w1.shape[1], w2.shape[1]
            tiles = size[vd] * nnz * B * B
            rows[f"k2_ff_transform{sfx}"] = dict(
                ms=cuda_ms(lambda: fg.ff_transform(x, w1, vd)),
                plain_ms=cuda_ms(lambda: fg.ff_transform_plain(x, w1, vd)),
                library_ms=cuda_ms(lambda: torch.mm(x, w1)) if xd == wd else None,
                bound=bound(size[xd] * M * K + size[wd] * K * hidden + size[vd] * M * hidden,
                            2.0 * M * K * hidden, rate))
            rows[f"k2_ff_aggregate{sfx}"] = dict(
                ms=cuda_ms(lambda: fg.ff_aggregate(rv, cols, lens, z, b1, True, xd)),
                plain_ms=cuda_ms(lambda: fg.ff_aggregate_plain(rv, cols, lens, z, b1, True, xd)),
                library_ms=None,
                bound=bound(tiles + idx + size[vd] * z.numel() + 4.0 * hidden + size[xd] * R * B * hidden,
                            2.0 * nnz * B * B * hidden + R * B * hidden, rate))
            rows[f"k2_af_layer{sfx}"] = dict(
                ms=cuda_ms(lambda: fg.af_layer(rv, cols, lens, t, w2, b2, True)),
                plain_ms=cuda_ms(lambda: fg.af_layer_plain(rv, cols, lens, t, w2, b2, True)),
                library_ms=None,
                bound=bound(tiles + idx + size[xd] * t.numel() + size[wd] * w2.numel() + 4.0 * f_out
                            + size[xd] * R * B * f_out,
                            2.0 * nnz * B * B * hidden + 2.0 * R * B * hidden * f_out, rate))
            del rv, x, w1, w2, z, t
        for sfx, (vd, zd) in K1_BF16_COMBOS.items():
            rv, t = vals.to(vd), rank["table"].to(zd)
            F = t.shape[1]
            rate = BF16_FLOP_PER_S if vd == torch.bfloat16 else FP32_FLOP_PER_S
            rows[f"k1_bsr_spmm{sfx}"] = dict(
                ms=cuda_ms(lambda: k1.bsr_spmm(rv, cols, lens, t)),
                plain_ms=cuda_ms(lambda: k1.bsr_spmm_plain(rv, cols, lens, t)),
                library_ms=None,
                bound=bound(size[vd] * nnz * B * B + idx + size[zd] * (t.numel() + R * B * F),
                            2.0 * nnz * B * B * F, rate))
            del rv, t
        t32 = rank["table"]
        af32_ms = cuda_ms(lambda: fg.af_layer(vals, cols, lens, t32, ops["w2"], ops["b2"], True))
        af32_bound = bound(4.0 * nnz * B * B + idx + 4.0 * (t32.numel() + ops["w2"].numel() + ops["w2"].shape[1]
                                                             + R * B * ops["w2"].shape[1]),
                           2.0 * nnz * B * B * t32.shape[1] + 2.0 * R * B * ops["w2"].numel())
    emit("times_rank", ok=True, rank=0, block_rows=R, tile_table_width=int(cols.shape[1]), nnz_tiles=nnz,
         table_rows=int(rank["table"].shape[0]), reps=10,
         af_layer_bf16_vs_fp32=dict(bf16_ms=rows["k2_af_layer_bf16"]["ms"],
                                    bf16_bound=list(rows["k2_af_layer_bf16"]["bound"]),
                                    fp32_ms=af32_ms, fp32_bound=list(af32_bound)),
         kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()})
    return rows


def profile_train_steps(train: dict, steps: int = 3) -> None:
    """Device time by kernel name and the idle share of the card over
    ``steps`` bsr quant-on training steps, from torch.profiler's CUDA events
    (their union is the busy time; the window spans every recorded event)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import device_time_summary

    tr = train["trainer"](train["cfg"])

    def one():
        tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(
            tr.params, tr.opt_state, tr.residual, train["batch"])
        float(loss)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    emit("profile", ok=True, steps=steps, **device_time_summary(list(prof.events()), steps),
         note="profiler overhead lengthens the host side of the window")


def halo_variants():
    from repro_torch.launch.distributed_gcn import HaloVariant as V

    return (V("a_fp32"), V("b_bf16", payload="bf16"), V("c_split_fp32", split=True), V("d_int8", payload="int8"),
            V("e_bsr_quant_bf16", payload="bf16", quant=True),
            V("e_segment_quant_bf16", backend="segment", payload="bf16", quant=True))


# Launches per rank in one forward: layer 1 (5,414 → 16, feature-first) is
# X·W (torch.matmul) then K1 over the [local ‖ halo] table, or K1 on the
# interior and the boundary table; layer 2 (16 → 210, aggregation-first)
# is one K2 launch over the combined table (bf16 table under the bf16
# wire), or K1 twice and X·W on the split pair. The segment path runs none.
HALO_LAUNCHES = {
    "a_fp32": {"k1_bsr_spmm": 1, "k2_af_layer": 1},
    "b_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1},
    "c_split_fp32": {"k1_bsr_spmm": 4},
    "d_int8": {"k1_bsr_spmm": 1, "k2_af_layer": 1},
    "e_bsr_quant_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1},
    "e_segment_quant_bf16": {},
}


def halo_train_variants():
    from repro_torch.launch.distributed_gcn import HaloVariant as V

    return (V("t1_fp32"), V("t2_bf16", payload="bf16"), V("t3_split_fp32", split=True),
            V("t4_bsr_quant_bf16", payload="bf16", quant=True),
            V("t4_segment_quant_bf16", backend="segment", payload="bf16", quant=True, round_logits=True))


# Launches per rank in one training step: the forward's (HALO_LAUNCHES) and,
# for the combined table's aggregation-first layer 2, K1 once more in its
# backward (the recompute M = Ã·table; under the bf16 wire its bf16
# instantiation). The backward's blocked transposes are torch ops.
HALO_TRAIN_LAUNCHES = {
    "t1_fp32": {"k1_bsr_spmm": 2, "k2_af_layer": 1},
    "t2_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1, "k1_bsr_spmm_bf16": 1},
    "t3_split_fp32": {"k1_bsr_spmm": 4},
    "t4_bsr_quant_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1, "k1_bsr_spmm_bf16": 1},
    "t4_segment_quant_bf16": {},
}


def run_halo(host: dict, halo: dict, main: dict, train: dict) -> tuple[dict, dict]:
    """The sharded forward and sharded training on HALO_K ranks sharing the
    card, in one group: the forward against the unsharded bsr forward, the
    training (`halo_train` line) against the unsharded bsr train phase;
    returns each kernel's launches summed over the ranks' forwards (one per
    variant) and over their training steps."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.dist.halo import restore_node_array
    from repro_torch.graph.structure import restore_rows
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.launch.distributed_gcn import halo_rank, rank_jobs
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.models.gcn import gcn_init

    plan = halo["plan"]
    cfg = make_config(dataset=DATASET)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(SEED), cfg, device="cpu").items()}
    variants = halo_variants()
    t0 = time.perf_counter()
    jobs = rank_jobs(plan, host["features"], params, cfg.layer_dims, variants, quant=cfg.quant,
                     time_reps=HALO_REPS, labels=host["labels"], mask=host["train_mask"],
                     train_variants=halo_train_variants(), steps=HALO_TRAIN_STEPS, lr=HALO_TRAIN_LR)
    spec = GroupSpec(k=HALO_K, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    print(f"halo group: {spec.describe()}", flush=True)
    results = run_group(spec, halo_rank, jobs)
    seconds = time.perf_counter() - t0
    ref = restore_rows(host["perm"], main["logits_quant_off"])        # unsharded bsr, global node order
    ref_scale = float(np.abs(ref).max())
    per_variant, checks = {}, {}
    launches = {name: 0 for name in fg.LAUNCHES}
    logits = {}
    for v in variants:
        recs = [r["variants"][v.name] for r in results]
        logits[v.name] = restore_node_array(plan, np.stack([rec["logits"] for rec in recs]))
        for rec in recs:
            for name, n in rec["launches"].items():
                launches[name] += n
        per_variant[v.name] = dict(
            backend=v.backend, payload=v.payload or "fp32", tables="split" if v.split else "combined",
            quant=v.quant, dtype=recs[0]["dtype"], launches_per_rank=[rec["launches"] for rec in recs],
            wire_rows_per_rank=[rec["wire_rows"] for rec in recs],
            wire_bytes_per_rank=[rec["wire_bytes"] for rec in recs],
            forward_ms_per_rank=[rec.get("forward_ms") for rec in recs])
        checks[f"{v.name}_launches"] = all(rec["launches"] == HALO_LAUNCHES[v.name] for rec in recs)
        checks[f"{v.name}_wire_rows"] = all(rec["wire_rows"] == (cfg.n_layers * plan.halo_rows_per_device)
                                            for rec in recs)
        checks[f"{v.name}_finite"] = all(rec["finite"] for rec in recs) and bool(np.isfinite(logits[v.name]).all())
        checks[f"{v.name}_shape"] = logits[v.name].shape == ref.shape
    for name, rtol in (("a_fp32", HALO_LOGIT_RTOL), ("c_split_fp32", HALO_LOGIT_RTOL), ("b_bf16", HALO_BF16_RTOL)):
        err = float(np.abs(logits[name] - ref).max())
        per_variant[name].update(max_abs_err_vs_unsharded=err, rtol=rtol)
        checks[f"{name}_vs_unsharded"] = err <= rtol * ref_scale
    diff = logits["d_int8"] - ref
    err8, rel8 = float(np.abs(diff).max()), float(np.linalg.norm(diff) / np.linalg.norm(ref))
    per_variant["d_int8"].update(max_abs_err_vs_unsharded=err8, rel_l2_vs_unsharded=rel8,
                                 max_abs_bound=HALO_INT8_ABS, rel_l2_bound=HALO_INT8_REL_L2)
    checks["d_int8_vs_unsharded"] = err8 < HALO_INT8_ABS and rel8 <= HALO_INT8_REL_L2
    # (e): the main phase's rule, ties within LOGIT_RTOL · max |logit|. The
    # bsr path's logits are bf16 (the fused bf16 layer's output), so the
    # agreement with ties within the bf16 tolerance is reported beside it.
    eb, es = torch.from_numpy(logits["e_bsr_quant_bf16"]), torch.from_numpy(logits["e_segment_quant_bf16"])
    agree, raw, tied = argmax_agreement(eb, es, LOGIT_RTOL)
    agree_bf16_ties = argmax_agreement(eb, es, HALO_BF16_RTOL)[0]
    checks["e_argmax_agreement"] = agree >= ARGMAX_AGREEMENT
    ok = all(checks.values())
    emit("halo", ok=ok, checks=checks, ranks=HALO_K, group=spec.describe(), shared_card="cuda:0",
         wire="gloo through the host (NCCL not exercised: one card)", seconds=seconds,
         halo_rows_per_rank_per_exchange=plan.halo_rows_per_device, k_s_max=plan.k * plan.s_max,
         exchanges_per_forward=cfg.n_layers, max_abs_logit_unsharded=ref_scale, variants=per_variant,
         e_argmax_agreement=agree, e_argmax_agreement_bf16_ties=agree_bf16_ties, e_raw_argmax_equal=raw,
         e_nodes_with_tied_top_logits=tied, e_tie_rtol=LOGIT_RTOL, argmax_agreement_min=ARGMAX_AGREEMENT,
         exchange_ms_per_rank={p: [r["exchange_ms"][p] for r in results] for p in results[0].get("exchange_ms", {})},
         exchange_width=cfg.layer_dims[1], peak_memory_gb_per_rank=[r.get("peak_memory_gb") for r in results],
         profile_first_variant_per_rank=[r.get("profile") for r in results],
         launches_all_ranks=launches, timing=f"CUDA events after a group barrier, median of {HALO_REPS}; "
         f"{HALO_K} ranks share one card, so these are not multi-card times")
    require(ok, "halo", f"checks {checks}")
    return launches, check_halo_train(results, plan, cfg, train, seconds)


def check_halo_train(results: list, plan, cfg, train: dict, seconds: float) -> dict:
    """The `halo_train` line: every training variant's checks on every
    rank; returns each kernel's launches over all ranks' training steps."""
    from repro_torch.kernels import fused_gcn as fg

    variants = halo_train_variants()
    ref_losses = train["losses_bsr_quant_off"]
    rows_per_step = 2 * cfg.n_layers * plan.halo_rows_per_device     # forward and backward exchanges
    checks, per_variant = {}, {}
    launches = {name: 0 for name in fg.LAUNCHES}

    def grad_errs(recs, ref):
        return {n: max(float(np.abs(rec["grads"][n] - ref[n]).max()) for rec in recs) / float(np.abs(ref[n]).max())
                for n in ref}

    for v in variants:
        recs = [r["train"][v.name] for r in results]
        for rec in recs:
            for name, n in rec["launches"].items():
                launches[name] += n
        expected = {k: n * HALO_TRAIN_STEPS for k, n in HALO_TRAIN_LAUNCHES[v.name].items()}
        checks[f"{v.name}_launches"] = all(rec["launches"] == expected for rec in recs)
        checks[f"{v.name}_wire_rows"] = all(rec["wire_rows"] == rows_per_step * HALO_TRAIN_STEPS for rec in recs)
        checks[f"{v.name}_finite"] = all(rec["finite"] for rec in recs)
        checks[f"{v.name}_steps"] = all(rec["steps_run"] == HALO_TRAIN_STEPS for rec in recs)
        checks[f"{v.name}_ranks_agree"] = all(rec["losses"] == recs[0]["losses"] for rec in recs)
        per_variant[v.name] = dict(
            backend=v.backend, payload=v.payload or "fp32", tables="split" if v.split else "combined",
            quant=v.quant, losses=recs[0]["losses"], launches_per_rank_per_step=HALO_TRAIN_LAUNCHES[v.name],
            wire_rows_per_rank_per_step=[rec["wire_rows"] / HALO_TRAIN_STEPS for rec in recs],
            wire_bytes_per_rank_per_step=[rec["wire_bytes"] / HALO_TRAIN_STEPS for rec in recs],
            step_ms_per_rank=[rec.get("step_ms") for rec in recs])
        if not v.quant:
            # The bf16 path's logits are bf16 (the fused layer's output), and
            # so is their cotangent: its reference rounds the logits alike.
            bf16 = v.payload == "bf16"
            errs = grad_errs(recs, train["grads_bsr_quant_off_bf16_logits" if bf16 else "grads_bsr_quant_off"])
            rtol = HALO_BF16_GRAD_RTOL if bf16 else HALO_GRAD_RTOL
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], ref_losses))
            per_variant[v.name].update(grad_rel_err_vs_unsharded=errs, grad_rtol=rtol,
                                       loss_max_rel_diff_vs_unsharded=loss_rel)
            if bf16:
                per_variant[v.name].update(
                    grad_reference="unsharded bsr, logits rounded to bf16",
                    grad_rel_err_vs_unsharded_fp32_logits=grad_errs(recs, train["grads_bsr_quant_off"]))
            checks[f"{v.name}_grads_vs_unsharded"] = all(e <= rtol for e in errs.values())
            if v.payload is None:
                per_variant[v.name]["loss_rtol"] = HALO_LOSS_RTOL
                checks[f"{v.name}_losses_vs_unsharded"] = loss_rel <= HALO_LOSS_RTOL
    bsr = [r["train"]["t4_bsr_quant_bf16"] for r in results]
    seg = [r["train"]["t4_segment_quant_bf16"] for r in results]
    errs = grad_errs(bsr, seg[0]["grads"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(bsr[0]["losses"], seg[0]["losses"]))
    per_variant["t4_bsr_quant_bf16"].update(grad_rel_err_vs_segment=errs, grad_rtol=HALO_BF16_GRAD_RTOL,
                                            loss_max_rel_diff_vs_segment=loss_rel, loss_rtol=HALO_QUANT_LOSS_RTOL)
    checks["t4_grads_bsr_vs_segment"] = all(e <= HALO_BF16_GRAD_RTOL for e in errs.values())
    checks["t4_losses_bsr_vs_segment"] = loss_rel <= HALO_QUANT_LOSS_RTOL
    ok = all(checks.values())
    emit("halo_train", ok=ok, checks=checks, ranks=HALO_K, steps=HALO_TRAIN_STEPS,
         optimizer=f"adamw(lr={HALO_TRAIN_LR})", seconds_halo_phase=seconds,
         wire_rows_per_rank_per_step_expected=rows_per_step, variants=per_variant,
         exchange_backward_ms_per_rank={p: [r["train"]["exchange_backward_ms"][p] for r in results]
                                        for p in results[0]["train"].get("exchange_backward_ms", {})},
         exchange_width=cfg.layer_dims[1],
         peak_memory_gb_per_rank=[r["train"].get("peak_memory_gb") for r in results],
         launches_all_ranks=launches, timing=f"step: host clock after a group barrier, median of {HALO_REPS} "
         f"after 2 warm-ups; exchange backward: CUDA events after a barrier, median of {HALO_REPS}; "
         f"{HALO_K} ranks share one card")
    require(ok, "halo_train", f"checks {checks}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    emit("setup", ok=True, tf32="off (torch.backends.cuda.matmul and cudnn allow_tf32 = False)",
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count())

    build_kernels()
    data = load_graph(device)
    halo = build_plan(data)
    ops = layer_operands(data, torch.Generator().manual_seed(SEED + 1))
    rank = rank_operands(data, halo, ops, torch.Generator().manual_seed(SEED + 2))
    worst = check_kernels(data, ops, rank, halo)
    del rank                 # kept off the card while the unsharded paths run and measure their peak
    torch.cuda.empty_cache()
    main_run = run_main_path(data)
    train_run = run_training(data)
    rows = time_everything(data, ops, main_run, train_run)
    rank = rank_operands(data, halo, ops, torch.Generator().manual_seed(SEED + 2))
    rows.update(time_bf16_kernels(rank, ops))
    profile_train_steps(train_run)

    # The ranks share the card: free the unsharded tables first.
    host, inference, train = data["host"], main_run["launches"], train_run["launches"]
    halo_ref = {k: train_run[k] for k in ("grads_bsr_quant_off", "grads_bsr_quant_off_bf16_logits",
                                          "losses_bsr_quant_off")}
    main_run.pop("forward")
    del data, ops, rank, train_run
    gc.collect()
    torch.cuda.empty_cache()
    sharded, sharded_train = run_halo(host, halo, main_run, halo_ref)

    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[name],
             launches=inference[name] + train[name] + sharded[name] + sharded_train[name],
             launches_inference=inference[name], launches_train=train[name],
             launches_per_train_step=train[name] / TRAIN_STEPS, launches_halo=sharded[name],
             launches_halo_train=sharded_train[name], max_abs_err=worst[name], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound"][0], bound_by=row["bound"][1],
             library_ms=row["library_ms"],
             shape="rank 0 of 4 (halo)" if name not in FP32_KERNELS else "unsharded Nell")
        for name, row in rows.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
