#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root (it imports ``src/repro_torch`` beside this
file). It needs one CUDA card and exits non-zero without one, or without
the package, before printing any result. It imports nothing of JAX and
nothing of the JAX package `repro`.

Two paths of the paper's GCN (``coin_gcn``) run at the widths of Nell
(Table I: 65,755 nodes, 5,414 → 16 → 210, 4-bit fake quant) with the
blocked (bsr) backend: full-graph inference and full-graph training. The
forward of each layer runs the hand-written CUDA kernels of
`repro_torch.kernels.fused_gcn` (K2): layer 1 feature-first
(``k2_ff_transform`` then ``k2_ff_aggregate``), layer 2 aggregation-first
(``k2_af_layer``). The backward of layer 2 recomputes Ã·h1 through
`repro_torch.kernels.bsr_spmm` (K1, ``k1_bsr_spmm``). Weights are random,
from a seed.

Phases, one JSON line each; any failed check ends the run with exit code 1:

  build    compile the kernels from src/repro_torch/kernels/csrc (nvcc)
  data     make_dataset("nell") → symmetrize, self-loops, sym-norm weights →
           locality_block_order → blocked_adjacency → the card
  kernels  each kernel against its plain PyTorch version on the card at
           Nell's layer shapes: relu on and off, NaN-poisoned padding tiles,
           an empty block-row, the 91-row tail block; K1 also on a
           rectangular Z with extra source block-rows
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

then the card's name and power limit (nvidia-smi), the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh"
REPLACES = {
    "k2_ff_transform": "src/repro/kernels/fused_gcn.py:45",
    "k2_ff_aggregate": "src/repro/kernels/fused_gcn.py:45",
    "k2_af_layer": "src/repro/kernels/fused_gcn.py:70",
    "k1_bsr_spmm": "src/repro/kernels/bsr_spmm.py:87",
}
K2 = ("k2_ff_transform", "k2_ff_aggregate", "k2_af_layer")


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


def bound(n_bytes: float, n_flop: float) -> tuple[float, str]:
    """Least time on the card (ms): bytes over the HBM rate or fp32
    operations over the CUDA-core rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


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
        relocate_rows, to_padded,
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
                test=torch.from_numpy(test).to(device))


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


def check_kernels(data: dict, ops: dict) -> dict:
    """Each kernel against its plain version; returns the worst error per kernel."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    h1 = ops["h1"]
    worst = {name: 0.0 for name in fg.LAUNCHES}
    cases = []

    def hold(kernel, case, out, ref):
        err, scale = max_err(out, ref)
        ok = bool(err <= KERNEL_RTOL * scale)
        cases.append(dict(kernel=kernel, case=case, max_abs_err=err, max_abs_ref=scale, ok=ok))
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
        torch.cuda.empty_cache()
    ok = all(c["ok"] for c in cases)
    emit("kernels", ok=ok, rtol=KERNEL_RTOL, tail_rows=data["n"] % 128, cases=cases)
    require(ok, "kernels", "a kernel disagrees with its plain version")
    return worst


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
        err, scale = max_err(forward(quant_off), forward(dataclasses.replace(quant_off, backend="segment")))
        ref_q = forward(dataclasses.replace(cfg, backend="segment"))
    expected = {name: PASSES if name in K2 else 0 for name in fg.LAUNCHES}   # K1 runs in training only
    # Agreement up to ties: a node agrees when the class the kernel path
    # picks is a top logit of the plain path within the logit tolerance.
    # Quantized activations are often all zero on a node, and then every
    # logit ties and argmax is decided by noise.
    top = ref_q.max(-1).values
    picked = ref_q.gather(1, logits.argmax(-1, keepdim=True))[:, 0]
    tie_tol = LOGIT_RTOL * float(ref_q.abs().max())
    agree = float((picked >= top - tie_tol).float().mean())
    raw_agree = float((logits.argmax(-1) == ref_q.argmax(-1)).float().mean())
    tied = int(((ref_q >= top[:, None] - tie_tol).sum(-1) > 1).sum())
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
    return dict(launches=launches, forward=forward, cfg=cfg)


def run_training(data: dict) -> dict:
    """The training path: one quant-off gradient on each backend, five
    quant-on AdamW steps of a `Trainer` with the launch counts zeroed just
    before and read just after, five quant-off steps on each backend."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.models.gcn import gcn_init, gcn_loss
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
    del grads

    tr = trainer(cfg)
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    losses = fit(tr)
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)
    del tr

    trajectory = {b: fit(trainer(dataclasses.replace(quant_off, backend=b))) for b in ("bsr", "segment")}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(trajectory["bsr"], trajectory["segment"])]
    expected = {name: TRAIN_STEPS for name in fg.LAUNCHES}
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
    return dict(launches=launches, trainer=trainer, batch=batch, cfg=cfg, quant_off=quant_off)


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


def profile_train_steps(train: dict, steps: int = 3) -> None:
    """Device time by kernel name and the idle share of the card over
    ``steps`` bsr quant-on training steps, from torch.profiler's CUDA events
    (their union is the busy time; the window spans every recorded event)."""
    from torch.profiler import ProfilerActivity, profile

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
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, last = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) if events else 0.0
    by_name: dict[str, list] = {}          # kernel name → [µs, launches]
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    emit("profile", ok=True, steps=steps, device_kernel_events=len(kernels),
         window_ms_per_step=window / steps / 1e3, device_busy_ms_per_step=busy / steps / 1e3,
         device_idle_share=(1.0 - busy / window) if kernels and window > 0 else "not measured",
         top_kernels=[dict(name=name[:160], ms_per_step=us / steps / 1e3, launches_per_step=n / steps)
                      for name, (us, n) in top],
         note="profiler overhead lengthens the host side of the window")


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
    ops = layer_operands(data, torch.Generator().manual_seed(SEED + 1))
    worst = check_kernels(data, ops)
    main_run = run_main_path(data)
    train_run = run_training(data)
    rows = time_everything(data, ops, main_run, train_run)
    profile_train_steps(train_run)

    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[name],
             launches=train_run["launches"][name], launches_per_train_step=train_run["launches"][name] / TRAIN_STEPS,
             launches_inference=main_run["launches"][name], max_abs_err=worst[name], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound"][0], bound_by=row["bound"][1],
             library_ms=row["library_ms"])
        for name, row in rows.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
