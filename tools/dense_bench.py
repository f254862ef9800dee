#!/usr/bin/env python3
"""Time the dense kernels — K2's transform (`ff_transform`, Z = X · W) and K3
(`fm_interaction`) — on one CUDA card at the shapes of their main paths:

- the transform at Nell's layer 1 (Table I: X 65,792 × 5,414, W 5,414 × 16),
  fp32; and at rank 0 of the 4-rank halo plan (X 18,048 × 5,414) with a
  bf16 X and fp32 W (``_bf16``) and all bf16 (``_bf16_all``);
- K3 at DeepFM's shapes (39 fields × 10): serve_p99 (512), train_batch
  (65,536), serve_bulk (262,144), fp32, and train_batch in bf16.

    python3 tools/dense_bench.py [--src DIR] [--variant NAME] [--reps 20] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be timed on one card in
one call, in turns (parent, change, change, parent). ``--variant`` times a
copy of that package with the text substitutions of `VARIANTS` made in its
CUDA source (built under ``kernels/build/variants/``, git-ignored), to show
what a part of the design costs. Prints the card's name and power limit, the
compiler's report of the dense kernels when this run built them, then one
JSON line per case: ``ms``, one call's time on the card (``--reps`` calls
queued behind a spin kernel, back to back between two CUDA events, after
two warm-ups, over ``--reps``); ``call_ms``, the CUDA-event median of one
call, which also holds the host's time to reach the launch (what
`chip_smoke.py`'s rows measured before PR 20); the bound (each input element once and each
output once at 3.35 TB/s, or the operations at 67 TFLOP/s fp32 — 989 TFLOP/s
for the all-bf16 transform —, whichever is larger); the library call's
device time where one PyTorch call computes the same function (``torch.mm``
for the transform; none for K3); and the largest difference from the plain
version relative to its largest magnitude, whether two calls gave the same
bits, and for a bf16 output the share of elements bit-equal to the plain
version. Operands are random from a seed. Needs a card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S, FP32_FLOP_PER_S, BF16_FLOP_PER_S = 3.35e12, 67e12, 989e12
SEED, F_IN, HIDDEN = 0, 5_414, 16
NELL_ROWS, RANK0_ROWS = 65_792, 18_048          # Nell's 514 block-rows; rank 0's 141 of the halo plan
FIELDS, EMBED = 39, 10                           # DeepFM FULL
K3_BATCHES = {"serve_p99": 512, "train_batch": 65_536, "serve_bulk": 262_144}


# name → [(file under kernels/csrc, old text, new text), ...]
VARIANTS = {
    "shipped": [],
    # the transform's copies and ring alone, its arithmetic dropped (wrong on purpose: times the stream)
    "xw_stream_only": [("xw_kernel.cuh",
                        "    if constexpr (!is_f32<TX>::value && !is_f32<TW>::value) "
                        "xw_chunk_mma<ROWS, READ>(xs, ws, s0, pm, acc, lane);\n"
                        "    else xw_chunk_fma<TX, ROWS, READ>(xs, ws, s0, pm, acc, lane);",
                        "    acc[0] += reinterpret_cast<const float*>(xs)[lane];")],
    # other pass geometries: rows of a pass and chunks of the ring, fp32 : bf16
    "xw_rows48_s3_fp32": [("xw_kernel.cuh", "return x_bytes == 4 ? 64 : 48;", "return x_bytes == 4 ? 48 : 48;"),
                          ("xw_kernel.cuh", "return x_bytes == 4 ? 2 : 3;", "return x_bytes == 4 ? 3 : 3;")],
    "xw_rows64_s2_bf16": [("xw_kernel.cuh", "return x_bytes == 4 ? 64 : 48;", "return x_bytes == 4 ? 64 : 64;"),
                          ("xw_kernel.cuh", "return x_bytes == 4 ? 2 : 3;", "return x_bytes == 4 ? 2 : 2;")],
    "xw_rows32_s4": [("xw_kernel.cuh", "return x_bytes == 4 ? 64 : 48;", "return x_bytes == 4 ? 32 : 32;"),
                     ("xw_kernel.cuh", "return x_bytes == 4 ? 2 : 3;", "return x_bytes == 4 ? 4 : 4;")],
    # K3: tiles of two passes of the block (32 examples at DeepFM's widths)
    "k3_two_passes": [("fm_interaction_kernels.cuh", "long long bt = THREADS / lanes_per_example(D);",
                       "long long bt = 2 * THREADS / lanes_per_example(D);")],
}


def variant_src(src: str, name: str) -> str:
    """A copy of ``src``'s package with variant ``name``'s substitutions, under
    its ``kernels/build/variants/``; returns the copy's ``src`` directory."""
    pkg = pathlib.Path(src) / "repro_torch"
    root = pkg / "kernels" / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(pkg, root / "repro_torch", ignore=shutil.ignore_patterns("build", "__pycache__"))
    for file, old, new in VARIANTS[name]:
        path = root / "repro_torch" / "kernels" / "csrc" / file
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"dense_bench: variant {name}: {old!r} not found in {file}")
        path.write_text(text.replace(old, new))
    return str(root)


SPIN_CYCLES, SPIN_MS = 10_000_000, 5.0   # the spin: 10 M cycles, at least 5 ms at the H100's ≤ 1.98 GHz


def device_ms(fn, reps: int) -> float:
    """One call's time on the card without the host's launch time: a spin
    kernel holds the stream while the host queues ``reps`` calls between two
    CUDA events; elapsed over ``reps``. Exits if queueing outlasted the spin."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if queued_ms > 0.8 * SPIN_MS:
        raise SystemExit(f"dense_bench: queueing {reps} calls took {queued_ms:.2f} ms, past the spin")
    return start.elapsed_time(end) / reps


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


def bound_ms(n_bytes: float, n_flop: float, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / flop_per_s) * 1e3


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="shipped")
    ap.add_argument("--tag", default="")
    ap.add_argument("--aligned", action="store_true",
                    help="also time the transform at K = 5,416 (a 16-byte-aligned row pitch: 16-byte copies)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_bench: no CUDA device is available", file=sys.stderr)
        return 2
    src = args.src if args.variant == "shipped" else variant_src(args.src, args.variant)
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import fm_interaction as k3
    from repro_torch.kernels import fused_gcn as fg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    reports = _build.build(["fused_gcn", "fm_interaction"])
    for name, report in reports.items():
        # ptxas names each entry function, then its registers and spills: keep the dense kernels'.
        kept, entry = [], None
        for ln in report.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif entry and ("xw_kernel" in entry or "fm_interaction_kernel" in entry) and (
                    "registers" in ln or "spill" in ln):
                kept.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
        print(json.dumps(dict(tag=args.tag, built=name, ptxas=kept)), flush=True)

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    x = torch.randn((NELL_ROWS, F_IN), generator=gen, device=device)
    w = torch.randn((F_IN, HIDDEN), generator=gen, device=device) * (2.0 / (F_IN + HIDDEN)) ** 0.5
    x0 = x[:RANK0_ROWS].to(bf16)
    cases = []
    transforms = [("k2_ff_transform", "nell", x, w, f32), ("k2_ff_transform_bf16", "rank 0", x0, w, f32),
                  ("k2_ff_transform_bf16_all", "rank 0", x0, w.to(bf16), bf16)]
    if args.aligned:
        xa = torch.randn((NELL_ROWS, F_IN + 2), generator=gen, device=device)
        wa = torch.randn((F_IN + 2, HIDDEN), generator=gen, device=device) * (2.0 / (F_IN + HIDDEN)) ** 0.5
        transforms += [("k2_ff_transform", "nell K=5416", xa, wa, f32),
                       ("k2_ff_transform_bf16_all", "rank 0 K=5416", xa[:RANK0_ROWS].to(bf16), wa.to(bf16), bf16)]
    for name, shape, xs, ws, zd in transforms:
        M, K = xs.shape
        rate = BF16_FLOP_PER_S if ws.dtype == bf16 else FP32_FLOP_PER_S
        n_bytes = xs.element_size() * M * K + ws.element_size() * K * HIDDEN + zd.itemsize * M * HIDDEN
        cases.append((name, shape, lambda xs=xs, ws=ws, zd=zd: fg.ff_transform(xs, ws, zd),
                      lambda xs=xs, ws=ws, zd=zd: fg.ff_transform_plain(xs, ws, zd),
                      (lambda xs=xs, ws=ws: torch.mm(xs, ws)) if xs.dtype == ws.dtype else None,
                      bound_ms(n_bytes, 2.0 * M * K * HIDDEN, rate)))
    for shape, batch, dtype in [*((s, b, f32) for s, b in K3_BATCHES.items()), ("train_batch", 65_536, bf16)]:
        emb = torch.randn((batch, FIELDS, EMBED), generator=gen, device=device).to(dtype)
        n = batch * FIELDS * EMBED
        cases.append(("k3_fm_interaction" + ("_bf16" if dtype == bf16 else ""), shape,
                      lambda emb=emb: k3.fm_interaction(emb), lambda emb=emb: k3.fm_interaction_plain(emb), None,
                      bound_ms(emb.element_size() * (n + batch), 3.0 * n + 3.0 * batch * EMBED)))
    with torch.inference_mode():
        for name, shape, fn, plain, library, bound in cases:
            out, again = fn(), fn()
            row = dict(tag=args.tag, src=args.src, variant=args.variant, kernel=name, shape=shape,
                       ms=device_ms(fn, args.reps), call_ms=cuda_ms(fn, args.reps), bound_ms=bound,
                       library_ms=device_ms(library, args.reps) if library else None,
                       max_rel_err=rel_err(out, plain()), same_bits=bool(torch.equal(out, again)))
            if out.dtype == bf16:
                row["bit_equal"] = float((out == plain()).float().mean())
            print(json.dumps(row), flush=True)
            del out, again
    return 0


if __name__ == "__main__":
    sys.exit(main())
