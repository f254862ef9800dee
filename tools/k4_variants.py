#!/usr/bin/env python3
"""Build variants of K4's CUDA source and time each on one card, to show
what each part of the design costs.

    python3 tools/k4_variants.py [--only NAME ...] [--seq 4096] [--reps 10]

Each variant is the shipped source (`src/repro_torch/kernels/csrc/`) with
a few text substitutions in ``flash_attention_kernels.cuh`` (below),
copied under ``src/repro_torch/kernels/build/variants/`` (git-ignored),
compiled by ``nvcc`` side by side, loaded with ctypes and launched at
gemma3-12b's attention shape (16 query heads over 8 kv heads × S × 240,
the global and the local window, fp32 and bf16). Prints the card's name
and power limit, each variant's registers and spills, then one JSON line
per (variant, dtype, window): CUDA-event median ms, max |out − plain| over
max |plain|, and the share of outputs bit-equal to the plain version.
Variants that drop work (``f32_no_*``) are wrong on purpose: they time
what remains. Needs a card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
KERNELS = "flash_attention_kernels.cuh"

# name → [(old, new), ...] in flash_attention_kernels.cuh
VARIANTS = {
    "shipped": [],
    # bf16: P·V with p rounded to one bf16 (the usual FlashAttention-2 design)
    "bf16_no_p_lo": [
        ("                mma_bf16_16816(acc[2 * np], lo, b[0], b[1]);\n", ""),
        ("                mma_bf16_16816(acc[2 * np + 1], lo, b[2], b[3]);\n", ""),
    ],
    # bf16: __expf (ex2.approx) in place of the accurate expf
    "bf16_fast_exp": [
        ("                s[n][2 * h] = expf(s[n][2 * h] - mx);\n                s[n][2 * h + 1] = expf(s[n][2 * h + 1] - mx);",
         "                s[n][2 * h] = __expf(s[n][2 * h] - mx);\n                s[n][2 * h + 1] = __expf(s[n][2 * h + 1] - mx);"),
    ],
    # bf16: 128-row blocks of 8 warps, one block an SM
    "bf16_bq128": [
        ("constexpr int BF16_THREADS = 128;\nconstexpr int BF16_BQ = 64;",
         "constexpr int BF16_THREADS = 256;\nconstexpr int BF16_BQ = 128;"),
        ("__global__ void __launch_bounds__(BF16_THREADS, 2)", "__global__ void __launch_bounds__(BF16_THREADS, 1)"),
    ],
    # bf16: 32-key tiles
    "bf16_bk32": [("constexpr int BF16_BK = 64;", "constexpr int BF16_BK = 32;")],
    # fp32: the Q·Kᵀ FMAs dropped (its reads stay)
    "f32_no_qk_fma": [
        ("                    s[r][c] = fmaf(a.w, b[c].w, fmaf(a.z, b[c].z, fmaf(a.y, b[c].y, fmaf(a.x, b[c].x, s[r][c]))));",
         "                    s[r][c] += 0.0f * a.x * b[c].x;"),
    ],
    # fp32: P·V as the first design wrote it: each V read guarded by the lane's
    # columns lying inside d, and consumed by its FMAs before the next is issued
    "f32_guarded_pv": [
        ("""            float4 w[8];
#pragma unroll
            for (int m = 0; m < 8; ++m) w[m] = *reinterpret_cast<const float4*>(v_cols + j * dp + 32 * m);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    acc[r][m].x = fmaf(pr[r], w[m].x, acc[r][m].x);
                    acc[r][m].y = fmaf(pr[r], w[m].y, acc[r][m].y);
                    acc[r][m].z = fmaf(pr[r], w[m].z, acc[r][m].z);
                    acc[r][m].w = fmaf(pr[r], w[m].w, acc[r][m].w);
                }""",
         """            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                if (kl + 8 * m < d4) {
                    const float4 w = *reinterpret_cast<const float4*>(v_cols + j * dp + 32 * m);
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        acc[r][m].x += pr[r] * w.x;
                        acc[r][m].y += pr[r] * w.y;
                        acc[r][m].z += pr[r] * w.z;
                        acc[r][m].w += pr[r] * w.w;
                    }
                }
            }"""),
    ],
}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    out_dir = SRC / "repro_torch" / "kernels" / "build" / "variants"
    procs = {}
    for name in names:
        vdir = out_dir / name
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(SRC / "repro_torch" / "kernels" / "csrc", vdir)
        text = (vdir / KERNELS).read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"k4_variants: variant {name!r} no longer matches the source")
            text = text.replace(old, new)
        (vdir / KERNELS).write_text(text)
        lib = vdir / f"lib{name}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(lib), str(vdir / "flash_attention.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: nvcc failed on {name}:\n{out}")
        report = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps(dict(variant=name, ptxas=report)), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in ("k4_flash_attention", "k4_flash_attention_bf16"):
            getattr(libs[name], fn).argtypes = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float, P]
    return libs


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS), default=None)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import flash_attention_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    libs = build(args.only or list(VARIANTS))
    H, HK, D, S = 16, 8, 240, args.seq
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((n, S, D), generator=gen, device="cuda") for n in (H, HK, HK))
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            for window in (2 ** 30, 1024):
                ref = flash_attention_plain(qd, kd, vd, window=window)
                scale = float(ref.float().abs().max())
                for name, lib in libs.items():
                    fn = getattr(lib, "k4_flash_attention" if dtype == torch.float32 else "k4_flash_attention_bf16")
                    out = torch.empty_like(qd)

                    def call():
                        err = fn(qd.data_ptr(), kd.data_ptr(), vd.data_ptr(), out.data_ptr(), H, S, D, H // HK,
                                 min(window, S), 1, D ** -0.5, stream)
                        if err:
                            raise SystemExit(f"k4_variants: {name} returned CUDA error {err}")

                    ms = cuda_ms(call, args.reps)
                    print(json.dumps(dict(
                        variant=name, dtype=str(dtype).replace("torch.", ""), window=window, S=S, ms=ms,
                        max_abs_err_rel=float((out.float() - ref.float()).abs().max()) / scale,
                        bit_equal=float((out == ref).float().mean()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
