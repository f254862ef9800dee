"""The CUDA source of the port's kernels (the fused GCN layer, K2 — fp32 and
its bf16-operand instantiations —, the ragged block-sparse product, K1,
DeepFM's FM interaction, K3, and the LM's flash attention, K4), run on the
CPU.

A CUDA kernel has no interpret mode, so this compiles the device code of
`src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh`,
`src/repro_torch/kernels/csrc/fm_interaction_kernels.cuh` and
`src/repro_torch/kernels/csrc/flash_attention_kernels.cuh` with the host C++
compiler through the stand-ins in `SHIM` below (one host thread per CUDA
thread, a barrier per `__syncthreads`, asynchronous copies that land only
when a wait retires them) and holds its output against the plain PyTorch
versions of `repro_torch.kernels.fused_gcn`, `repro_torch.kernels.bsr_spmm`,
`repro_torch.kernels.fm_interaction` and `repro_torch.kernels.flash_attention`:
the kernels' indexing, staging, copy pipeline, ragged skip, tiling, masks and
epilogues are checked here; their speed and the card's own rounding only on
the card.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.graph.structure import blocked_adjacency
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
from repro_torch.kernels.flash_attention import flash_attention_plain, k4_smem_bytes, k_tiles
from repro_torch.kernels.fm_interaction import fm_interaction_plain, fm_smem_bytes, fm_tile
from repro_torch.kernels.fused_gcn import (
    FF_F_TILE,
    af_layer_plain,
    ff_aggregate_plain,
    ff_transform_plain,
    layer_smem_bytes,
)
from repro_torch.kernels.ref import poison_padding

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
# (vals, x, w) dtypes → suffix of the emulated entry points (as fused_gcn.cu).
SUFFIXES = {(F32, F32, F32): "", (F32, BF16, F32): "_bf16", (BF16, BF16, BF16): "_bf16_all"}
K1_SUFFIXES = {(F32, F32): "", (F32, BF16): "_bf16", (BF16, BF16): "_bf16_all"}   # (vals, Z)

SHIM = r"""
// Host-compiler stand-ins for the CUDA built-ins the port's kernels use, so
// that their device code compiles with g++ and runs on the CPU: one
// std::thread per CUDA thread, std::barrier for __syncthreads(), blocks run
// one after another (so a namespace-scope array can stand in for shared
// memory). Slow and only for small shapes; it checks indexing, staging and
// synchronisation, not speed or the GPU's own floating-point behaviour.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __launch_bounds__(...)

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct alignas(16) float4 {
    float x, y, z, w;
};

// bf16 as its 16 bits, with the conversions of <cuda_bf16.h>: widening is
// exact, and narrowing rounds to nearest even (NaN becomes 0x7FC0), as
// torch's .to(torch.bfloat16) does.
struct __nv_bfloat16 {
    std::uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 h) {
    const std::uint32_t u = std::uint32_t(h.bits) << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    if (std::isnan(f)) return {0x7FC0};
    std::uint32_t u;
    std::memcpy(&u, &f, 4);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return {std::uint16_t(u >> 16)};
}

// A product rounded on its own (never contracted into a fused multiply-add).
inline float __fmul_rn(float a, float b) { return a * b; }

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// The asynchronous copy primitives of <cuda_pipeline.h>. A copy lands only
// when a wait retires its commit group, so a kernel that reads a stage
// before waiting for it reads stale data here too.
struct EmuCopy {
    void* dst;
    const void* src;
    std::size_t size;
};
inline thread_local std::vector<EmuCopy> emu_open_group;
inline thread_local std::deque<std::vector<EmuCopy>> emu_committed;

inline void __pipeline_memcpy_async(void* dst, const void* src, std::size_t size) {
    emu_open_group.push_back({dst, src, size});
}
inline void __pipeline_commit() {
    emu_committed.push_back(std::move(emu_open_group));
    emu_open_group.clear();
}
inline void __pipeline_wait_prior(std::size_t prior) {
    while (emu_committed.size() > prior) {
        for (const EmuCopy& c : emu_committed.front()) std::memcpy(c.dst, c.src, c.size);
        emu_committed.pop_front();
    }
}

// Run `body` as a grid of blocks of `threads` threads each.
template <typename Body>
void emu_launch(dim3 grid, int threads, Body body) {
    blockDim = dim3(threads);
    gridDim = grid;
    for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by);
            std::barrier<> bar(threads);
            emu_block_barrier = &bar;
            std::vector<std::thread> pool;
            pool.reserve(threads);
            for (int t = 0; t < threads; ++t)
                pool.emplace_back([&body, t] { threadIdx = dim3(t); body(); });
            for (auto& th : pool) th.join();
        }
    }
}
"""

# The kernels compiled through SHIM, with the launch geometry of
# fused_gcn.cu, behind a C interface for ctypes.
HARNESS = r"""
// The graph kernels (src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch geometry of
// fused_gcn.cu, behind a C interface for ctypes. Returns 0, or 1 when a launch
// would need more shared memory than the stand-in holds.
#include "shim.h"

#include "fused_gcn_kernels.cuh"

namespace k2 {
alignas(16) float smem[232448 / sizeof(float)];
}

using bf16 = __nv_bfloat16;

template <typename TX, typename TW, typename TZ>
int ff_transform(const void* x, const void* w, void* z, int M, int K, int N) {
    if (k2::xw_smem_bytes() > (long long)sizeof(k2::smem)) return 1;
    dim3 grid((M + k2::TILE - 1) / k2::TILE, (N + k2::NC - 1) / k2::NC);
    emu_launch(grid, k2::THREADS, [&] {
        k2::xw_kernel<TX, TW, TZ>((const TX*)x, (const TW*)w, (TZ*)z, M, K, N);
    });
    return 0;
}

template <typename TV, typename TO>
int ff_aggregate(const void* vals, const int* cols, const int* lens, int R, int T,
                 int n_src_blocks, const void* z, const float* b, void* out,
                 int f_out, int ft, int relu) {
    if (k2::layer_smem_bytes(ft) > (long long)sizeof(k2::smem)) return 1;
    dim3 grid(R, (f_out + ft - 1) / ft);
    emu_launch(grid, k2::THREADS, [&] {
        k2::ragged_layer_kernel<0, TV, TV, float, TO>((const TV*)vals, cols, lens, T, n_src_blocks,
                                                      (const TV*)z, f_out, ft, nullptr, b, (TO*)out,
                                                      f_out, relu);
    });
    return 0;
}

template <typename TV, typename TX, typename TW>
int af_layer(const void* vals, const int* cols, const int* lens, int R, int T,
             int n_src_blocks, const void* x, int f_in, const void* w,
             const float* b, void* out, int f_out, int relu) {
    if (k2::layer_smem_bytes(f_in) > (long long)sizeof(k2::smem)) return 1;
    emu_launch(dim3(R, 1), k2::THREADS, [&] {
        k2::ragged_layer_kernel<1, TV, TX, TW, TX>((const TV*)vals, cols, lens, T, n_src_blocks,
                                                   (const TX*)x, f_in, f_in, (const TW*)w, b,
                                                   (TX*)out, f_out, relu);
    });
    return 0;
}

extern "C" {

// One entry per operand-type combination, suffixed as the launchers of
// fused_gcn.cu: (none) all fp32, _bf16 (fp32 vals, bf16 X, fp32 W),
// _bf16_all (all bf16).
#define EMU_K2(SFX, TV, TX, TW)                                                             \
    int emu_ff_transform##SFX(const void* x, const void* w, void* z, int M, int K, int N) { \
        return ff_transform<TX, TW, TV>(x, w, z, M, K, N);                                  \
    }                                                                                       \
    int emu_ff_aggregate##SFX(const void* vals, const int* cols, const int* lens, int R,    \
                              int T, int n_src_blocks, const void* z, const float* b,       \
                              void* out, int f_out, int ft, int relu) {                     \
        return ff_aggregate<TV, TX>(vals, cols, lens, R, T, n_src_blocks, z, b, out, f_out, \
                                    ft, relu);                                              \
    }                                                                                       \
    int emu_af_layer##SFX(const void* vals, const int* cols, const int* lens, int R, int T, \
                          int n_src_blocks, const void* x, int f_in, const void* w,         \
                          const float* b, void* out, int f_out, int relu) {                 \
        return af_layer<TV, TX, TW>(vals, cols, lens, R, T, n_src_blocks, x, f_in, w, b,    \
                                    out, f_out, relu);                                      \
    }

EMU_K2(, float, float, float)
EMU_K2(_bf16, float, bf16, float)
EMU_K2(_bf16_all, bf16, bf16, bf16)

// K1, one entry per (vals, Z) combination, suffixed as the launchers of
// fused_gcn.cu; the output has Z's type.
#define EMU_K1(SFX, TV, TZ)                                                                     \
    int emu_bsr_spmm##SFX(const void* vals, const int* cols, const int* lens, int R, int T,     \
                          int n_src_blocks, const void* z, void* out, int f, int ft) {          \
        if (k2::kernel_smem_bytes<2, TZ>(ft) > (long long)sizeof(k2::smem)) return 1;           \
        dim3 grid(R, (f + ft - 1) / ft);                                                        \
        emu_launch(grid, k2::THREADS, [&] {                                                     \
            k2::ragged_layer_kernel<2, TV, TZ, float, TZ>((const TV*)vals, cols, lens, T,       \
                                                          n_src_blocks, (const TZ*)z, f, ft,    \
                                                          nullptr, nullptr, (TZ*)out, f, 0);    \
        });                                                                                     \
        return 0;                                                                               \
    }

EMU_K1(, float, float)
EMU_K1(_bf16, float, bf16)
EMU_K1(_bf16_all, bf16, bf16)

long long emu_layer_smem_bytes(int ft) { return k2::layer_smem_bytes(ft); }

}  // extern "C"
"""


# K3 compiled through SHIM, with the launch geometry of fm_interaction.cu.
K3_HARNESS = r"""
// DeepFM's FM interaction (src/repro_torch/kernels/csrc/fm_interaction_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch geometry of
// fm_interaction.cu, behind a C interface for ctypes. Returns 0, 1 when a
// launch would need more shared memory than the stand-in holds, or 2 for a
// shape the tiling refuses.
#include "shim.h"

#include "fm_interaction_kernels.cuh"

namespace k3 {
alignas(16) float smem_dyn[232448 / sizeof(float)];
}

template <typename T>
int emu_fm(const void* emb, void* out, int B, int F, int D) {
    const k3::Tile t = k3::tile_for(F, D);
    if (t.bt < 1 || B < 1) return 2;
    if (k3::smem_bytes(F, D) > (long long)sizeof(k3::smem_dyn)) return 1;
    emu_launch(dim3((B + t.bt - 1) / t.bt), k3::THREADS, [&] {
        k3::fm_interaction_kernel<T>((const T*)emb, (T*)out, B, F, D, t.bt, t.fc);
    });
    return 0;
}

extern "C" {
int emu_fm_interaction(const void* emb, void* out, int B, int F, int D) {
    return emu_fm<float>(emb, out, B, F, D);
}
int emu_fm_interaction_bf16(const void* emb, void* out, int B, int F, int D) {
    return emu_fm<__nv_bfloat16>(emb, out, B, F, D);
}
int emu_fm_tile_examples(int F, int D) { return k3::tile_for(F, D).bt; }
int emu_fm_tile_fields(int F, int D) { return k3::tile_for(F, D).fc; }
long long emu_fm_smem_bytes(int F, int D) { return k3::smem_bytes(F, D); }
}  // extern "C"
"""


# K4 compiled through SHIM, with the launch geometry of flash_attention.cu.
K4_HARNESS = r"""
// The LM's flash attention (src/repro_torch/kernels/csrc/flash_attention_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch geometry of
// flash_attention.cu, behind a C interface for ctypes. Returns 0, 1 when a
// launch would need more shared memory than the stand-in holds, or 2 for a
// shape the kernel refuses.
#include "shim.h"

#include "flash_attention_kernels.cuh"

namespace k4 {
alignas(16) float4 k4_smem[232448 / sizeof(float4)];
}

template <typename T>
int emu_fa(const void* q, const void* k, const void* v, void* out, int BH, int S, int d, int groups,
           int window, int causal, float scale) {
    if (S < 1 || BH < 1 || groups < 1 || BH % groups != 0 || d < 4 || d % 4 != 0 || d > k4::MAX_D) return 2;
    if (k4::smem_bytes(d) > (long long)sizeof(k4::k4_smem)) return 1;
    const unsigned blocks = (unsigned)(BH * ((S + k4::BQ - 1) / k4::BQ));
    emu_launch(dim3(blocks), k4::THREADS, [&] {
        k4::flash_attention_kernel<T>((const T*)q, (const T*)k, (const T*)v, (T*)out, S, d, groups,
                                      k4::clamp_window(window, S), causal, scale);
    });
    return 0;
}

extern "C" {
int emu_flash_attention(const void* q, const void* k, const void* v, void* out, int BH, int S, int d,
                        int groups, int window, int causal, float scale) {
    return emu_fa<float>(q, k, v, out, BH, S, d, groups, window, causal, scale);
}
int emu_flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int BH, int S, int d,
                             int groups, int window, int causal, float scale) {
    return emu_fa<__nv_bfloat16>(q, k, v, out, BH, S, d, groups, window, causal, scale);
}
long long emu_k4_smem_bytes(int d) { return k4::smem_bytes(d); }
void emu_k4_tiles(int q0, int S, int window, int causal, int* begin, int* end) {
    k4::k_tiles(q0, S, k4::clamp_window(window, S), causal, begin, end);
}
}  // extern "C"
"""


def _compile(tmp_path_factory, name: str, harness: str) -> ctypes.CDLL:
    """``harness`` compiled with SHIM by the host compiler into a loaded library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the CUDA source")
    work = tmp_path_factory.mktemp(name)
    (work / "shim.h").write_text(SHIM)
    (work / f"{name}.cpp").write_text(harness)
    lib_path = work / f"lib{name}.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-Wno-unknown-pragmas", "-shared", "-fPIC", "-pthread",
         f"-I{CSRC}", f"-I{work}", str(work / f"{name}.cpp"), "-o", str(lib_path)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    lib = _compile(tmp_path_factory, "fused_gcn_emu", HARNESS)
    P, I = ctypes.c_void_p, ctypes.c_int
    for sfx in SUFFIXES.values():
        getattr(lib, f"emu_ff_transform{sfx}").argtypes = [P, P, P, I, I, I]
        getattr(lib, f"emu_ff_aggregate{sfx}").argtypes = [P, P, P, I, I, I, P, P, P, I, I, I]
        getattr(lib, f"emu_af_layer{sfx}").argtypes = [P, P, P, I, I, I, P, I, P, P, P, I, I]
    for sfx in K1_SUFFIXES.values():
        getattr(lib, f"emu_bsr_spmm{sfx}").argtypes = [P, P, P, I, I, I, P, P, I, I]
    lib.emu_layer_smem_bytes.argtypes = [I]
    lib.emu_layer_smem_bytes.restype = ctypes.c_longlong
    return lib


def _p(t: torch.Tensor) -> int:
    assert t.is_contiguous()
    return t.data_ptr()


def _ff_transform(lib, x, w, z_dtype=F32):
    sfx = SUFFIXES[(z_dtype, x.dtype, w.dtype)]
    z = torch.empty((x.shape[0], w.shape[1]), dtype=z_dtype)
    fn = getattr(lib, f"emu_ff_transform{sfx}")
    assert fn(_p(x), _p(w), _p(z), x.shape[0], x.shape[1], w.shape[1]) == 0
    return z


def _ff_aggregate(lib, vals, cols, lens, z, b, relu, out_dtype=F32):
    sfx = SUFFIXES[(vals.dtype, out_dtype, vals.dtype)]
    R, T = cols.shape
    f_out = z.shape[1]
    out = torch.full((R * 128, f_out), float("nan"), dtype=out_dtype)
    rc = getattr(lib, f"emu_ff_aggregate{sfx}")(
        _p(vals), _p(cols), _p(lens), R, T, z.shape[0] // 128, _p(z), _p(b), _p(out), f_out,
        min(f_out, FF_F_TILE), int(relu))
    assert rc == 0
    return out


def _af_layer(lib, vals, cols, lens, x, w, b, relu):
    sfx = SUFFIXES[(vals.dtype, x.dtype, w.dtype)]
    R, T = cols.shape
    f_in, f_out = w.shape
    out = torch.full((R * 128, f_out), float("nan"), dtype=x.dtype)
    rc = getattr(lib, f"emu_af_layer{sfx}")(
        _p(vals), _p(cols), _p(lens), R, T, x.shape[0] // 128, _p(x), f_in, _p(w), _p(b), _p(out),
        f_out, int(relu))
    assert rc == 0
    return out


def _bsr_spmm(lib, vals, cols, lens, z):
    R, T = cols.shape
    f = z.shape[1]
    out = torch.full((R * 128, f), float("nan"), dtype=z.dtype)
    rc = getattr(lib, f"emu_bsr_spmm{K1_SUFFIXES[(vals.dtype, z.dtype)]}")(
        _p(vals), _p(cols), _p(lens), R, T, z.shape[0] // 128, _p(z), _p(out), f, min(f, FF_F_TILE))
    assert rc == 0
    return out


def _layer_inputs(n, e, d_in, d_out, seed):
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    ba = blocked_adjacency(n, ei, r.standard_normal(e).astype(np.float32))
    vals, cols, lens = ba.arrays(device="cpu")
    x = torch.zeros((ba.n_col_padded, d_in))
    x[:n] = torch.from_numpy(r.standard_normal((n, d_in)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((d_in, d_out)) * 0.2).astype(np.float32))
    b = torch.from_numpy(r.standard_normal(d_out).astype(np.float32))
    return vals, cols, lens, x, w, b


def _close(out, ref, tol=1e-5):
    out, ref = out.float(), ref.float()
    scale = float(ref.abs().max()) + 1e-9
    np.testing.assert_allclose(out.numpy() / scale, ref.numpy() / scale, rtol=tol, atol=tol)


def test_emulated_smem_formula_matches_python(emu):
    for ft in (1, 7, 16, 17, 50, 210, 336):
        assert emu.emu_layer_smem_bytes(ft) == layer_smem_bytes(ft)


@pytest.mark.parametrize("m,k,n", [(256, 50, 7), (128, 5, 16), (384, 70, 33)])
def test_emulated_ff_transform_matches_plain(emu, m, k, n):
    r = np.random.default_rng(m + k + n)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32))
    _close(_ff_transform(emu, x, w), ff_transform_plain(x, w))


@pytest.mark.parametrize("order", ["feature_first", "aggregation_first"])
@pytest.mark.parametrize("relu", [True, False])
def test_emulated_layer_matches_plain(emu, order, relu):
    """n=300 (a tail block of 44 rows), 50 → 7, as the reference's kernel test."""
    vals, cols, lens, x, w, b = _layer_inputs(300, 1500, 50, 7, seed=1)
    if order == "feature_first":
        out = _ff_aggregate(emu, vals, cols, lens, _ff_transform(emu, x, w), b, relu)
        ref = ff_aggregate_plain(vals, cols, lens, ff_transform_plain(x, w), b, relu)
    else:
        out = _af_layer(emu, vals, cols, lens, x, w, b, relu)
        ref = af_layer_plain(vals, cols, lens, x, w, b, relu)
    _close(out, ref)


@pytest.mark.parametrize("d_out", [70, 129])
def test_emulated_ff_aggregate_covers_several_feature_tiles(emu, d_out):
    """More output columns than one aggregation block covers (grid.y > 1)."""
    vals, cols, lens, _, _, _ = _layer_inputs(260, 900, 8, 1, seed=2)
    r = np.random.default_rng(d_out)
    z = torch.from_numpy(r.standard_normal((vals.shape[0] * 128, d_out)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal(d_out).astype(np.float32))
    _close(_ff_aggregate(emu, vals, cols, lens, z, b, True),
           ff_aggregate_plain(vals, cols, lens, z, b, True))


@pytest.mark.parametrize("d_in", [20, 24, 50])
def test_emulated_af_layer_widths(emu, d_in):
    vals, cols, lens, x, w, b = _layer_inputs(300, 1500, d_in, 24, seed=d_in)
    _close(_af_layer(emu, vals, cols, lens, x, w, b, True),
           af_layer_plain(vals, cols, lens, x, w, b, True))


@pytest.mark.parametrize("order", ["feature_first", "aggregation_first"])
def test_emulated_ragged_skip_and_empty_row(emu, order):
    """Padding tiles are NaN and one block-row has no tile: the output stays
    finite, equals the clean plain version, and the empty row is act(b)."""
    vals, cols, lens, x, w, b = _layer_inputs(384, 2500, 20, 9, seed=4)
    lens = lens.clone()
    lens[1] = 0
    lens[2] = max(int(lens[2]) - 1, 1)
    poisoned = poison_padding(vals, lens)
    assert torch.isnan(poisoned).any()
    if order == "feature_first":
        out = _ff_aggregate(emu, poisoned, cols, lens, _ff_transform(emu, x, w), b, True)
        ref = ff_aggregate_plain(vals, cols, lens, ff_transform_plain(x, w), b, True)
    else:
        out = _af_layer(emu, poisoned, cols, lens, x, w, b, True)
        ref = af_layer_plain(vals, cols, lens, x, w, b, True)
    assert torch.isfinite(out).all()
    _close(out, ref)
    torch.testing.assert_close(out[128:256], b.clamp_min(0).expand(128, -1), rtol=0, atol=1e-6)


# ------------------------------------------------------------------------- K1
@pytest.mark.parametrize("f", [7, 16, 50])
def test_emulated_bsr_spmm_matches_plain(emu, f):
    """Ã·Z at several widths, a 44-row tail block, every output row written."""
    vals, cols, lens, _, _, _ = _layer_inputs(300, 1500, 1, 1, seed=f)
    z = torch.from_numpy(np.random.default_rng(f).standard_normal((vals.shape[0] * 128, f)).astype(np.float32))
    _close(_bsr_spmm(emu, vals, cols, lens, z), bsr_spmm_plain(vals, cols, lens, z))


def test_emulated_bsr_spmm_covers_several_feature_tiles(emu):
    vals, cols, lens, _, _, _ = _layer_inputs(260, 900, 1, 1, seed=7)
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((vals.shape[0] * 128, 70)).astype(np.float32))
    _close(_bsr_spmm(emu, vals, cols, lens, z), bsr_spmm_plain(vals, cols, lens, z))


def test_emulated_bsr_spmm_rectangular_z(emu):
    """Z holds more block-rows than the output (the halo tables): tiles
    point into the extra blocks, and those rows are read from there."""
    vals, cols, lens, _, _, _ = _layer_inputs(384, 2500, 1, 1, seed=8)
    R, T = cols.shape
    cols = (cols + R * (torch.arange(T, dtype=torch.int32) % 2)).contiguous()
    z = torch.from_numpy(np.random.default_rng(8).standard_normal((2 * R * 128, 16)).astype(np.float32))
    out = _bsr_spmm(emu, vals, cols, lens, z)
    assert out.shape == (R * 128, 16)
    _close(out, bsr_spmm_plain(vals, cols, lens, z))


def test_emulated_bsr_spmm_ragged_skip_and_empty_row(emu):
    """NaN in every padding tile and one empty block-row: finite output,
    equal to the clean plain version, zeros on the empty row."""
    vals, cols, lens, _, _, _ = _layer_inputs(384, 2500, 1, 1, seed=9)
    lens = lens.clone()
    lens[1] = 0
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((vals.shape[0] * 128, 16)).astype(np.float32))
    out = _bsr_spmm(emu, poison_padding(vals, lens), cols, lens, z)
    assert torch.isfinite(out).all()
    _close(out, bsr_spmm_plain(vals, cols, lens, z))
    assert torch.equal(out[128:256], torch.zeros(128, 16))


# ------------------------------------------------------ K2's bf16-operand mode
BF16_COMBOS = [pytest.param(c, id=sfx.lstrip("_")) for c, sfx in SUFFIXES.items() if sfx]
BF16_TOL = 1e-2   # a bf16 output: one rounding of 2⁻⁸ relative, and the sums' order differs


def test_emulated_bf16_conversions_round_as_torch(emu):
    """The shim's bf16 stand-in narrows as torch does (nearest even, ties
    included) and widens exactly, so the emulated kernels round where the
    card does: Z = X · w with K = 1 is one exact fp32 product of two bf16
    values, narrowed once."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((4096, 1)).astype(np.float32)).to(BF16)
    x[:4, 0] = torch.tensor([1.0 + 2 ** -7, -3.0 - 2 ** -6, 0.0, 2.0 ** -130])
    for wv in (1.0 + 2 ** -7, -1.5 - 2 ** -6, 3.0):
        w = torch.full((1, 1), wv).to(BF16)
        z = _ff_transform(emu, x, w, BF16)
        assert torch.equal(z, (x.float() * w.float()).to(BF16))


@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("m,k,n", [(256, 50, 7), (384, 70, 33)])
def test_emulated_ff_transform_bf16_matches_plain(emu, combo, m, k, n):
    vals_dtype, x_dtype, w_dtype = combo
    r = np.random.default_rng(m + k + n)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32)).to(w_dtype)
    out = _ff_transform(emu, x, w, vals_dtype)
    assert out.dtype == vals_dtype
    _close(out, ff_transform_plain(x, w, vals_dtype), tol=BF16_TOL if vals_dtype == BF16 else 1e-5)


@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("order", ["feature_first", "aggregation_first"])
@pytest.mark.parametrize("relu", [True, False])
def test_emulated_bf16_layer_matches_plain(emu, combo, order, relu):
    """n=300 (a 44-row tail block), 50 → 7, each bf16 combination, both
    orders: the emulated kernels against the plain versions, which round at
    the same points; the output is bf16."""
    vals_dtype, x_dtype, w_dtype = combo
    vals, cols, lens, x, w, b = _layer_inputs(300, 1500, 50, 7, seed=1)
    vals, x, w = vals.to(vals_dtype).contiguous(), x.to(x_dtype), w.to(w_dtype)
    if order == "feature_first":
        z = _ff_transform(emu, x, w, vals_dtype)
        out = _ff_aggregate(emu, vals, cols, lens, z, b, relu, x_dtype)
        ref = ff_aggregate_plain(vals, cols, lens, ff_transform_plain(x, w, vals_dtype), b, relu, x_dtype)
    else:
        out = _af_layer(emu, vals, cols, lens, x, w, b, relu)
        ref = af_layer_plain(vals, cols, lens, x, w, b, relu)
    assert out.dtype == ref.dtype == BF16
    _close(out, ref, tol=BF16_TOL)


@pytest.mark.parametrize("combo", BF16_COMBOS)
def test_emulated_bf16_ragged_skip_and_empty_row(emu, combo):
    """NaN in every padding tile (bf16 NaN too) and an empty block-row:
    finite output, equal to the clean plain version, act(b) on the empty
    row, rounded to bf16."""
    vals_dtype, x_dtype, w_dtype = combo
    vals, cols, lens, x, w, b = _layer_inputs(384, 2500, 16, 9, seed=4)
    lens = lens.clone()
    lens[1] = 0
    poisoned = poison_padding(vals, lens).to(vals_dtype).contiguous()
    vals, x, w = vals.to(vals_dtype).contiguous(), x.to(x_dtype), w.to(w_dtype)
    out = _af_layer(emu, poisoned, cols, lens, x, w, b, True)
    assert torch.isfinite(out.float()).all()
    _close(out, af_layer_plain(vals, cols, lens, x, w, b, True), tol=BF16_TOL)
    assert torch.equal(out[128:256], b.clamp_min(0).to(BF16).expand(128, -1))


def test_emulated_bf16_af_rounds_the_aggregate_to_w_dtype(emu):
    """All-bf16 aggregation-first rounds Ã·X to bf16 before the product
    with W, as the TPU kernel's ``acc.astype(w.dtype)``: on inputs where that
    rounding moves the result, the kernel follows the rounded plain version,
    not the unrounded one."""
    vals, cols, lens, x, w, b = _layer_inputs(256, 1200, 8, 4, seed=12)
    vals, x, w = vals.to(BF16), x.to(BF16), w.to(BF16)
    out = _af_layer(emu, vals, cols, lens, x, w, b, False).float()
    rounded = af_layer_plain(vals, cols, lens, x, w, b, False).float()
    m = bsr_spmm_plain(vals.float(), cols, lens, x.float())          # Ã·X unrounded
    unrounded = (m @ w.float() + b).to(BF16).float()
    assert not torch.equal(rounded, unrounded)
    assert (out - rounded).abs().max() < (out - unrounded).abs().max()


# ------------------------------------------------------------- K1's bf16 mode
K1_BF16 = [pytest.param(c, id=sfx.lstrip("_")) for c, sfx in K1_SUFFIXES.items() if sfx]


def _k1_bf16_rule(out, ref):
    """K1 with a bf16 Z against the plain version, which rounds the running
    sum per tile as the reference does: at least 99 % of the elements
    bit-equal, the rest within one bf16 step of the largest (2⁻⁷ · max);
    the order of the sums inside a tile may flip a rounding."""
    assert out.dtype == ref.dtype == BF16
    out, ref = out.float(), ref.float()
    equal = float((out == ref).float().mean())
    assert equal >= 0.99 and float((out - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max()), equal


@pytest.mark.parametrize("combo", K1_BF16)
@pytest.mark.parametrize("f", [16, 70])
def test_emulated_bsr_spmm_bf16_rounds_per_tile(emu, combo, f):
    """Each bf16 instantiation at two widths (70: two feature tiles), a
    44-row tail block and Z with more block-rows than the output."""
    vals_dtype, z_dtype = combo
    vals, cols, lens, _, _, _ = _layer_inputs(300, 1500, 1, 1, seed=f)
    R, T = cols.shape
    cols = (cols + R * (torch.arange(T, dtype=torch.int32) % 2)).contiguous()
    vals = (0.3 * vals).to(vals_dtype).contiguous()
    z = torch.from_numpy(np.random.default_rng(f).standard_normal((2 * R * 128, f)).astype(np.float32)).to(z_dtype)
    _k1_bf16_rule(_bsr_spmm(emu, vals, cols, lens, z), bsr_spmm_plain(vals, cols, lens, z))


@pytest.mark.parametrize("combo", K1_BF16)
def test_emulated_bsr_spmm_bf16_ragged_skip_and_empty_row(emu, combo):
    """NaN in every padding tile and an empty block-row: finite output, the
    plain version's per-tile rounding, zeros on the empty row."""
    vals_dtype, z_dtype = combo
    vals, cols, lens, _, _, _ = _layer_inputs(384, 2500, 1, 1, seed=9)
    lens = lens.clone()
    lens[1] = 0
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((vals.shape[0] * 128, 16)).astype(np.float32))
    z = z.to(z_dtype)
    out = _bsr_spmm(emu, poison_padding(vals, lens).to(vals_dtype).contiguous(), cols, lens, z)
    assert torch.isfinite(out.float()).all()
    _k1_bf16_rule(out, bsr_spmm_plain(vals.to(vals_dtype), cols, lens, z))
    assert torch.equal(out[128:256], torch.zeros(128, 16, dtype=BF16))


def test_emulated_bsr_spmm_bf16_follows_the_per_tile_sum(emu):
    """On inputs where rounding once at the end gives another result, the
    kernel follows the per-tile rounding: it is bit-equal to the plain
    version far more often than to the round-once sum."""
    vals, cols, lens, _, _, _ = _layer_inputs(256, 2400, 1, 1, seed=13)
    z = torch.from_numpy(np.random.default_rng(13).standard_normal((vals.shape[0] * 128, 16)).astype(np.float32))
    z = z.to(BF16)
    out = _bsr_spmm(emu, vals, cols, lens, z).float()
    per_tile = bsr_spmm_plain(vals, cols, lens, z).float()
    once = bsr_spmm_plain(vals, cols, lens, z.float()).to(BF16).float()
    assert float((out == per_tile).float().mean()) >= 0.99
    assert float((out == once).float().mean()) < 0.95


# ------------------------------------------------------------------------- K3
@pytest.fixture(scope="module")
def emu_k3(tmp_path_factory):
    lib = _compile(tmp_path_factory, "fm_interaction_emu", K3_HARNESS)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("emu_fm_interaction", "emu_fm_interaction_bf16"):
        getattr(lib, name).argtypes = [P, P, I, I, I]
    for name in ("emu_fm_tile_examples", "emu_fm_tile_fields"):
        getattr(lib, name).argtypes = [I, I]
    lib.emu_fm_smem_bytes.argtypes = [I, I]
    lib.emu_fm_smem_bytes.restype = ctypes.c_longlong
    return lib


def _fm(lib, emb):
    B, F, D = emb.shape
    out = torch.full((B,), float("nan"), dtype=emb.dtype)
    name = "emu_fm_interaction" if emb.dtype == F32 else "emu_fm_interaction_bf16"
    assert getattr(lib, name)(_p(emb), _p(out), B, F, D) == 0
    return out


def test_emulated_fm_tiling_matches_python(emu_k3):
    for F, D in ((39, 10), (2, 10), (1, 1), (40, 400), (3, 300), (8, 16), (39, 4096), (1, 257)):
        assert (emu_k3.emu_fm_tile_examples(F, D), emu_k3.emu_fm_tile_fields(F, D)) == fm_tile(F, D)
        assert emu_k3.emu_fm_smem_bytes(F, D) == fm_smem_bytes(F, D) <= 48 * 1024
    assert fm_tile(39, 10) == (25, 39)            # DeepFM: 25 examples (250 of 256 threads), whole rows
    assert fm_tile(40, 400)[1] < 40               # a row wider than the stage goes a chunk at a time


@pytest.mark.parametrize("b,f,d", [(37, 39, 10), (53, 2, 10), (26, 39, 10), (5, 1, 4), (3, 40, 400),
                                   (4, 3, 300)])
def test_emulated_fm_interaction_matches_plain(emu_k3, b, f, d):
    """Odd B (a short last tile), DeepFM's row (F = 39, D = 10), F = 2 and
    F = 1, a row staged a chunk of fields at a time, and D past the block's
    threads; every output written."""
    emb = torch.from_numpy(np.random.default_rng(b * f + d).standard_normal((b, f, d)).astype(np.float32))
    _close(_fm(emu_k3, emb), fm_interaction_plain(emb))


def test_emulated_fm_interaction_bf16(emu_k3):
    """bf16 embeddings: widened as staged, fp32 sums, one rounding at the
    end — the plain version's arithmetic, so within one bf16 step."""
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal((37, 39, 10)).astype(np.float32)).to(BF16)
    out, ref = _fm(emu_k3, emb), fm_interaction_plain(emb)
    assert out.dtype == BF16
    _close(out, ref, tol=2.0 ** -7)


# ------------------------------------------------------------------------- K4
GLOBAL = 2 ** 30          # the LM's global window (repro.models.transformer_lm.GLOBAL_WINDOW)


@pytest.fixture(scope="module")
def emu_k4(tmp_path_factory):
    lib = _compile(tmp_path_factory, "flash_attention_emu", K4_HARNESS)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("emu_flash_attention", "emu_flash_attention_bf16"):
        getattr(lib, name).argtypes = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float]
    lib.emu_k4_smem_bytes.argtypes = [I]
    lib.emu_k4_smem_bytes.restype = ctypes.c_longlong
    lib.emu_k4_tiles.argtypes = [I, I, I, I, P, P]
    return lib


def _flash(lib, q, k, v, window, causal):
    BH, S, d = q.shape
    out = torch.full_like(q, float("nan"))
    name = "emu_flash_attention" if q.dtype == F32 else "emu_flash_attention_bf16"
    rc = getattr(lib, name)(_p(q), _p(k), _p(v), _p(out), BH, S, d, BH // k.shape[0], window, int(causal),
                            d ** -0.5)
    assert rc == 0
    return out


def _qkv(bh, s, d, seed, bh_kv=None, dtype=F32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((bh, s, d)).astype(np.float32)
    k, v = (r.standard_normal((bh_kv or bh, s, d)).astype(np.float32) for _ in range(2))
    return (torch.from_numpy(a).to(dtype) for a in (q, k, v))


def test_emulated_k4_tiling_matches_python(emu_k4):
    """The k-tiles each q-tile visits, and the block's shared memory."""
    begin, end = ctypes.c_int(), ctypes.c_int()
    for S in (1, 63, 64, 130, 4096):
        for q0 in range(0, S, 64):
            for window in (GLOBAL, 1024, 33, 8, 1, 0, -3, -GLOBAL):
                for causal in (True, False):
                    emu_k4.emu_k4_tiles(q0, S, window, int(causal), ctypes.byref(begin), ctypes.byref(end))
                    assert range(begin.value, end.value) == k_tiles(q0, S, window, causal)
    for d in (4, 16, 48, 240, 256):
        assert emu_k4.emu_k4_smem_bytes(d) == k4_smem_bytes(d)
    assert 2 * k4_smem_bytes(240) <= 227 * 1024            # two blocks per SM at gemma3's head width
    assert len(k_tiles(4032, 4096, 1024, True)) == 34      # a local layer's last q-tile: 34 of 128 k-tiles


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("window", [GLOBAL, 8, 0])
@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("s", [1, 63, 130])
def test_emulated_flash_attention_matches_plain(emu_k4, s, d, window, causal):
    """Any S (a single row, a short tile, a ragged third q-tile), both
    widths, the global and a sliding window, window 0 (causal: no valid key,
    every row averages v), with and without the causal mask."""
    q, k, v = _qkv(2, s, d, seed=s * d + window % 97 + causal)
    out = _flash(emu_k4, q, k, v, window, causal)
    _close(out, flash_attention_plain(q, k, v, window=window, causal=causal))


@pytest.mark.parametrize("window", [GLOBAL, 8, 0])
@pytest.mark.parametrize("s", [63, 130])
def test_emulated_flash_attention_bf16(emu_k4, s, window):
    """bf16 q, k, v: widened as staged, fp32 inside, one rounding at the end
    — the plain version's arithmetic, so within one bf16 step of the largest
    value and nearly always bit-equal."""
    q, k, v = _qkv(2, s, 48, seed=s + window % 97, dtype=BF16)
    out = _flash(emu_k4, q, k, v, window, True)
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == BF16
    _close(out, ref, tol=2.0 ** -7)
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.parametrize("window", [GLOBAL, 8])
def test_emulated_flash_attention_groups_kv_heads(emu_k4, window):
    """Grouped-query attention: 6 query rows over 3 key/value rows (G = 2)
    equal the same call on k and v expanded per group, bit for bit, and the
    plain version."""
    q, k, v = _qkv(6, 130, 16, seed=window % 97, bh_kv=3)
    out = _flash(emu_k4, q, k, v, window, True)
    expanded = _flash(emu_k4, q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0), window, True)
    assert torch.equal(out, expanded)
    _close(out, flash_attention_plain(q, k, v, window=window))
