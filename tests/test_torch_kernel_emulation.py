"""The CUDA source of the graph kernels (the fused GCN layer, K2 — fp32 and
its bf16-operand instantiations — and the ragged block-sparse product, K1),
run on the CPU.

A CUDA kernel has no interpret mode, so this compiles the device code of
`src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh` with the host C++
compiler through the stand-ins in `SHIM` below (one host thread per CUDA
thread, a barrier per `__syncthreads`, asynchronous copies that land only
when a wait retires them) and holds its output against the plain PyTorch
versions of `repro_torch.kernels.fused_gcn` and `repro_torch.kernels.bsr_spmm`:
the kernels' indexing, staging,
copy pipeline, ragged skip and epilogues are checked here; their speed and
the card's own rounding only on the card.
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

int emu_bsr_spmm(const float* vals, const int* cols, const int* lens, int R, int T,
                 int n_src_blocks, const float* z, float* out, int f, int ft) {
    if (k2::layer_smem_bytes(ft) > (long long)sizeof(k2::smem)) return 1;
    dim3 grid(R, (f + ft - 1) / ft);
    emu_launch(grid, k2::THREADS, [&] {
        k2::ragged_layer_kernel<2, float, float, float, float>(vals, cols, lens, T, n_src_blocks, z,
                                                               f, ft, nullptr, nullptr, out, f, 0);
    });
    return 0;
}

long long emu_layer_smem_bytes(int ft) { return k2::layer_smem_bytes(ft); }

}  // extern "C"
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the CUDA source")
    work = tmp_path_factory.mktemp("emu")
    (work / "shim.h").write_text(SHIM)
    (work / "fused_gcn_emu.cpp").write_text(HARNESS)
    lib_path = work / "libfused_gcn_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-Wno-unknown-pragmas", "-shared", "-fPIC", "-pthread",
         f"-I{CSRC}", f"-I{work}", str(work / "fused_gcn_emu.cpp"), "-o", str(lib_path)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for sfx in SUFFIXES.values():
        getattr(lib, f"emu_ff_transform{sfx}").argtypes = [P, P, P, I, I, I]
        getattr(lib, f"emu_ff_aggregate{sfx}").argtypes = [P, P, P, I, I, I, P, P, P, I, I, I]
        getattr(lib, f"emu_af_layer{sfx}").argtypes = [P, P, P, I, I, I, P, I, P, P, P, I, I]
    lib.emu_bsr_spmm.argtypes = [P, P, P, I, I, I, P, P, I, I]
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
    out = torch.full((R * 128, f), float("nan"))
    rc = lib.emu_bsr_spmm(_p(vals), _p(cols), _p(lens), R, T, z.shape[0] // 128, _p(z), _p(out),
                          f, min(f, FF_F_TILE))
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
