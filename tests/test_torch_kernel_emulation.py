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
the card. The ragged kernels (K1, K2's aggregations) run their split
schedule here on small grids, so that block-rows split over blocks; the
shim's atomics and fences stand in for the card's, and blocks can run in a
seeded order, to show that the result does not depend on which block
finishes a row.
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
from repro_torch.kernels.flash_attention import (
    K4_BLOCK_ROWS,
    K4_THREADS,
    K4_TILE_KEYS,
    flash_attention_plain,
    k4_smem_bytes,
    k_tiles,
)
from repro_torch.kernels.fm_interaction import fm_interaction_plain, fm_smem_bytes, fm_tile
from repro_torch.kernels.fused_gcn import (
    FF_F_TILE,
    MIN_TILES,
    af_chunk,
    af_layer_plain,
    ff_aggregate_plain,
    ff_transform_plain,
    layer_smem_bytes,
    ragged_split,
    xw_blocks,
    xw_smem_bytes,
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
// std::thread per CUDA thread, std::barrier for __syncthreads() and for each
// warp (warp shuffles exchange through per-thread slots), blocks run one
// after another (so a namespace-scope array can stand in for shared
// memory). Slow and only for small shapes; it checks indexing, staging and
// synchronisation, not speed or the GPU's own floating-point behaviour.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <random>
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
struct alignas(8) float2 {
    float x, y;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

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
inline std::uint16_t __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }

// A product rounded on its own (never contracted into a fused multiply-add),
// and the other correctly rounded fp32 operations (the host compiler here
// emits no fused multiply-add: no -march).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short u) { return {u}; }

struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }

// The bits of a float as an unsigned int, and back.
inline unsigned __float_as_uint(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// __syncthreads_or: a barrier that returns nonzero when any thread's
// predicate is nonzero.
inline std::atomic<int> emu_or_flag{0};
inline int __syncthreads_or(int pred) {
    __syncthreads();
    if (threadIdx.x == 0) emu_or_flag = 0;
    __syncthreads();
    if (pred) emu_or_flag = 1;
    __syncthreads();
    const int any = emu_or_flag;
    __syncthreads();
    return any;
}

// Device-scope atomics, fences and loads that bypass L1. Blocks run one
// after another here, so a block sees every earlier block's writes; the
// block order may be permuted (emu_block_order_seed) to show that a result
// does not depend on it.
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_add(v); }
inline unsigned atomicMax(unsigned* p, unsigned v) {
    std::atomic_ref<unsigned> a(*p);
    unsigned old = a.load();
    while (old < v && !a.compare_exchange_weak(old, v)) {
    }
    return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline unsigned __ldcg(const unsigned* p) { return std::atomic_ref<const unsigned>(*p).load(); }

// Warps: the block's threads in groups of 32, each with a barrier and one
// exchange slot per thread, for the warp-collective stand-ins.
struct alignas(16) EmuSlot {
    unsigned char bytes[64];
};
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<EmuSlot> emu_slots;
inline int emu_lane() { return int(threadIdx.x % 32); }
inline int emu_warp() { return int(threadIdx.x / 32); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barriers[emu_warp()]->arrive_and_wait(); }

// Put v in this lane's slot, wait for the whole warp, and return the warp's
// 32 slots; the caller reads them and then calls __syncwarp() before any
// slot is written again.
template <typename T>
inline const EmuSlot* emu_warp_publish(const T& v) {
    static_assert(sizeof(T) <= sizeof(EmuSlot), "slot too small");
    std::memcpy(emu_slots[threadIdx.x].bytes, &v, sizeof(T));
    __syncwarp();
    return &emu_slots[emu_warp() * 32];
}

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
    const EmuSlot* slots = emu_warp_publish(v);
    T r;
    std::memcpy(&r, slots[emu_lane() ^ lane_mask].bytes, sizeof(T));
    __syncwarp();
    return r;
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
    const EmuSlot* slots = emu_warp_publish(v);
    T r;
    std::memcpy(&r, slots[src_lane].bytes, sizeof(T));
    __syncwarp();
    return r;
}

// The lanes of this warp (32, or fewer in a block's last warp).
inline int emu_warp_lanes() { return std::min(32, int(blockDim.x) - 32 * emu_warp()); }

// Every lane of the warp calls these (the port's kernels call them in
// converged code only); the mask argument is not read.
inline unsigned __ballot_sync(unsigned, int pred) {
    const EmuSlot* slots = emu_warp_publish(int(pred != 0));
    unsigned m = 0;
    for (int l = 0; l < emu_warp_lanes(); ++l) {
        int v;
        std::memcpy(&v, slots[l].bytes, sizeof(int));
        if (v) m |= 1u << l;
    }
    __syncwarp();
    return m;
}
inline unsigned __match_any_sync(unsigned, unsigned value) {
    const EmuSlot* slots = emu_warp_publish(value);
    unsigned m = 0;
    for (int l = 0; l < emu_warp_lanes(); ++l) {
        unsigned v;
        std::memcpy(&v, slots[l].bytes, sizeof(unsigned));
        if (v == value) m |= 1u << l;
    }
    __syncwarp();
    return m;
}

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

// The order blocks run in: 0 is index order (x fastest), anything else
// seeds a permutation of the grid's blocks.
inline unsigned emu_block_order_seed = 0;

// Run `body` as a grid of blocks of `threads` threads each.
template <typename Body>
void emu_launch(dim3 grid, int threads, Body body) {
    blockDim = dim3(threads);
    gridDim = grid;
    std::vector<dim3> order;
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) order.push_back(dim3(bx, by));
    if (emu_block_order_seed) {
        std::mt19937 rng(emu_block_order_seed);
        std::shuffle(order.begin(), order.end(), rng);
    }
    for (const dim3& blk : order) {
        blockIdx = blk;
        std::barrier<> bar(threads);
        emu_block_barrier = &bar;
        emu_slots.assign(threads, EmuSlot{});
        emu_warp_barriers.clear();
        for (int w = 0; w < (threads + 31) / 32; ++w)
            emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
        std::vector<std::thread> pool;
        pool.reserve(threads);
        for (int t = 0; t < threads; ++t)
            pool.emplace_back([&body, t] { threadIdx = dim3(t); body(); });
        for (auto& th : pool) th.join();
    }
}
"""

# Host-compiler stand-ins for the PTX wrappers of ptx.cuh (namespace ptx),
# with the PTX ISA's fragment layouts; shared by every harness below.
PTX_STANDINS = r"""
#pragma once
// Stand-ins for ptx.cuh, with the PTX ISA's fragment layouts.
namespace ptx {

// cp.async: the copy lands when a wait retires its group (shim.h); with
// fill false it lands as zeros.
template <int BYTES>
inline void cp_async(void* dst, const void* src, bool fill) {
    static const unsigned char zeros[16] = {};
    emu_open_group.push_back({dst, fill ? src : zeros, std::size_t(BYTES)});
}
inline void cp_async_commit() { __pipeline_commit(); }
inline void cp_async_wait_all() {
    __pipeline_commit();
    __pipeline_wait_prior(0);
}
template <int N>
inline void cp_async_wait_group() { __pipeline_wait_prior(N); }
// 16-byte cp.async of n source bytes: the other 16 − n land as zeros.
inline void cp_async_16(void* dst, const void* src, int n) {
    static const unsigned char zeros[16] = {};
    emu_open_group.push_back({dst, src, std::size_t(n)});
    emu_open_group.push_back({static_cast<unsigned char*>(dst) + n, zeros, std::size_t(16 - n)});
}

// ldmatrix .x4: lanes 8i .. 8i+7 give the rows of matrix i; register i of
// lane l holds row l / 4, elements 2(l % 4), 2(l % 4) + 1 (.trans: the
// elements [2(l % 4)][l / 4] and [2(l % 4) + 1][l / 4]), lower in the lower half.
inline void emu_ldmatrix(unsigned r[4], const void* p, bool trans) {
    const EmuSlot* slots = emu_warp_publish(p);
    const int lane = emu_lane();
    for (int i = 0; i < 4; ++i) {
        std::uint16_t e[2];
        for (int h = 0; h < 2; ++h) {
            const int row = trans ? 2 * (lane % 4) + h : lane / 4;
            const int col = trans ? lane / 4 : 2 * (lane % 4) + h;
            const void* row_ptr;
            std::memcpy(&row_ptr, slots[8 * i + row].bytes, sizeof(row_ptr));
            e[h] = static_cast<const std::uint16_t*>(row_ptr)[col];
        }
        r[i] = unsigned(e[0]) | (unsigned(e[1]) << 16);
    }
    __syncwarp();
}
inline void ldmatrix_x4(unsigned r[4], const void* p) { emu_ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(unsigned r[4], const void* p) { emu_ldmatrix(r, p, true); }

inline float emu_half(unsigned packed, int h) { return __bfloat162float({std::uint16_t(packed >> (16 * h))}); }

// mma.sync m16n8k16 (bf16 A row-major, bf16 B column-major, fp32 C): the
// warp's fragments gathered into A (16 × 16) and B (16 × 8), then each lane's
// four outputs c += A[row] · B[:, col] in fp32.
struct EmuMmaIn {
    unsigned a[4], b[2];
};
inline void mma_bf16_16816(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
    const EmuSlot* slots = emu_warp_publish(EmuMmaIn{{a[0], a[1], a[2], a[3]}, {b0, b1}});
    float A[16][16], B[16][8];
    for (int l = 0; l < 32; ++l) {
        EmuMmaIn x;
        std::memcpy(&x, slots[l].bytes, sizeof(x));
        const int g = l / 4, t = l % 4;
        for (int h = 0; h < 2; ++h) {
            A[g][2 * t + h] = emu_half(x.a[0], h);
            A[g + 8][2 * t + h] = emu_half(x.a[1], h);
            A[g][2 * t + 8 + h] = emu_half(x.a[2], h);
            A[g + 8][2 * t + 8 + h] = emu_half(x.a[3], h);
            B[2 * t + h][g] = emu_half(x.b[0], h);
            B[2 * t + 8 + h][g] = emu_half(x.b[1], h);
        }
    }
    __syncwarp();
    const int g = emu_lane() / 4, t = emu_lane() % 4;
    for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2), col = 2 * t + e % 2;
        float sum = c[e];
        for (int kk = 0; kk < 16; ++kk) sum += A[row][kk] * B[kk][col];
        c[e] = sum;
    }
}

}  // namespace ptx
"""


# The kernels compiled through SHIM, with the launch geometry of
# fused_gcn.cu, behind a C interface for ctypes.
HARNESS = r"""
// The graph kernels (src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch geometry of
// fused_gcn.cu, behind a C interface for ctypes. Returns 0, or 1 when a launch
// would need more shared memory than the stand-in holds.
#include "shim.h"
#include "ptx.h"

#include "fused_gcn_kernels.cuh"
#include "xw_kernel.cuh"

#include <cstdint>

namespace k2 {
alignas(16) float smem[232448 / sizeof(float)];
alignas(16) float4 xw_smem[232448 / sizeof(float4)];
}

using bf16 = __nv_bfloat16;

// The copy width and read width fused_gcn.cu's xw_piece and xw_read pick.
int xw_piece(const void* base, long long pitch) {
    const unsigned long long a = (unsigned long long)reinterpret_cast<std::uintptr_t>(base) | (unsigned long long)pitch;
    for (int p = 16; p > 2; p /= 2)
        if (a % p == 0) return p;
    return 2;
}
int xw_read(const void* x, long long pitch) {
    if (reinterpret_cast<std::uintptr_t>(x) % 16 != 0) return 0;
    return pitch % 16 == 0 ? 16 : pitch % 8 == 0 ? 8 : pitch % 4 == 0 ? 4 : 0;
}

// The transform on a grid of `blocks` blocks a block column (the launcher's
// k2::xw_blocks for the card's SMs).
template <typename TX, typename TW, typename TZ>
int ff_transform(const void* x, const void* w, void* z, int M, int K, int N, int blocks) {
    if (k2::xw_smem_bytes(sizeof(TX), sizeof(TW)) > (long long)sizeof(k2::xw_smem)) return 1;
    dim3 grid(blocks, (N + k2::NC - 1) / k2::NC);   // blocks ≤ the row groups, as k2::xw_blocks
    const int xp = xw_piece(x, (long long)K * sizeof(TX)), xr = xw_read(x, (long long)K * sizeof(TX));
    const int wp = xw_piece(w, (long long)N * sizeof(TW));
    emu_launch(grid, k2::XW_THREADS, [&] {
        k2::xw_kernel<TX, TW, TZ>((const TX*)x, (const TW*)w, (TZ*)z, M, K, N, xp, xr, wp);
    });
    return 0;
}

// The split schedule's arguments (fused_gcn.cu's SPLIT_ARGS).
#define SPLIT_ARGS int grid_x, int row_weight, int min_tiles, float *part, int *arrivals, unsigned short *prods
#define SPLIT_PASS row_weight, min_tiles, part, arrivals, prods

template <typename TV, typename TO>
int ff_aggregate(const void* vals, const int* cols, const int* ends, int R, int T,
                 int n_src_blocks, const void* z, const float* b, void* out,
                 int f_out, int ft, int relu, SPLIT_ARGS) {
    if (k2::kernel_smem_bytes<0, TV, TO>(ft) > (long long)sizeof(k2::smem)) return 1;
    dim3 grid(grid_x, (f_out + ft - 1) / ft);
    emu_launch(grid, k2::THREADS, [&] {
        k2::ragged_layer_kernel<0, TV, TV, float, TO>((const TV*)vals, cols, ends, R, T, n_src_blocks,
                                                      (const TV*)z, f_out, ft, nullptr, b, (TO*)out,
                                                      f_out, relu, SPLIT_PASS, nullptr);
    });
    return 0;
}

// F_in in chunks of ft columns (fused_gcn.cu's af_layer), each block's
// running output sum in osum when f_in > ft.
template <typename TV, typename TX, typename TW>
int af_layer(const void* vals, const int* cols, const int* ends, int R, int T,
             int n_src_blocks, const void* x, int f_in, int ft, const void* w,
             const float* b, void* out, int f_out, int relu, SPLIT_ARGS, float* osum) {
    if (k2::kernel_smem_bytes<1, TX, TX>(ft) > (long long)sizeof(k2::smem)) return 1;
    if (ft < 1 || ft > f_in) return 1;
    if (f_in > ft && (ft % k2::NC || osum == nullptr)) return 1;
    emu_launch(dim3(grid_x, 1), k2::THREADS, [&] {
        k2::ragged_layer_kernel<1, TV, TX, TW, TX>((const TV*)vals, cols, ends, R, T, n_src_blocks,
                                                   (const TX*)x, f_in, ft, (const TW*)w, b,
                                                   (TX*)out, f_out, relu, SPLIT_PASS, osum);
    });
    return 0;
}

extern "C" {

// One entry per operand-type combination, suffixed as the launchers of
// fused_gcn.cu: (none) all fp32, _bf16 (fp32 vals, bf16 X, fp32 W),
// _bf16_all (all bf16).
#define EMU_K2(SFX, TV, TX, TW)                                                             \
    int emu_ff_transform##SFX(const void* x, const void* w, void* z, int M, int K, int N,   \
                              int blocks) {                                                 \
        return ff_transform<TX, TW, TV>(x, w, z, M, K, N, blocks);                          \
    }                                                                                       \
    int emu_ff_aggregate##SFX(const void* vals, const int* cols, const int* ends, int R,    \
                              int T, int n_src_blocks, const void* z, const float* b,       \
                              void* out, int f_out, int ft, int relu, SPLIT_ARGS) {         \
        return ff_aggregate<TV, TX>(vals, cols, ends, R, T, n_src_blocks, z, b, out, f_out, \
                                    ft, relu, grid_x, SPLIT_PASS);                          \
    }                                                                                       \
    int emu_af_layer##SFX(const void* vals, const int* cols, const int* ends, int R, int T, \
                          int n_src_blocks, const void* x, int f_in, int ft, const void* w, \
                          const float* b, void* out, int f_out, int relu, SPLIT_ARGS,       \
                          float* osum) {                                                    \
        return af_layer<TV, TX, TW>(vals, cols, ends, R, T, n_src_blocks, x, f_in, ft, w,   \
                                    b, out, f_out, relu, grid_x, SPLIT_PASS, osum);         \
    }

EMU_K2(, float, float, float)
EMU_K2(_bf16, float, bf16, float)
EMU_K2(_bf16_all, bf16, bf16, bf16)

// K1, one entry per (vals, Z) combination, suffixed as the launchers of
// fused_gcn.cu; the output has Z's type.
#define EMU_K1(SFX, TV, TZ)                                                                     \
    int emu_bsr_spmm##SFX(const void* vals, const int* cols, const int* ends, int R, int T,     \
                          int n_src_blocks, const void* z, void* out, int f, int ft,            \
                          SPLIT_ARGS) {                                                         \
        if (k2::kernel_smem_bytes<2, TZ, TZ>(ft) > (long long)sizeof(k2::smem)) return 1;       \
        dim3 grid(grid_x, (f + ft - 1) / ft);                                                   \
        emu_launch(grid, k2::THREADS, [&] {                                                     \
            k2::ragged_layer_kernel<2, TV, TZ, float, TZ>((const TV*)vals, cols, ends, R, T,    \
                                                          n_src_blocks, (const TZ*)z, f, ft,    \
                                                          nullptr, nullptr, (TZ*)out, f, 0,     \
                                                          SPLIT_PASS, nullptr);                 \
        });                                                                                     \
        return 0;                                                                               \
    }

EMU_K1(, float, float)
EMU_K1(_bf16, float, bf16)
EMU_K1(_bf16_all, bf16, bf16)

int emu_xw_blocks(int M, int sms, int x_bytes) { return k2::xw_blocks(M, sms, x_bytes); }
long long emu_xw_smem_bytes(int x_bytes, int w_bytes) { return k2::xw_smem_bytes(x_bytes, w_bytes); }
long long emu_layer_smem_bytes(int ft) { return k2::layer_smem_bytes(ft); }
long long emu_layer_smem_bytes_bf16(int ft) { return k2::layer_smem_bytes(ft, 2); }
int emu_split_blocks(long long n, int grid, int min_tiles) { return k2::split_blocks(n, grid, min_tiles); }
int emu_owner_block(long long pos, long long n, long long g) { return k2::owner_block(pos, n, g); }
void emu_set_block_order(unsigned seed) { emu_block_order_seed = seed; }

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
#include "ptx.h"

#include "fm_interaction_kernels.cuh"

#include <cstdint>

namespace k3 {
alignas(16) float4 k3_stage[232448 / sizeof(float4)];
}

// A grid of `blocks` blocks (the launcher's one wave, at most the tiles):
// fewer blocks than tiles make each block loop over several tiles.
template <typename T>
int emu_fm(const void* emb, void* out, int B, int F, int D, int blocks) {
    const k3::Tile t = k3::tile_for(B, F, D, (int)sizeof(T));
    if (t.bt < 1) return 2;
    const bool staged = t.staged && reinterpret_cast<std::uintptr_t>(emb) % 16 == 0;
    if (staged && k3::smem_bytes(B, F, D, (int)sizeof(T)) > (long long)sizeof(k3::k3_stage)) return 1;
    const long long tiles = ((long long)B + t.bt - 1) / t.bt;
    emu_launch(dim3((unsigned)(tiles < blocks ? tiles : blocks)), k3::THREADS, [&] {
        k3::fm_interaction_kernel<T>((const T*)emb, (T*)out, B, F, D, t.bt, staged ? 1 : 0);
    });
    return 0;
}

extern "C" {
int emu_fm_interaction(const void* emb, void* out, int B, int F, int D, int blocks) {
    return emu_fm<float>(emb, out, B, F, D, blocks);
}
int emu_fm_interaction_bf16(const void* emb, void* out, int B, int F, int D, int blocks) {
    return emu_fm<__nv_bfloat16>(emb, out, B, F, D, blocks);
}
int emu_fm_tile_examples(int B, int F, int D, int elem) { return k3::tile_for(B, F, D, elem).bt; }
int emu_fm_tile_staged(int B, int F, int D, int elem) { return k3::tile_for(B, F, D, elem).staged ? 1 : 0; }
long long emu_fm_smem_bytes(int B, int F, int D, int elem) { return k3::smem_bytes(B, F, D, elem); }
}  // extern "C"
"""


# K4 compiled through SHIM and PTX_STANDINS, with the launch geometry of
# flash_attention.cu.
K4_HARNESS = r"""
// The LM's flash attention (src/repro_torch/kernels/csrc/flash_attention_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch geometry of
// flash_attention.cu, behind a C interface for ctypes. Returns 0, 1 when a
// launch would need more shared memory than the stand-in holds, or 2 for a
// shape the kernel refuses.
#include "shim.h"
#include "ptx.h"

namespace k4 {
using namespace ptx;
}  // namespace k4

#include "flash_attention_kernels.cuh"

#include <array>
#include <utility>

namespace k4 {
alignas(16) float4 k4_smem[232448 / sizeof(float4)];
}

using Bf16Body = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int,
                          int, int, int, int, int, float);
template <int... N>
constexpr std::array<Bf16Body, sizeof...(N)> bf16_bodies(std::integer_sequence<int, N...>) {
    return {k4::flash_attention_bf16_kernel<N + 1>...};
}
// The bf16 body for each head width in steps of 16 columns, as flash_attention.cu picks it.
constexpr auto BF16_BODIES = bf16_bodies(std::make_integer_sequence<int, k4::MAX_D / 16>{});

template <typename T>
int emu_fa(const void* q, const void* k, const void* v, void* out, int BH, int S, int d, int groups,
           int window, int causal, float scale) {
    constexpr bool bf16 = sizeof(T) == 2;
    if (S < 1 || BH < 1 || groups < 1 || BH % groups != 0 || d < 4 || d % 4 != 0 || d > k4::MAX_D) return 2;
    if (k4::smem_bytes(d, bf16) > (long long)sizeof(k4::k4_smem)) return 1;
    const int bq = k4::block_rows(bf16);
    const unsigned blocks = (unsigned)(BH * ((S + bq - 1) / bq));
    window = k4::clamp_window(window, S);
    emu_launch(dim3(blocks), k4::block_threads(bf16), [&] {
        if constexpr (bf16)
            BF16_BODIES[k4::bf16_width(d) / 16 - 1]((const T*)q, (const T*)k, (const T*)v, (T*)out, BH, S, d,
                                                    groups, window, causal, scale);
        else
            k4::flash_attention_f32_kernel((const T*)q, (const T*)k, (const T*)v, (T*)out, BH, S, d, groups,
                                           window, causal, scale);
    });
    return 0;
}

// One warp: A (16 × 16) times B (16 × 16) in bf16 through the stand-ins,
// with the bf16 body's row addresses: A by ldmatrix_x4 from A row-major (as
// Q), B by ldmatrix_x4 from Bᵀ row-major (as K) into d_k and by
// ldmatrix_x4_trans from B row-major (as V) into d_v, each as two 16 × 8
// products. Rows are padded to 24 elements, as the body pads them. Also
// writes lane l's four A registers to a_frag[4l .. 4l + 3].
extern "C" int emu_mma_check(const std::uint16_t* a, const std::uint16_t* b, float* d_k, float* d_v, unsigned* a_frag) {
    static std::uint16_t as[16][24], bt[16][24], bs[16][24];
    for (int i = 0; i < 16; ++i)
        for (int j = 0; j < 16; ++j) {
            as[i][j] = a[16 * i + j];
            bs[i][j] = b[16 * i + j];
            bt[j][i] = b[16 * i + j];
        }
    emu_launch(dim3(1), 32, [&] {
        const int lane = emu_lane(), g = lane / 4, t = lane % 4;
        unsigned af[4], bf[4];
        k4::ldmatrix_x4(af, &as[lane % 16][(lane / 16) * 8]);
        for (int i = 0; i < 4; ++i) a_frag[4 * lane + i] = af[i];
        for (int trans = 0; trans < 2; ++trans) {
            if (trans)
                k4::ldmatrix_x4_trans(bf, &bs[((lane / 8) % 2) * 8 + lane % 8][(lane / 16) * 8]);
            else
                k4::ldmatrix_x4(bf, &bt[(lane / 16) * 8 + lane % 8][((lane / 8) % 2) * 8]);
            float* dst = trans ? d_v : d_k;
            for (int n = 0; n < 2; ++n) {
                float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                k4::mma_bf16_16816(c, af, bf[2 * n], bf[2 * n + 1]);
                for (int e = 0; e < 4; ++e) dst[16 * (g + 8 * (e / 2)) + 8 * n + 2 * t + e % 2] = c[e];
            }
        }
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
long long emu_k4_smem_bytes(int d, int bf16) { return k4::smem_bytes(d, bf16); }
int emu_k4_block_rows(int bf16) { return k4::block_rows(bf16); }
int emu_k4_tile_keys(int bf16) { return k4::tile_keys(bf16); }
int emu_k4_block_threads(int bf16) { return k4::block_threads(bf16); }
void emu_k4_tiles(int q0, int S, int window, int causal, int bf16, int* begin, int* end) {
    k4::k_tiles(q0, S, k4::clamp_window(window, S), causal, k4::block_rows(bf16), k4::tile_keys(bf16), begin,
                end);
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
    (work / "ptx.h").write_text(PTX_STANDINS)
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
    split = [I, I, I, P, P, P]    # grid_x, row_weight, min_tiles, part, arrivals, prods
    for sfx in SUFFIXES.values():
        getattr(lib, f"emu_ff_transform{sfx}").argtypes = [P, P, P, I, I, I, I]
        getattr(lib, f"emu_ff_aggregate{sfx}").argtypes = [P, P, P, I, I, I, P, P, P, I, I, I, *split]
        getattr(lib, f"emu_af_layer{sfx}").argtypes = [P, P, P, I, I, I, P, I, I, P, P, P, I, I, *split, P]
    for sfx in K1_SUFFIXES.values():
        getattr(lib, f"emu_bsr_spmm{sfx}").argtypes = [P, P, P, I, I, I, P, P, I, I, *split]
    for name in ("emu_layer_smem_bytes", "emu_layer_smem_bytes_bf16"):
        getattr(lib, name).argtypes = [I]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.emu_xw_blocks.argtypes = [I, I, I]
    lib.emu_xw_smem_bytes.argtypes = [I, I]
    lib.emu_xw_smem_bytes.restype = ctypes.c_longlong
    lib.emu_split_blocks.argtypes = [ctypes.c_longlong, I, I]
    lib.emu_owner_block.argtypes = [ctypes.c_longlong] * 3
    lib.emu_set_block_order.argtypes = [ctypes.c_uint]
    return lib


def _p(t: torch.Tensor) -> int:
    assert t.is_contiguous()
    return t.data_ptr()


def _ff_transform(lib, x, w, z_dtype=F32, blocks=None):
    """The emulated transform on ``blocks`` blocks a block column (by default
    as the launcher picks them on an H100: one per 64-row group at these
    sizes; fewer blocks run several groups one after another)."""
    sfx = SUFFIXES[(z_dtype, x.dtype, w.dtype)]
    M, K = x.shape
    N = w.shape[1]
    z = torch.full((M, N), float("nan"), dtype=z_dtype)
    fn = getattr(lib, f"emu_ff_transform{sfx}")
    most = xw_blocks(M, x.dtype)
    assert fn(_p(x), _p(w), _p(z), M, K, N, most if blocks is None else min(blocks, most)) == 0
    return z


# The emulated ragged kernels run the split schedule on a grid of GRID blocks
# taking at least one position each, so that the small tables here split rows.
GRID, SPLIT_MIN = 4, 1


def _split_args(cols, lens, ft, grid_y, grid, row_weight, min_tiles, chunks=1):
    """The ragged launchers' ``ends`` and split arguments, as the wrapper
    builds them (`fused_gcn._split_args`), with the workspace poisoned (NaN
    partials, NaN bf16 products) so that a slot read before it is written
    shows: (the tensors, the ``ends`` pointer, the split arguments)."""
    R, T = cols.shape
    ftp = -(-ft // 16) * 16
    ends = torch.cumsum(lens.clamp(0, T) + row_weight, 0, dtype=torch.int32)
    part = torch.full((2 * grid * grid_y * chunks * 128 * ftp,), float("nan"))
    arrivals = torch.zeros(R * grid_y, dtype=torch.int32)
    prods = torch.full((max(R * (T + row_weight), 1) * grid_y * 128 * ftp,), -1, dtype=torch.int16)  # bf16 NaN
    return (ends, part, arrivals, prods), _p(ends), (grid, row_weight, min_tiles, _p(part), _p(arrivals), _p(prods))


def _ragged_call(lib, name, cols, lens, ft, grid_y, head, grid, row_weight, min_tiles, order, chunks=1, tail=()):
    """One emulated ragged launch: ``head`` is the launcher's arguments
    before the split ones, without ``ends`` (which follows vals and cols),
    ``tail`` those after them; blocks run in the order seeded by ``order``
    (0: index order)."""
    _keep, ends, split = _split_args(cols, lens, ft, grid_y, grid, row_weight, min_tiles, chunks)
    lib.emu_set_block_order(order)
    try:
        rc = getattr(lib, name)(*head[:2], ends, *head[2:], *split, *tail)
    finally:
        lib.emu_set_block_order(0)
    assert rc == 0


def _ff_aggregate(lib, vals, cols, lens, z, b, relu, out_dtype=F32, grid=GRID, min_tiles=SPLIT_MIN, order=0,
                  row_weight=1):
    sfx = SUFFIXES[(vals.dtype, out_dtype, vals.dtype)]
    R, T = cols.shape
    f_out = z.shape[1]
    ft = min(f_out, FF_F_TILE)
    out = torch.full((R * 128, f_out), float("nan"), dtype=out_dtype)
    _ragged_call(lib, f"emu_ff_aggregate{sfx}", cols, lens, ft, -(-f_out // ft),
                 (_p(vals), _p(cols), R, T, z.shape[0] // 128, _p(z), _p(b), _p(out), f_out, ft, int(relu)),
                 grid, row_weight, min_tiles, order)
    return out


def _af_layer(lib, vals, cols, lens, x, w, b, relu, grid=GRID, min_tiles=SPLIT_MIN, order=0, row_weight=1,
              ft=None):
    """The emulated aggregation-first layer, F_in in the wrapper's chunks
    (`af_chunk`) or in chunks of ``ft`` columns, the running output sums
    NaN-poisoned (the first chunk must not read them)."""
    sfx = SUFFIXES[(vals.dtype, x.dtype, w.dtype)]
    R, T = cols.shape
    f_in, f_out = w.shape
    ft, chunks = af_chunk(f_in) if ft is None else (ft, -(-f_in // ft))
    out = torch.full((R * 128, f_out), float("nan"), dtype=x.dtype)
    osum = torch.full((grid * 128 * f_out if chunks > 1 else 1,), float("nan"))
    _ragged_call(lib, f"emu_af_layer{sfx}", cols, lens, ft, 1,
                 (_p(vals), _p(cols), R, T, x.shape[0] // 128, _p(x), f_in, ft, _p(w), _p(b), _p(out), f_out,
                  int(relu)), grid, row_weight, min_tiles, order, chunks, (_p(osum),))
    return out


def _bsr_spmm(lib, vals, cols, lens, z, grid=GRID, min_tiles=SPLIT_MIN, order=0, row_weight=1):
    R, T = cols.shape
    f = z.shape[1]
    ft = min(f, FF_F_TILE)
    out = torch.full((R * 128, f), float("nan"), dtype=z.dtype)
    _ragged_call(lib, f"emu_bsr_spmm{K1_SUFFIXES[(vals.dtype, z.dtype)]}", cols, lens, ft, -(-f // ft),
                 (_p(vals), _p(cols), R, T, z.shape[0] // 128, _p(z), _p(out), f, ft), grid, row_weight, min_tiles,
                 order)
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


ALL_COMBOS = [pytest.param(c, id=sfx.lstrip("_") or "f32") for c, sfx in SUFFIXES.items()]


def _transform_rule(out, ref, vals_dtype):
    """fp32 within 1e-5 of max (the order of the sum differs); all bf16 (the
    tensor cores) within one bf16 step of max and, where the output is large
    enough to count, at least 99 % of the elements bit-equal to the plain
    version, which rounds the same fp32 sums once."""
    if vals_dtype == F32:
        _close(out, ref)
        return
    out, ref = out.float(), ref.float()
    assert float((out - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    if out.numel() >= 1000:
        assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.parametrize("combo", ALL_COMBOS)
@pytest.mark.parametrize("m,k,n,blocks", [
    pytest.param(100, 37, 16, 2, id="odd_k37-short_group"),
    pytest.param(130, 141, 7, 1, id="odd_k141-n7-three_passes"),
    pytest.param(64, 600, 16, 1, id="k600-three_chunks"),
    pytest.param(192, 520, 32, 2, id="k520-n32_two_column_blocks-uneven_passes"),
    pytest.param(70, 136, 33, 2, id="k136-n33"),
])
def test_emulated_ff_transform_modes(emu, combo, m, k, n, blocks):
    """Every instantiation against the plain version: K odd (the row pitch
    4- or 2-byte aligned: 4-byte pieces in fp32, plain 2-byte copies in bf16)
    and even (8- and 16-byte pieces), several 256-value chunks of K with a
    short last one, a short last 64-row group, N < 16, N = 32 and 33 over two
    and three blocks in y, and blocks that run one to three groups one after
    another (2 blocks over 3 groups: one and two)."""
    vals_dtype, x_dtype, w_dtype = combo
    r = np.random.default_rng(m * k + n)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32)).to(w_dtype)
    out = _ff_transform(emu, x, w, vals_dtype, blocks=blocks)
    assert out.dtype == vals_dtype and bool(torch.isfinite(out.float()).all())
    _transform_rule(out, ff_transform_plain(x, w, vals_dtype), vals_dtype)


@pytest.mark.parametrize("combo", ALL_COMBOS)
@pytest.mark.parametrize("k", [37, 141, 138, 300, 5_414])
def test_emulated_ff_transform_unaligned_start(emu, combo, k):
    """X that starts off a 16-byte boundary (a view one row in): copied in the
    widest piece its start and pitch allow, read 16 bytes at a time; beside
    the same rows from an aligned copy (16-byte runs read 4, 8 or 16 bytes at
    a time), bit for bit."""
    vals_dtype, x_dtype, w_dtype = combo
    r = np.random.default_rng(k)
    full = torch.from_numpy(r.standard_normal((71, k)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(r.standard_normal((k, 16)).astype(np.float32)).to(w_dtype)
    view, aligned = full[1:], full[1:].clone()
    assert view.is_contiguous() and (view.data_ptr() % 16 != 0) == (k * x_dtype.itemsize % 16 != 0)
    out = _ff_transform(emu, view, w, vals_dtype)
    assert torch.equal(out, _ff_transform(emu, aligned, w, vals_dtype))
    _transform_rule(out, ff_transform_plain(view, w, vals_dtype), vals_dtype)


@pytest.mark.parametrize("combo", ALL_COMBOS)
def test_emulated_ff_transform_bit_identical_across_grids(emu, combo):
    """The same bits on every call, and whatever the grid: each output's sum
    runs over the same warps' slices of K in the same order whichever block
    holds its group."""
    vals_dtype, x_dtype, w_dtype = combo
    r = np.random.default_rng(11)
    x = torch.from_numpy(r.standard_normal((192, 300)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(r.standard_normal((300, 16)).astype(np.float32)).to(w_dtype)
    first = _ff_transform(emu, x, w, vals_dtype, blocks=3)
    assert torch.equal(first, _ff_transform(emu, x, w, vals_dtype, blocks=3))
    assert torch.equal(first, _ff_transform(emu, x, w, vals_dtype, blocks=1))
    _transform_rule(first, ff_transform_plain(x, w, vals_dtype), vals_dtype)


def test_emulated_xw_geometry_matches_python(emu):
    """`xw_blocks` and `xw_smem_bytes` mirror the .cuh: one block per SM up to
    the row groups (Nell's 1,028 groups of 64 fp32 rows over 132 blocks, rank
    0's 376 groups of 48 bf16 rows too), and a block's shared memory within
    the 227 KB an H100 block may take."""
    for M in (1, 48, 64, 65, 100, 8_448, 18_048, 65_792):
        for sms in (1, 8, 132):
            for x_dtype in (F32, BF16):
                assert emu.emu_xw_blocks(M, sms, x_dtype.itemsize) == xw_blocks(M, x_dtype, sms)
    for x_dtype, w_dtype in ((F32, F32), (BF16, F32), (BF16, BF16)):
        xb, wb = x_dtype.itemsize, w_dtype.itemsize
        assert emu.emu_xw_smem_bytes(xb, wb) == xw_smem_bytes(x_dtype, w_dtype) <= 232_448
    assert xw_blocks(65_792, F32) == xw_blocks(18_048, BF16) == 132
    assert (xw_blocks(100, F32), xw_blocks(100, BF16)) == (2, 3)


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


# ------------------------------------------------ the split schedule (K1, K2)
# Every ragged instantiation: (kernel, dtypes) as the launchers name them.
RAGGED = [pytest.param(("ff", c), id=f"ff{sfx or '_f32'}") for c, sfx in SUFFIXES.items()] + \
    [pytest.param(("af", c), id=f"af{sfx or '_f32'}") for c, sfx in SUFFIXES.items()] + \
    [pytest.param(("k1", c), id=f"k1{sfx or '_f32'}") for c, sfx in K1_SUFFIXES.items()]
# (lens, grid, min_tiles, row_weight): a row longer than a block's share;
# all tiles in one row; empty rows first, in the middle and last; no valid
# tile at all; one position per block (every row split); the default
# minimum share, with blocks left idle; a heavier epilogue weight.
SPLIT_CASES = {
    "long_row": ([13, 1, 2, 1, 3], 4, 1, 1),
    "one_row": ([10], 4, 1, 1),
    "empty_rows_first_middle_last": ([0, 0, 3, 0, 5, 0, 0], 3, 1, 1),
    "no_tiles": ([0, 0, 0], 4, 1, 1),
    "one_position_per_block": ([3, 5, 2, 4], 18, 1, 1),
    "default_min_tiles": ([13, 1, 2, 1, 3], 64, MIN_TILES, 1),
    "row_weight_3": ([0, 4, 1, 1, 7, 0], 5, 1, 3),
}


def _split_table(lens, seed, n_src_blocks=5):
    """A ragged table with the given lens, its padding tiles NaN; returns
    (poisoned vals, clean vals, cols, lens)."""
    r = np.random.default_rng(seed)
    lens = torch.tensor(lens, dtype=torch.int32)
    R, T = len(lens), max(int(lens.max()), 1)
    vals = torch.from_numpy((0.3 * r.standard_normal((R, T, 128, 128))).astype(np.float32))
    cols = torch.from_numpy(r.integers(0, n_src_blocks, (R, T)).astype(np.int32))
    return poison_padding(vals, lens), vals, cols, lens


def _run_split(emu, inst, lens, grid, min_tiles, row_weight=1, f=16, order=0, seed=0):
    """One ragged instantiation on a split table: (kernel output, plain
    version on the clean table, the expected rows of an empty block-row)."""
    kind, dtypes = inst
    poisoned, vals, cols, lens = _split_table(lens, seed)
    r = np.random.default_rng(seed + 1)
    src = torch.from_numpy(r.standard_normal((5 * 128, f)).astype(np.float32))
    kw = dict(grid=grid, min_tiles=min_tiles, order=order, row_weight=row_weight)
    if kind == "k1":
        vd, zd = dtypes
        v, pv, z = vals.to(vd), poisoned.to(vd).contiguous(), src.to(zd)
        return _bsr_spmm(emu, pv, cols, lens, z, **kw), bsr_spmm_plain(v, cols, lens, z), torch.zeros(f, dtype=zd)
    vd, xd, wd = dtypes
    b = torch.from_numpy(r.standard_normal(9 if kind == "af" else f).astype(np.float32))
    v, pv = vals.to(vd), poisoned.to(vd).contiguous()
    if kind == "ff":
        z = src.to(vd)
        return (_ff_aggregate(emu, pv, cols, lens, z, b, True, xd, **kw),
                ff_aggregate_plain(v, cols, lens, z, b, True, xd), b.clamp_min(0).to(xd))
    x, w = src.to(xd), torch.from_numpy((0.2 * r.standard_normal((f, 9))).astype(np.float32)).to(wd)
    return _af_layer(emu, pv, cols, lens, x, w, b, True, **kw), af_layer_plain(v, cols, lens, x, w, b, True), \
        b.clamp_min(0).to(xd)


def _hold_split(inst, out, ref):
    kind, dtypes = inst
    if kind == "k1" and dtypes[1] == BF16:
        _k1_bf16_rule(out, ref)
    else:
        _close(out, ref, tol=BF16_TOL if out.dtype == BF16 else 1e-5)


def test_emulated_split_helpers_match_python(emu):
    """The .cuh's split arithmetic and the bf16 stage's shared memory
    against the wrapper's mirrors (`ragged_split`, `layer_smem_bytes`)."""
    for ft in (1, 7, 16, 50, 240):
        assert emu.emu_layer_smem_bytes_bf16(ft) == layer_smem_bytes(ft, BF16) < layer_smem_bytes(ft)
    r = np.random.default_rng(5)
    for n_rows, grid, min_tiles, weight in ((1, 4, 1, 1), (7, 3, 1, 2), (40, 528, 4, 1), (40, 9, 4, 3),
                                            (200, 132, 1, 1)):
        lens = r.integers(0, 30, n_rows) * (r.random(n_rows) < 0.7)
        n = int(lens.sum()) + weight * n_rows
        blocks = ragged_split(lens, 30, grid, min_tiles, weight)
        assert emu.emu_split_blocks(n, grid, min_tiles) == len(blocks)
        for blk in blocks:
            for pos in range(blk["lo"], blk["hi"]):
                assert emu.emu_owner_block(pos, n, len(blocks)) == blk["block"]


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("inst", RAGGED)
def test_emulated_split_schedule_matches_plain(emu, inst, case):
    """Each ragged instantiation over tables the split cuts in every way,
    NaN in every padding tile: the plain version on the clean table, act(b)
    (zeros for K1) on every empty block-row."""
    lens, grid, min_tiles, weight = SPLIT_CASES[case]
    out, ref, empty = _run_split(emu, inst, lens, grid, min_tiles, weight)
    assert torch.isfinite(out.float()).all()
    _hold_split(inst, out, ref)
    for row in (i for i, n in enumerate(lens) if n == 0):
        assert torch.equal(out[row * 128:(row + 1) * 128], empty.expand(128, -1)), row


@pytest.mark.parametrize("inst", RAGGED)
def test_emulated_split_is_bit_identical_under_block_orders(emu, inst):
    """Rows split over three blocks give the same bits whichever block
    arrives last: partials are added in block order, not arrival order."""
    lens, grid, _, _ = SPLIT_CASES["long_row"]
    outs = [_run_split(emu, inst, lens, grid, 1, order=order)[0] for order in (0, 1, 7)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("inst", [p for p in RAGGED if p.id in ("ff_f32", "af_bf16", "k1_bf16")])
def test_emulated_split_two_feature_tiles(emu, inst):
    """Width 72: feature-first and K1 run two feature tiles (grid.y = 2),
    each with its own workspace slots and counters; 16-byte staging."""
    out, ref, _ = _run_split(emu, inst, [13, 1, 2, 1, 3], 4, 1, f=72, order=3)
    _hold_split(inst, out, ref)


AF = [p for p in RAGGED if p.id.startswith("af")]


@pytest.mark.parametrize("f", [241, 256, 481])
@pytest.mark.parametrize("inst", AF)
def test_emulated_af_wide_split_matches_plain(emu, inst, f):
    """F_in past one chunk (2, 2 and 3 chunks of `af_chunk`) on a table whose
    long row splits over three blocks, NaN in the padding tiles and in the
    running output sums before their first write: the plain version, and
    act(b) on the empty block-row."""
    lens = [9, 1, 0, 2, 1]
    out, ref, empty = _run_split(emu, inst, lens, 5, 1, f=f, order=3, seed=f)
    assert af_chunk(f)[1] > 1
    assert torch.isfinite(out.float()).all()
    _hold_split(inst, out, ref)
    assert torch.equal(out[2 * 128:3 * 128], empty.expand(128, -1))


@pytest.mark.parametrize("inst", AF)
def test_emulated_af_wide_bits_do_not_depend_on_block_order(emu, inst):
    """At F_in = 481 (three chunks), rows split over blocks give the same
    bits whichever block arrives last: each chunk's partials are added in
    block order."""
    lens = [6, 1, 3, 0, 2]
    outs = [_run_split(emu, inst, lens, 13, 1, f=481, order=order, seed=4)[0] for order in (0, 5, 9)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("grid", [1, 4])
@pytest.mark.parametrize("inst", AF)
def test_emulated_af_wide_chunks_keep_one_chain_over_k(emu, inst, grid):
    """Chunking F_in does not change a bit: at F_in = 96 the layer in three
    chunks of 32 equals the layer in one pass, with rows whole (one block)
    and split (four blocks): each chunk's aggregate is the one-pass
    aggregate's columns, and the product with W continues one FMA chain over
    k through the running output sum."""
    kind, (vd, xd, wd) = inst
    poisoned, _, cols, lens = _split_table([6, 1, 3, 0, 2], seed=8)
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.standard_normal((5 * 128, 96)).astype(np.float32)).to(xd)
    w = torch.from_numpy((0.2 * r.standard_normal((96, 40))).astype(np.float32)).to(wd)
    b = torch.from_numpy(r.standard_normal(40).astype(np.float32))
    pv = poisoned.to(vd).contiguous()
    one = _af_layer(emu, pv, cols, lens, x, w, b, True, grid=grid)
    three = _af_layer(emu, pv, cols, lens, x, w, b, True, grid=grid, ft=32)
    assert torch.isfinite(one.float()).all() and torch.equal(three, one)


@pytest.mark.parametrize("combo", K1_BF16)
def test_emulated_bsr_spmm_bf16_split_rows_keep_the_chain(emu, combo):
    """Every block-row split, one position per block: the finishing block runs
    the reference's per-tile chain over products other blocks computed, so
    the result follows `_rounded_per_tile`, not the sum rounded once."""
    vals_dtype, z_dtype = combo
    vals, cols, lens, _, _, _ = _layer_inputs(256, 2400, 1, 1, seed=13)
    vals = vals.to(vals_dtype).contiguous()
    z = torch.from_numpy(np.random.default_rng(13).standard_normal((vals.shape[0] * 128, 16)).astype(np.float32))
    z = z.to(z_dtype)
    n = int(lens.sum()) + len(lens)                      # positions at row weight 1
    assert all(b["hi"] - b["lo"] == 1 for b in ragged_split(lens.numpy(), cols.shape[1], n, 1))
    out = _bsr_spmm(emu, vals, cols, lens, z, grid=n, min_tiles=1, order=5)
    per_tile = bsr_spmm_plain(vals, cols, lens, z)
    _k1_bf16_rule(out, per_tile)
    once = bsr_spmm_plain(vals.float(), cols, lens, z.float()).to(BF16).float()
    assert float((out.float() == once).float().mean()) < 0.95


# ------------------------------------------------------------------------- K3
@pytest.fixture(scope="module")
def emu_k3(tmp_path_factory):
    lib = _compile(tmp_path_factory, "fm_interaction_emu", K3_HARNESS)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("emu_fm_interaction", "emu_fm_interaction_bf16"):
        getattr(lib, name).argtypes = [P, P, I, I, I, I]
    for name in ("emu_fm_tile_examples", "emu_fm_tile_staged"):
        getattr(lib, name).argtypes = [I, I, I, I]
    lib.emu_fm_smem_bytes.argtypes = [I, I, I, I]
    lib.emu_fm_smem_bytes.restype = ctypes.c_longlong
    return lib


def _fm(lib, emb, blocks=3):
    """The emulated K3 on at most ``blocks`` blocks (so that blocks loop over
    several tiles, through both slots of their ring)."""
    B, F, D = emb.shape
    out = torch.full((B,), float("nan"), dtype=emb.dtype)
    name = "emu_fm_interaction" if emb.dtype == F32 else "emu_fm_interaction_bf16"
    assert getattr(lib, name)(_p(emb), _p(out), B, F, D, blocks) == 0
    return out


def test_emulated_fm_tiling_matches_python(emu_k3):
    """`fm_tile` and `fm_smem_bytes` mirror the .cuh: the tile follows B as
    well as F, D and the dtype, starts every tile on a 16-byte boundary, and
    stays within 48 KB of shared memory."""
    shapes = [(39, 10), (2, 10), (1, 1), (40, 400), (3, 300), (8, 16), (39, 4096), (1, 257), (7, 3), (3, 1)]
    for B in (1, 2, 7, 512, 1000, 65_536, 262_144):
        for F, D in shapes:
            for dtype in (F32, BF16):
                e = dtype.itemsize
                bt, staged = fm_tile(B, F, D, dtype)
                assert (emu_k3.emu_fm_tile_examples(B, F, D, e), bool(emu_k3.emu_fm_tile_staged(B, F, D, e))) == \
                    (bt, staged)
                assert emu_k3.emu_fm_smem_bytes(B, F, D, e) == fm_smem_bytes(B, F, D, dtype) <= 2 * 48 * 1024
                assert bt >= 1 and (not staged or bt * F * D * e % 16 == 0)
    assert fm_tile(65_536, 39, 10) == (16, True)           # DeepFM: one pass of 16 examples, 16 lanes each
    assert fm_tile(512, 39, 10) == (4, True)               # serve_p99: 128 blocks
    assert fm_tile(65_536, 39, 10, BF16) == (16, True)
    assert fm_tile(512, 39, 10, BF16) == (4, True)
    assert fm_tile(33, 40, 400) == (1, False)              # an example past the stage is read in place
    assert fm_tile(0, 39, 10) == (0, False)


@pytest.mark.parametrize("b,f,d", [(37, 39, 10), (53, 2, 10), (26, 39, 10), (5, 1, 4), (3, 40, 400),
                                   (4, 3, 300), (1, 39, 10), (2, 39, 10), (512, 39, 10), (9, 7, 3),
                                   (300, 3, 1)])
def test_emulated_fm_interaction_matches_plain(emu_k3, b, f, d):
    """Odd B (a short last tile), B = 1 and 2, the serving batch of 512,
    DeepFM's row (F = 39, D = 10), F = 2 and F = 1, an example wider than
    the stage (read in place), D past a warp, an example of 21 fp32 values
    (84 bytes: tiles of four examples) and D = 1; every output written."""
    emb = torch.from_numpy(np.random.default_rng(b * f + d).standard_normal((b, f, d)).astype(np.float32))
    _close(_fm(emu_k3, emb), fm_interaction_plain(emb))


@pytest.mark.parametrize("blocks", [1, 2, 5, 1000])
def test_emulated_fm_interaction_any_grid(emu_k3, blocks):
    """One block taking every tile, a few blocks looping over several (both
    ring slots, a short last tile) and one block per tile: the same bits."""
    emb = torch.from_numpy(np.random.default_rng(12).standard_normal((150, 39, 10)).astype(np.float32))
    out = _fm(emu_k3, emb, blocks)
    assert torch.equal(out, _fm(emu_k3, emb, 1))
    _close(out, fm_interaction_plain(emb))


def test_emulated_fm_interaction_one_field_is_zero(emu_k3):
    """F = 1: (Σ_f e)² − Σ_f e² is exactly zero, fp32 and bf16."""
    for dtype in (F32, BF16):
        emb = torch.from_numpy(np.random.default_rng(8).standard_normal((77, 1, 10)).astype(np.float32)).to(dtype)
        out = _fm(emu_k3, emb)
        assert out.dtype == dtype and torch.equal(out, torch.zeros_like(out))


def test_emulated_fm_interaction_unaligned_start_reads_in_place(emu_k3):
    """An embedding view that starts 8 bytes past a 16-byte boundary (emb[1:]
    of DeepFM's rows) is not staged, and gives the same answer."""
    full = torch.from_numpy(np.random.default_rng(9).standard_normal((38, 39, 10)).astype(np.float32))
    view = full[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    _close(_fm(emu_k3, view), fm_interaction_plain(view))


@pytest.mark.parametrize("b", [37, 3, 512])
def test_emulated_fm_interaction_bf16(emu_k3, b):
    """bf16 embeddings: widened as read, fp32 sums, one rounding at the end —
    the plain version's arithmetic, so within one bf16 step; B = 3 leaves a
    tile tail under 16 bytes (3 × 780 bytes)."""
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal((b, 39, 10)).astype(np.float32)).to(BF16)
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
    lib.emu_k4_smem_bytes.argtypes = [I, I]
    lib.emu_k4_smem_bytes.restype = ctypes.c_longlong
    for name in ("emu_k4_block_rows", "emu_k4_tile_keys", "emu_k4_block_threads"):
        getattr(lib, name).argtypes = [I]
    lib.emu_k4_tiles.argtypes = [I, I, I, I, I, P, P]
    lib.emu_mma_check.argtypes = [P, P, P, P, P]
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


def _bf16_rule(out, ref):
    """K4's bf16 contract (as on the card): within one bf16 step of the
    largest value and at least 99 % bit-equal to the plain version, which
    keeps p in fp32."""
    assert out.dtype == ref.dtype == BF16
    _close(out, ref, tol=2.0 ** -7)
    equal = float((out == ref).float().mean())
    assert equal >= 0.99, equal
    return equal


def test_emulated_k4_tiling_matches_python(emu_k4):
    """Each body's tiles, threads and shared memory, and the k-tiles each
    q-tile visits, in the .cuh and in the wrapper."""
    begin, end = ctypes.c_int(), ctypes.c_int()
    for dtype, bf16 in ((F32, 0), (BF16, 1)):
        assert (emu_k4.emu_k4_block_rows(bf16), emu_k4.emu_k4_tile_keys(bf16), emu_k4.emu_k4_block_threads(bf16)) \
            == (K4_BLOCK_ROWS[dtype], K4_TILE_KEYS[dtype], K4_THREADS[dtype])
        for S in (1, 63, 64, 130, 4096):
            for q0 in range(0, S, K4_BLOCK_ROWS[dtype]):
                for window in (GLOBAL, 1024, 33, 8, 1, 0, -3, -GLOBAL):
                    for causal in (True, False):
                        emu_k4.emu_k4_tiles(q0, S, window, int(causal), bf16, ctypes.byref(begin),
                                            ctypes.byref(end))
                        assert range(begin.value, end.value) == k_tiles(q0, S, window, causal, dtype)
        for d in (4, 12, 16, 20, 48, 240, 256):
            assert emu_k4.emu_k4_smem_bytes(d, bf16) == k4_smem_bytes(d, dtype) <= 227 * 1024
    assert 2 * k4_smem_bytes(240, BF16) <= 227 * 1024       # two bf16 blocks per SM at gemma3's head width
    assert k4_smem_bytes(240, BF16) == 2 * 192 * 248        # rows of 496 bytes (240 + 8 bf16)
    # a local layer's last q-tile: 36 of 128 32-key tiles in fp32, 17 of 64 64-key tiles in bf16
    assert len(k_tiles(3968, 4096, 1024, True, F32)) == 36
    assert len(k_tiles(4032, 4096, 1024, True, BF16)) == 17


def test_emulated_mma_ldmatrix_match_plain_product(emu_k4):
    """The warp-level stand-ins against a plain product: ldmatrix puts A in
    the PTX ISA's m16n8k16 fragment layout, and A @ B through ldmatrix (from
    Bᵀ as K is stored) or ldmatrix.trans (from B as V is stored) and two
    m16n8k16 products equals the fp32 product of the bf16 values."""
    r = np.random.default_rng(0)
    a, b = (torch.from_numpy(r.standard_normal((16, 16)).astype(np.float32)).to(BF16) for _ in range(2))
    d_k, d_v = torch.full((16, 16), float("nan")), torch.full((16, 16), float("nan"))
    frag32 = torch.zeros(32 * 4, dtype=torch.int32)
    assert emu_k4.emu_mma_check(_p(a), _p(b), _p(d_k), _p(d_v), _p(frag32)) == 0
    frag = frag32.numpy().view(np.uint32).reshape(32, 4)
    bits = a.view(torch.int16).numpy().view(np.uint16)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            assert frag[lane, i] == int(bits[row, col]) | int(bits[row, col + 1]) << 16
    want = a.double() @ b.double()
    for got in (d_k, d_v):
        assert torch.allclose(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("window", [GLOBAL, 8, 0])
@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("s", [1, 63, 130])
def test_emulated_flash_attention_matches_plain(emu_k4, s, d, window, causal):
    """Any S (a single row, a short tile, a ragged second q-tile), both
    widths, the global and a sliding window, window 0 (causal: no valid key,
    every row averages v), with and without the causal mask."""
    q, k, v = _qkv(2, s, d, seed=s * d + window % 97 + causal)
    out = _flash(emu_k4, q, k, v, window, causal)
    _close(out, flash_attention_plain(q, k, v, window=window, causal=causal))


@pytest.mark.parametrize("window", [GLOBAL, 8, 0])
@pytest.mark.parametrize("s", [63, 130])
def test_emulated_flash_attention_bf16(emu_k4, s, window):
    """bf16 q, k, v through the tensor-core body: fp32 scores and softmax, p
    into P·V as two bf16 terms, one rounding at the end — within one bf16
    step of the largest value and nearly always bit-equal to the plain
    version."""
    q, k, v = _qkv(2, s, 48, seed=s + window % 97, dtype=BF16)
    out = _flash(emu_k4, q, k, v, window, True)
    _bf16_rule(out, flash_attention_plain(q, k, v, window=window))


@pytest.mark.parametrize("s,d,window,causal", [
    (1, 48, GLOBAL, True), (77, 48, GLOBAL, True), (40, 48, 8, True), (40, 16, GLOBAL, True),
    (130, 48, 0, True), (130, 48, GLOBAL, False), (130, 48, 24, False), (200, 16, 70, True),
    (200, 48, GLOBAL, True), (70, 40, GLOBAL, True), (70, 20, 8, True), (70, 4, GLOBAL, False)],
    ids=["one_row", "odd_s", "short_window", "short_d16", "window_0", "bidirectional", "bidirectional_window",
         "local_skips_tiles", "interior_tiles", "d40_padded", "d20_8byte_copies", "d4"])
def test_emulated_flash_attention_bf16_cases(emu_k4, s, d, window, causal):
    """The bf16 body at one row, an odd S, S under one tile, window 0
    (every row averages v), the bidirectional mask with and without a
    window, a window that skips k-tiles, tiles with no masked pair (no
    per-element test), d padded to a multiple of 16 with zero columns, and
    rows of d = 20 or 4 (copied 8 bytes at a time)."""
    q, k, v = _qkv(2, s, d, seed=3 * s + d + window % 97 + causal, dtype=BF16)
    out = _flash(emu_k4, q, k, v, window, causal)
    _bf16_rule(out, flash_attention_plain(q, k, v, window=window, causal=causal))


def test_emulated_flash_attention_bf16_keeps_p_in_16_bits(emu_k4):
    """P·V with p as P_hi + P_lo: the body follows the plain version, whose p
    is fp32, where one bf16 p would leave far fewer outputs bit-equal."""
    q, k, v = _qkv(2, 130, 48, seed=21, dtype=BF16)
    out = _flash(emu_k4, q, k, v, GLOBAL, True)
    ref = flash_attention_plain(q, k, v)
    s = (q.float() @ k.float().transpose(1, 2)) * 48 ** -0.5
    s = s.masked_fill(~torch.ones(130, 130, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    one_bf16 = ((p.to(BF16).float() @ v.float()) / p.sum(-1, keepdim=True)).to(BF16)
    assert _bf16_rule(out, ref) > float((one_bf16 == ref).float().mean()) + 0.1


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


@pytest.mark.parametrize("window", [GLOBAL, 8])
def test_emulated_flash_attention_bf16_groups_kv_heads(emu_k4, window):
    """The bf16 body reads grouped key/value heads in place: bit-equal to
    expanding them, and the bf16 contract against the plain version."""
    q, k, v = _qkv(6, 130, 16, seed=window % 97 + 1, bh_kv=3, dtype=BF16)
    out = _flash(emu_k4, q, k, v, window, True)
    expanded = _flash(emu_k4, q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0), window, True)
    assert torch.equal(out, expanded)
    _bf16_rule(out, flash_attention_plain(q, k, v, window=window))


# ----------------------------------------------------------------- fake quant
# The fake-quant kernels compiled through SHIM, with the launch sequence of
# fake_quant.cu on a grid of a given number of blocks and a scratch buffer
# of a given capacity.
FQ_HARNESS = r"""
// The GCN's fake quantization (src/repro_torch/kernels/csrc/fake_quant_kernels.cuh)
// compiled by the host compiler through shim.h, with the launch sequence of
// fake_quant.cu, behind a C interface for ctypes. Returns 0, or 2 for
// arguments the launcher refuses.
#include "shim.h"

#include "fake_quant_kernels.cuh"

#include <cstdint>

namespace fq {
alignas(16) unsigned fq_smem[smem_bytes<__nv_bfloat16>() / 4];
}

template <typename T>
int emu_fq(const void* xp, void* outp, long long n, float qmax, float lo, float hi, long long k, unsigned* state,
           unsigned* scratch, long long cap, int blocks) {
    if (n < 1 || k < 0 || k > n || cap < 0 || cap > n || blocks < 1) return 2;
    const T* x = (const T*)xp;
    T* out = (T*)outp;
    fq::State* st = reinterpret_cast<fq::State*>(state);
    const int vec = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 ? 1 : 0;
    if (k == 0) {
        emu_launch(dim3(blocks), fq::THREADS, [&] { fq::max_pass<T>(x, n, vec, st); });
    } else {
        for (int p = 0; p < fq::digit_passes(fq::Elem<T>::KEY_BITS); ++p)
            emu_launch(dim3(blocks), fq::THREADS,
                       [&] { fq::select_pass<T>(x, n, vec, scratch, (unsigned)cap, st, p, (unsigned)k); });
    }
    emu_launch(dim3(blocks), fq::THREADS,
               [&] { fq::quantize<T>(x, out, n, vec, st, qmax, lo, hi, scratch, (unsigned)cap, k > 0 ? 1 : 0); });
    return 0;
}

extern "C" {
int emu_fake_quant(const void* x, void* out, long long n, float qmax, float lo, float hi, long long k,
                   unsigned* state, unsigned* scratch, long long cap, int blocks) {
    return emu_fq<float>(x, out, n, qmax, lo, hi, k, state, scratch, cap, blocks);
}
int emu_fake_quant_bf16(const void* x, void* out, long long n, float qmax, float lo, float hi, long long k,
                        unsigned* state, unsigned* scratch, long long cap, int blocks) {
    return emu_fq<__nv_bfloat16>(x, out, n, qmax, lo, hi, k, state, scratch, cap, blocks);
}
long long emu_fq_state_words() { return (long long)(sizeof(fq::State) / 4); }
int emu_fq_passes(int elem) { return fq::digit_passes(elem == 2 ? 15 : 31); }
int emu_fq_digit(int kb, int p, int which) { return which ? fq::digit_width(kb, p) : fq::digit_shift(kb, p); }
}  // extern "C"
"""


@pytest.fixture(scope="module")
def emu_fq(tmp_path_factory):
    lib = _compile(tmp_path_factory, "fake_quant_emu", FQ_HARNESS)
    P, L, F, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    for name in ("emu_fake_quant", "emu_fake_quant_bf16"):
        getattr(lib, name).argtypes = [P, P, L, F, F, F, L, P, P, L, I]
    lib.emu_fq_state_words.restype = L
    lib.emu_fq_passes.argtypes = [I]
    lib.emu_fq_digit.argtypes = [I, I, I]
    return lib


def _emu_fake_quant(lib, x, bits, percentile, blocks=3, cap=None, offset=0, fill=None):
    """(out, the statistic's key, the scale) of the emulated kernels on x
    (flat from element ``offset`` of its storage: 1 makes a start that is
    not 16-byte aligned); ``fill``: the output's values before the call, in
    place of the wrapper's (zeros for the percentile)."""
    from repro_torch.kernels import fake_quant as fqk

    base = torch.zeros(x.numel() + 8, dtype=x.dtype)
    base[offset:offset + x.numel()] = x.reshape(-1)
    xs = base[offset:offset + x.numel()]
    n = xs.numel()
    k = 0 if percentile is None else fqk.rank_k(n, percentile)
    cap = fqk.scratch_capacity(n) if cap is None else cap
    state = torch.zeros(lib.emu_fq_state_words(), dtype=torch.int32)
    scratch = torch.full((max(2 * cap, 1),), -1, dtype=torch.int32)
    out = torch.zeros_like(xs) if k else torch.full_like(xs, float("nan"))   # as the wrapper allocates it
    if fill is not None:
        out.fill_(fill)
    qmax = float(2 ** (bits - 1) - 1)
    name = "emu_fake_quant" if x.dtype == F32 else "emu_fake_quant_bf16"
    assert getattr(lib, name)(xs.data_ptr(), out.data_ptr(), n, qmax, -qmax - 1, qmax, k, state.data_ptr(),
                              scratch.data_ptr(), cap, blocks) == 0
    words = state.view(torch.int64 if False else torch.int32).numpy().view(np.uint32)
    return out.reshape(x.shape), int(words[0]), int(words[1])


def _card_ops(x, bits, percentile):
    """The plain version's ops as the card runs them, on the CPU: the scale
    is amax times the fp32 reciprocal of qmax (PyTorch's CUDA division by a
    host scalar), where the CPU's division is a true one."""
    from repro_torch.kernels import fake_quant as fqk

    qmax = float(2 ** (bits - 1) - 1)
    mag = x.abs()
    flat = mag.reshape(-1)
    amax = mag.max() if percentile is None else torch.topk(flat, fqk.rank_k(flat.numel(), percentile)).values[-1]
    inv = torch.tensor(1.0, dtype=F32) / torch.tensor(qmax, dtype=F32)
    scale = torch.where(amax > 0, (amax.float() * inv).to(x.dtype), torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    return x + (q - x), amax, scale


def _bits_equal(out, ref):
    """The same bits wherever ref is not NaN, and NaN where it is."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    view = torch.int32 if out.dtype == F32 else torch.int16
    assert torch.equal(out[~nan].view(view), ref[~nan].view(view))


def _fq_cases():
    r = np.random.default_rng(7)
    sparse = np.zeros((40, 300), np.float32)                        # Nell-like rows: 32 ones each
    for row in sparse:
        row[r.choice(300, 32, replace=False)] = 1.0
    sparse[3, :5] = [0.5, 2.0, 0.25, 3.0, 1.5]
    special = r.standard_normal(700).astype(np.float32)
    special[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-42, 1.2e-38, -7.5]
    special[100:106] = np.nan
    return {
        "sparse": sparse,
        "relu": np.maximum(r.standard_normal((257, 16)), 0).astype(np.float32),
        "weights": (0.1 * r.standard_normal((50, 7))).astype(np.float32),
        "ties": np.where(r.random(3000) < 0.7, 1.0, -1.0).astype(np.float32),
        "zeros": np.zeros(999, np.float32),
        "small": r.standard_normal(37).astype(np.float32),
        "special": special,
        "tiny": np.array([1.4e-45, 0.0, -1.4e-45, 0.0, -0.0, 2.8e-45, 0.0, 0.0, 0.0], np.float32),
    }


FQ_CASES = _fq_cases()


@pytest.mark.parametrize("percentile", [None, 99.9, 90.0, 0.0])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(FQ_CASES))
def test_emulated_fake_quant_matches_card_ops(emu_fq, name, dtype, percentile):
    """The kernels' output equals the plain ops (with the card's scale) bit
    for bit, and their statistic and scale are the ops' — k = 1 (n < 1,000
    at 99.9), k = n (percentile 0), zeros, ties, NaN, inf, subnormals, a
    scale that rounds to 0 (tiny)."""
    x = torch.from_numpy(FQ_CASES[name]).to(dtype)
    out, key, scale_bits = _emu_fake_quant(emu_fq, x, 4, percentile)
    ref, amax, scale = _card_ops(x, 4, percentile)
    _bits_equal(out, ref)
    if dtype == F32:
        assert key == int(amax.view(torch.int32)) & 0x7FFFFFFF or (torch.isnan(amax) and key > 0x7F800000)
        assert scale_bits == int(scale.view(torch.int32)) & 0xFFFFFFFF
    else:
        assert key == int(amax.view(torch.int16)) & 0x7FFF or (torch.isnan(amax) and key > 0x7F80)
        assert scale_bits == int(scale.view(torch.int16)) & 0xFFFF


@pytest.mark.parametrize("cap", [0, 40, 200, 2_000])
@pytest.mark.parametrize("blocks", [1, 4, 9])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_emulated_fake_quant_any_grid_and_capacity(emu_fq, dtype, blocks, cap):
    """The same bits on any grid and with a scratch buffer too small for the
    first pass's keys (40, 200: the next pass reads x again) or for any
    (0), on the sparse case at 99.9 and at 50."""
    x = torch.from_numpy(FQ_CASES["sparse"]).to(dtype)
    for percentile in (99.9, 50.0):
        out, _, _ = _emu_fake_quant(emu_fq, x, 4, percentile, blocks=blocks, cap=min(cap, x.numel()))
        _bits_equal(out, _card_ops(x, 4, percentile)[0])


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_emulated_fake_quant_writes_only_the_nonzeros_where_they_fit(emu_fq, dtype):
    """With every nonzero element in the buffer the quantize kernel writes
    only those (an output filled with 5.0 keeps it at the zeros); with too
    small a buffer, or a scale that rounds to 0, it writes every element."""
    x = torch.from_numpy(FQ_CASES["sparse"]).to(dtype)
    nz = x != 0
    ref = _card_ops(x, 4, 99.9)[0]
    out, _, _ = _emu_fake_quant(emu_fq, x, 4, 99.9, fill=5.0)
    assert torch.equal(out[nz], ref[nz]) and bool((out[~nz] == 5.0).all())
    out, _, _ = _emu_fake_quant(emu_fq, x, 4, 99.9, cap=int(nz.sum()) - 1, fill=5.0)
    _bits_equal(out, ref)
    if dtype == F32:
        tiny = torch.from_numpy(FQ_CASES["tiny"])
        out, _, _ = _emu_fake_quant(emu_fq, tiny, 4, 99.9, fill=5.0)
        _bits_equal(out, _card_ops(tiny, 4, 99.9)[0])


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_emulated_fake_quant_unaligned_start_and_bits(emu_fq, dtype, bits):
    """A start that is not 16-byte aligned reads element by element, with
    the same bits; 2 and 8 bits."""
    x = torch.from_numpy(FQ_CASES["relu"][:101]).to(dtype)
    for percentile in (None, 99.0):
        out, _, _ = _emu_fake_quant(emu_fq, x, bits, percentile, offset=1)
        _bits_equal(out, _card_ops(x, bits, percentile)[0])


def test_emulated_fake_quant_schedule_matches_python(emu_fq):
    """The digit schedule of the .cuh (shifts, widths, passes) is the
    wrapper's and the numpy mirror's (tests/_fake_quant_mirror.py)."""
    import _fake_quant_mirror as mirror
    from repro_torch.kernels import fake_quant as fqk

    assert (emu_fq.emu_fq_passes(4), emu_fq.emu_fq_passes(2)) == (fqk.digit_passes(31), fqk.digit_passes(15)) == (3, 2)
    for kb in (31, 15):
        for p in range(fqk.digit_passes(kb)):
            assert emu_fq.emu_fq_digit(kb, p, 0) == mirror.digit_shift(kb, p)
            assert emu_fq.emu_fq_digit(kb, p, 1) == mirror.digit_width(kb, p)
