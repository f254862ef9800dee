// Host launchers of the graph kernels (K2, the fused GCN layer, and K1, the
// ragged block-sparse product), with a plain C interface for ctypes (no
// PyTorch headers, so nvcc builds this in seconds):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_gcn.so fused_gcn.cu
//
// Every launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success). Output buffers are allocated by
// the caller. See fused_gcn_kernels.cuh for what each kernel computes.
//
// K2 has one launcher per operand-type combination, named by a suffix:
//   (none)     vals fp32, X fp32, W fp32 → out fp32
//   _bf16      vals fp32, X bf16, W fp32 → out bf16   (the halo path's bf16 table)
//   _bf16_all  vals bf16, X bf16, W bf16 → out bf16
// bias is fp32 in every combination.
//
// K1 has one launcher per (vals, Z) combination; the output has Z's type:
//   k1_bsr_spmm            vals fp32, Z fp32 → out fp32
//   k1_bsr_spmm_bf16       vals fp32, Z bf16 → out bf16 (the halo path's bf16 table)
//   k1_bsr_spmm_bf16_all   vals bf16, Z bf16 → out bf16
// With a bf16 Z the running sum is rounded to bf16 after every tile, as the
// TPU kernel's bf16 output block is.
//
// The ragged launchers (K2's aggregations and K1) take `ends`, the
// inclusive prefix sum of (lens clamped to [0, T]) + row_weight, the grid's
// width grid_x (the wrapper picks one wave from k2_ragged_attributes),
// row_weight (the positions that stand for a row's epilogue), min_tiles
// (the fewest positions a block takes), and the workspace of the split
// schedule: `part` (2 · grid_x · grid_y · nch · 128 · ftp floats, nch the
// aggregation-first layer's chunks of F_in and 1 elsewhere), `arrivals`
// (R · grid_y ints, zeroed by the caller for each launch) and `prods` (K1 with
// a bf16 Z only: R · (T + row_weight) · grid_y · 128 · ftp bf16 values),
// where ftp is ft rounded up to a multiple of 16. The aggregation-first
// launchers also take ft, the width of one chunk of F_in (F_in itself, or a
// multiple of 16 when F_in takes several), and `osum` (grid_x · 128 · f_out
// floats when F_in > ft, else unused): each block's running output sum
// between chunks.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "ptx.cuh"
#include "fused_gcn_kernels.cuh"
#include "xw_kernel.cuh"

namespace {

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The split schedule's workspace (see fused_gcn_kernels.cuh).
struct Split {
    int grid_x, row_weight, min_tiles;
    float* part;
    int* arrivals;
    unsigned short* prods;
};

template <int MODE, typename TV, typename TS, typename TW, typename TO>
int launch_layer(const TV* vals, const int* cols, const int* ends, int R, int T,
                 int n_src_blocks, const TS* src, int f_src, int ft, int grid_y,
                 const TW* w, const float* b, TO* out, int f_out, int relu, Split sp,
                 float* osum, void* stream) {
    const long long smem = k2::kernel_smem_bytes<MODE, TS, TO>(ft);
    cudaError_t err = allow_smem(k2::ragged_layer_kernel<MODE, TV, TS, TW, TO>, smem);
    if (err != cudaSuccess) return (int)err;
    if (sp.grid_x < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
    dim3 grid(sp.grid_x, grid_y);
    k2::ragged_layer_kernel<MODE, TV, TS, TW, TO><<<grid, k2::THREADS, smem, (cudaStream_t)stream>>>(
        vals, cols, ends, R, T, n_src_blocks, src, f_src, ft, w, b, out, f_out, relu, sp.row_weight, sp.min_tiles,
        sp.part, sp.arrivals, sp.prods, osum);
    return (int)cudaGetLastError();
}

// What the compiler gave one ragged instantiation, and the blocks of it that
// fit an SM at accumulator width ft.
template <int MODE, typename TV, typename TS, typename TW, typename TO>
int attributes(int ft, int* registers, long long* local_bytes, int* blocks_per_sm) {
    const auto kernel = k2::ragged_layer_kernel<MODE, TV, TS, TW, TO>;
    const long long smem = k2::kernel_smem_bytes<MODE, TS, TO>(ft);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (long long)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, k2::THREADS, (size_t)smem);
}

// The widest copy (16, 8, 4 or 2 bytes) that divides both the base address
// and the row pitch of a matrix: every row then starts on a piece boundary.
int xw_piece(const void* base, long long pitch) {
    const unsigned long long a = (unsigned long long)reinterpret_cast<std::uintptr_t>(base) | (unsigned long long)pitch;
    for (int p = 16; p > 2; p /= 2)
        if (a % p == 0) return p;
    return 2;
}

// xw_kernel's x_read: the read width of X's rows staged as 16-byte-aligned
// runs (X starts 16-byte aligned and its pitch is a multiple of 4), else 0.
int xw_read(const void* x, long long pitch) {
    if (reinterpret_cast<std::uintptr_t>(x) % 16 != 0) return 0;
    return pitch % 16 == 0 ? 16 : pitch % 8 == 0 ? 8 : pitch % 4 == 0 ? 4 : 0;
}

// Z (M, N) = X (M, K) · W (K, N), stored as TZ.
template <typename TX, typename TW, typename TZ>
int ff_transform(const TX* x, const TW* w, TZ* z, int M, int K, int N, void* stream) {
    if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
    int dev, sms;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long smem = k2::xw_smem_bytes((int)sizeof(TX), (int)sizeof(TW));
    err = allow_smem(k2::xw_kernel<TX, TW, TZ>, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(k2::xw_blocks(M, sms, (int)sizeof(TX)), (N + k2::NC - 1) / k2::NC);
    k2::xw_kernel<TX, TW, TZ><<<grid, k2::XW_THREADS, smem, (cudaStream_t)stream>>>(
        x, w, z, M, K, N, xw_piece(x, (long long)K * sizeof(TX)), xw_read(x, (long long)K * sizeof(TX)),
        xw_piece(w, (long long)N * sizeof(TW)));
    return (int)cudaGetLastError();
}

// What the compiler gave one transform instantiation, and its blocks that fit an SM.
template <typename TX, typename TW, typename TZ>
int transform_attributes(int* registers, long long* local_bytes, int* blocks_per_sm) {
    const auto kernel = k2::xw_kernel<TX, TW, TZ>;
    const long long smem = k2::xw_smem_bytes((int)sizeof(TX), (int)sizeof(TW));
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (long long)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, k2::XW_THREADS, (size_t)smem);
}

// out (R·128, f_out) = act(Ã · Z + b), Z (n_src_blocks·128, f_out) in vals'
// type; each block covers ft output columns.
template <typename TV, typename TO>
int ff_aggregate(const TV* vals, const int* cols, const int* ends, int R, int T,
                 int n_src_blocks, const TV* z, const float* b, TO* out,
                 int f_out, int ft, int relu, Split sp, void* stream) {
    const int grid_y = (f_out + ft - 1) / ft;
    return launch_layer<0, TV, TV, float, TO>(vals, cols, ends, R, T, n_src_blocks, z, f_out, ft,
                                              grid_y, nullptr, b, out, f_out, relu, sp, nullptr, stream);
}

// out (R·128, f_out) = act((Ã · X) · W + b), X (n_src_blocks·128, f_in)
// taken in chunks of ft columns; out in X's type.
template <typename TV, typename TX, typename TW>
int af_layer(const TV* vals, const int* cols, const int* ends, int R, int T,
             int n_src_blocks, const TX* x, int f_in, int ft, const TW* w,
             const float* b, TX* out, int f_out, int relu, Split sp, float* osum, void* stream) {
    if (ft < 1 || ft > f_in) return (int)cudaErrorInvalidValue;
    if (f_in > ft && (ft % k2::NC || osum == nullptr)) return (int)cudaErrorInvalidValue;
    return launch_layer<1, TV, TX, TW, TX>(vals, cols, ends, R, T, n_src_blocks, x, f_in, ft, 1,
                                           w, b, out, f_out, relu, sp, osum, stream);
}

// out (R·128, f) = Ã · Z, Z (n_src_blocks·128, f) — may hold more block-rows
// than the output; each block covers ft output columns; out in Z's type.
template <typename TV, typename TZ>
int bsr_spmm(const TV* vals, const int* cols, const int* ends, int R, int T, int n_src_blocks,
             const TZ* z, TZ* out, int f, int ft, Split sp, void* stream) {
    const int grid_y = (f + ft - 1) / ft;
    return launch_layer<2, TV, TZ, float, TZ>(vals, cols, ends, R, T, n_src_blocks, z, f, ft,
                                              grid_y, nullptr, nullptr, out, f, 0, sp, nullptr, stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

// The split arguments every ragged launcher takes after its own.
#define SPLIT_ARGS int grid_x, int row_weight, int min_tiles, float *part, int *arrivals, unsigned short *prods
#define SPLIT Split{grid_x, row_weight, min_tiles, part, arrivals, prods}

extern "C" {

int k2_ff_transform(const float* x, const float* w, float* z, int M, int K, int N, void* stream) {
    return ff_transform(x, w, z, M, K, N, stream);
}
int k2_ff_transform_bf16(const bf16* x, const float* w, float* z, int M, int K, int N, void* stream) {
    return ff_transform(x, w, z, M, K, N, stream);
}
int k2_ff_transform_bf16_all(const bf16* x, const bf16* w, bf16* z, int M, int K, int N, void* stream) {
    return ff_transform(x, w, z, M, K, N, stream);
}

int k2_ff_aggregate(const float* vals, const int* cols, const int* ends, int R, int T,
                    int n_src_blocks, const float* z, const float* b, float* out,
                    int f_out, int ft, int relu, SPLIT_ARGS, void* stream) {
    return ff_aggregate(vals, cols, ends, R, T, n_src_blocks, z, b, out, f_out, ft, relu, SPLIT, stream);
}
int k2_ff_aggregate_bf16(const float* vals, const int* cols, const int* ends, int R, int T,
                         int n_src_blocks, const float* z, const float* b, bf16* out,
                         int f_out, int ft, int relu, SPLIT_ARGS, void* stream) {
    return ff_aggregate(vals, cols, ends, R, T, n_src_blocks, z, b, out, f_out, ft, relu, SPLIT, stream);
}
int k2_ff_aggregate_bf16_all(const bf16* vals, const int* cols, const int* ends, int R, int T,
                             int n_src_blocks, const bf16* z, const float* b, bf16* out,
                             int f_out, int ft, int relu, SPLIT_ARGS, void* stream) {
    return ff_aggregate(vals, cols, ends, R, T, n_src_blocks, z, b, out, f_out, ft, relu, SPLIT, stream);
}

int k2_af_layer(const float* vals, const int* cols, const int* ends, int R, int T,
                int n_src_blocks, const float* x, int f_in, int ft, const float* w,
                const float* b, float* out, int f_out, int relu, SPLIT_ARGS, float* osum, void* stream) {
    return af_layer(vals, cols, ends, R, T, n_src_blocks, x, f_in, ft, w, b, out, f_out, relu, SPLIT, osum, stream);
}
int k2_af_layer_bf16(const float* vals, const int* cols, const int* ends, int R, int T,
                     int n_src_blocks, const bf16* x, int f_in, int ft, const float* w,
                     const float* b, bf16* out, int f_out, int relu, SPLIT_ARGS, float* osum, void* stream) {
    return af_layer(vals, cols, ends, R, T, n_src_blocks, x, f_in, ft, w, b, out, f_out, relu, SPLIT, osum, stream);
}
int k2_af_layer_bf16_all(const bf16* vals, const int* cols, const int* ends, int R, int T,
                         int n_src_blocks, const bf16* x, int f_in, int ft, const bf16* w,
                         const float* b, bf16* out, int f_out, int relu, SPLIT_ARGS, float* osum, void* stream) {
    return af_layer(vals, cols, ends, R, T, n_src_blocks, x, f_in, ft, w, b, out, f_out, relu, SPLIT, osum, stream);
}

int k1_bsr_spmm(const float* vals, const int* cols, const int* ends, int R, int T,
                int n_src_blocks, const float* z, float* out, int f, int ft, SPLIT_ARGS, void* stream) {
    return bsr_spmm(vals, cols, ends, R, T, n_src_blocks, z, out, f, ft, SPLIT, stream);
}
int k1_bsr_spmm_bf16(const float* vals, const int* cols, const int* ends, int R, int T,
                     int n_src_blocks, const bf16* z, bf16* out, int f, int ft, SPLIT_ARGS, void* stream) {
    return bsr_spmm(vals, cols, ends, R, T, n_src_blocks, z, out, f, ft, SPLIT, stream);
}
int k1_bsr_spmm_bf16_all(const bf16* vals, const int* cols, const int* ends, int R, int T,
                         int n_src_blocks, const bf16* z, bf16* out, int f, int ft, SPLIT_ARGS, void* stream) {
    return bsr_spmm(vals, cols, ends, R, T, n_src_blocks, z, out, f, ft, SPLIT, stream);
}

// Registers, local memory (spills) and blocks per SM of the ragged
// instantiation `mode` (0 ff_aggregate, 1 af_layer, 2 bsr_spmm) × `combo`
// (0 no suffix, 1 _bf16, 2 _bf16_all) at accumulator width ft.
int k2_ragged_attributes(int mode, int combo, int ft, int* registers, long long* local_bytes,
                         int* blocks_per_sm) {
    switch (mode * 3 + combo) {
        case 0: return attributes<0, float, float, float, float>(ft, registers, local_bytes, blocks_per_sm);
        case 1: return attributes<0, float, float, float, bf16>(ft, registers, local_bytes, blocks_per_sm);
        case 2: return attributes<0, bf16, bf16, float, bf16>(ft, registers, local_bytes, blocks_per_sm);
        case 3: return attributes<1, float, float, float, float>(ft, registers, local_bytes, blocks_per_sm);
        case 4: return attributes<1, float, bf16, float, bf16>(ft, registers, local_bytes, blocks_per_sm);
        case 5: return attributes<1, bf16, bf16, bf16, bf16>(ft, registers, local_bytes, blocks_per_sm);
        case 6: return attributes<2, float, float, float, float>(ft, registers, local_bytes, blocks_per_sm);
        case 7: return attributes<2, float, bf16, float, bf16>(ft, registers, local_bytes, blocks_per_sm);
        case 8: return attributes<2, bf16, bf16, float, bf16>(ft, registers, local_bytes, blocks_per_sm);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Registers, local memory (spills) and blocks per SM of the transform
// instantiation `combo` (0 no suffix, 1 _bf16, 2 _bf16_all).
int k2_ff_transform_attributes(int combo, int* registers, long long* local_bytes, int* blocks_per_sm) {
    switch (combo) {
        case 0: return transform_attributes<float, float, float>(registers, local_bytes, blocks_per_sm);
        case 1: return transform_attributes<bf16, float, float>(registers, local_bytes, blocks_per_sm);
        case 2: return transform_attributes<bf16, bf16, bf16>(registers, local_bytes, blocks_per_sm);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The transform's blocks per block column for M rows of x_bytes-byte
// elements on a card of `sms` SMs, and a block's dynamic shared memory for
// x_bytes- and w_bytes-byte elements.
int k2_xw_blocks(int M, int sms, int x_bytes) { return k2::xw_blocks(M, sms, x_bytes); }
long long k2_xw_smem_bytes(int x_bytes, int w_bytes) { return k2::xw_smem_bytes(x_bytes, w_bytes); }

// Shared memory one ragged-layer block needs for an accumulator of width ft
// over source rows of src_bytes-byte elements (4 fp32, 2 bf16).
long long k2_layer_smem_bytes(int ft, int src_bytes) { return k2::layer_smem_bytes(ft, src_bytes); }

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
