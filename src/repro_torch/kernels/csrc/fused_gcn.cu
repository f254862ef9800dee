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

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fused_gcn_kernels.cuh"

namespace {

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MODE, typename TV, typename TS, typename TW, typename TO>
int launch_layer(const TV* vals, const int* cols, const int* lens, int R, int T,
                 int n_src_blocks, const TS* src, int f_src, int ft, int grid_y,
                 const TW* w, const float* b, TO* out, int f_out, int relu,
                 void* stream) {
    const long long smem = k2::layer_smem_bytes(ft);
    cudaError_t err = allow_smem(k2::ragged_layer_kernel<MODE, TV, TS, TW, TO>, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(R, grid_y);
    k2::ragged_layer_kernel<MODE, TV, TS, TW, TO><<<grid, k2::THREADS, smem, (cudaStream_t)stream>>>(
        vals, cols, lens, T, n_src_blocks, src, f_src, ft, w, b, out, f_out, relu);
    return (int)cudaGetLastError();
}

// Z (M, N) = X (M, K) · W (K, N), stored as TZ.
template <typename TX, typename TW, typename TZ>
int ff_transform(const TX* x, const TW* w, TZ* z, int M, int K, int N, void* stream) {
    dim3 grid((M + k2::TILE - 1) / k2::TILE, (N + k2::NC - 1) / k2::NC);
    k2::xw_kernel<TX, TW, TZ><<<grid, k2::THREADS, k2::xw_smem_bytes(), (cudaStream_t)stream>>>(
        x, w, z, M, K, N);
    return (int)cudaGetLastError();
}

// out (R·128, f_out) = act(Ã · Z + b), Z (n_src_blocks·128, f_out) in vals'
// type; each block covers ft output columns.
template <typename TV, typename TO>
int ff_aggregate(const TV* vals, const int* cols, const int* lens, int R, int T,
                 int n_src_blocks, const TV* z, const float* b, TO* out,
                 int f_out, int ft, int relu, void* stream) {
    const int grid_y = (f_out + ft - 1) / ft;
    return launch_layer<0, TV, TV, float, TO>(vals, cols, lens, R, T, n_src_blocks, z, f_out, ft,
                                              grid_y, nullptr, b, out, f_out, relu, stream);
}

// out (R·128, f_out) = act((Ã · X) · W + b), X (n_src_blocks·128, f_in); out
// in X's type.
template <typename TV, typename TX, typename TW>
int af_layer(const TV* vals, const int* cols, const int* lens, int R, int T,
             int n_src_blocks, const TX* x, int f_in, const TW* w,
             const float* b, TX* out, int f_out, int relu, void* stream) {
    return launch_layer<1, TV, TX, TW, TX>(vals, cols, lens, R, T, n_src_blocks, x, f_in, f_in, 1,
                                           w, b, out, f_out, relu, stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

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

int k2_ff_aggregate(const float* vals, const int* cols, const int* lens, int R, int T,
                    int n_src_blocks, const float* z, const float* b, float* out,
                    int f_out, int ft, int relu, void* stream) {
    return ff_aggregate(vals, cols, lens, R, T, n_src_blocks, z, b, out, f_out, ft, relu, stream);
}
int k2_ff_aggregate_bf16(const float* vals, const int* cols, const int* lens, int R, int T,
                         int n_src_blocks, const float* z, const float* b, bf16* out,
                         int f_out, int ft, int relu, void* stream) {
    return ff_aggregate(vals, cols, lens, R, T, n_src_blocks, z, b, out, f_out, ft, relu, stream);
}
int k2_ff_aggregate_bf16_all(const bf16* vals, const int* cols, const int* lens, int R, int T,
                             int n_src_blocks, const bf16* z, const float* b, bf16* out,
                             int f_out, int ft, int relu, void* stream) {
    return ff_aggregate(vals, cols, lens, R, T, n_src_blocks, z, b, out, f_out, ft, relu, stream);
}

int k2_af_layer(const float* vals, const int* cols, const int* lens, int R, int T,
                int n_src_blocks, const float* x, int f_in, const float* w,
                const float* b, float* out, int f_out, int relu, void* stream) {
    return af_layer(vals, cols, lens, R, T, n_src_blocks, x, f_in, w, b, out, f_out, relu, stream);
}
int k2_af_layer_bf16(const float* vals, const int* cols, const int* lens, int R, int T,
                     int n_src_blocks, const bf16* x, int f_in, const float* w,
                     const float* b, bf16* out, int f_out, int relu, void* stream) {
    return af_layer(vals, cols, lens, R, T, n_src_blocks, x, f_in, w, b, out, f_out, relu, stream);
}
int k2_af_layer_bf16_all(const bf16* vals, const int* cols, const int* lens, int R, int T,
                         int n_src_blocks, const bf16* x, int f_in, const bf16* w,
                         const float* b, bf16* out, int f_out, int relu, void* stream) {
    return af_layer(vals, cols, lens, R, T, n_src_blocks, x, f_in, w, b, out, f_out, relu, stream);
}

// out (R·128, f) = Ã · Z, Z (n_src_blocks·128, f) — may hold more block-rows
// than the output; each block covers ft output columns. fp32.
int k1_bsr_spmm(const float* vals, const int* cols, const int* lens, int R, int T,
                int n_src_blocks, const float* z, float* out, int f, int ft, void* stream) {
    const int grid_y = (f + ft - 1) / ft;
    return launch_layer<2, float, float, float, float>(vals, cols, lens, R, T, n_src_blocks, z, f, ft,
                                                       grid_y, nullptr, nullptr, out, f, 0, stream);
}

// Shared memory one ragged-layer block needs for an accumulator of width ft.
long long k2_layer_smem_bytes(int ft) { return k2::layer_smem_bytes(ft); }

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
