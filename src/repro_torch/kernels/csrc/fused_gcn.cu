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

template <int MODE>
int launch_layer(const float* vals, const int* cols, const int* lens, int R, int T,
                 int n_src_blocks, const float* src, int f_src, int ft, int grid_y,
                 const float* w, const float* b, float* out, int f_out, int relu,
                 void* stream) {
    const long long smem = k2::layer_smem_bytes(ft);
    cudaError_t err = allow_smem(k2::ragged_layer_kernel<MODE>, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(R, grid_y);
    k2::ragged_layer_kernel<MODE><<<grid, k2::THREADS, smem, (cudaStream_t)stream>>>(
        vals, cols, lens, T, n_src_blocks, src, f_src, ft, w, b, out, f_out, relu);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Z (M, N) = X (M, K) · W (K, N).
int k2_ff_transform(const float* x, const float* w, float* z, int M, int K, int N,
                    void* stream) {
    dim3 grid((M + k2::TILE - 1) / k2::TILE, (N + k2::NC - 1) / k2::NC);
    k2::xw_kernel<<<grid, k2::THREADS, k2::xw_smem_bytes(), (cudaStream_t)stream>>>(
        x, w, z, M, K, N);
    return (int)cudaGetLastError();
}

// out (R·128, f_out) = act(Ã · Z + b), Z (n_src_blocks·128, f_out); each block
// covers ft output columns.
int k2_ff_aggregate(const float* vals, const int* cols, const int* lens, int R, int T,
                    int n_src_blocks, const float* z, const float* b, float* out,
                    int f_out, int ft, int relu, void* stream) {
    const int grid_y = (f_out + ft - 1) / ft;
    return launch_layer<0>(vals, cols, lens, R, T, n_src_blocks, z, f_out, ft, grid_y,
                           nullptr, b, out, f_out, relu, stream);
}

// out (R·128, f_out) = act((Ã · X) · W + b), X (n_src_blocks·128, f_in).
int k2_af_layer(const float* vals, const int* cols, const int* lens, int R, int T,
                int n_src_blocks, const float* x, int f_in, const float* w,
                const float* b, float* out, int f_out, int relu, void* stream) {
    return launch_layer<1>(vals, cols, lens, R, T, n_src_blocks, x, f_in, f_in, 1,
                           w, b, out, f_out, relu, stream);
}

// out (R·128, f) = Ã · Z, Z (n_src_blocks·128, f) — may hold more block-rows
// than the output; each block covers ft output columns.
int k1_bsr_spmm(const float* vals, const int* cols, const int* lens, int R, int T,
                int n_src_blocks, const float* z, float* out, int f, int ft, void* stream) {
    const int grid_y = (f + ft - 1) / ft;
    return launch_layer<2>(vals, cols, lens, R, T, n_src_blocks, z, f, ft, grid_y,
                           nullptr, nullptr, out, f, 0, stream);
}

// Shared memory one ragged-layer block needs for an accumulator of width ft.
long long k2_layer_smem_bytes(int ft) { return k2::layer_smem_bytes(ft); }

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
