// Host launchers of the LM's flash attention (K4), with a plain C interface
// for ctypes (no PyTorch headers, so nvcc builds this in seconds):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// Every launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the kernel does not take (d not a multiple of 4, d > k4::MAX_D, S or
// BH below 1, BH not a multiple of groups). The output buffer is allocated by
// the caller. See flash_attention_kernels.cuh for what the kernel computes.
//
//   k4_flash_attention        q fp32 (BH, S, d), k/v fp32 (BH/groups, S, d) → out fp32 (BH, S, d)
//   k4_flash_attention_bf16   the same in bf16, fp32 inside

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_kernels.cuh"

namespace {

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int BH, int S, int d, int groups, int window,
           int causal, float scale, void* stream) {
    if (S < 1 || BH < 1 || groups < 1 || BH % groups != 0 || d < 4 || d % 4 != 0 || d > k4::MAX_D)
        return (int)cudaErrorInvalidValue;
    const long long smem = k4::smem_bytes(d);
    static bool opted_in = false;          // one per instantiation
    if (!opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            k4::flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)k4::smem_bytes(k4::MAX_D));
        if (err != cudaSuccess) return (int)err;
        opted_in = true;
    }
    const long long blocks = (long long)BH * ((S + k4::BQ - 1) / k4::BQ);
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    k4::flash_attention_kernel<T><<<(unsigned)blocks, k4::THREADS, smem, (cudaStream_t)stream>>>(
        q, k, v, out, S, d, groups, k4::clamp_window(window, S), causal, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k4_flash_attention(const float* q, const float* k, const float* v, float* out, int BH, int S, int d,
                       int groups, int window, int causal, float scale, void* stream) {
    return launch(q, k, v, out, BH, S, d, groups, window, causal, scale, stream);
}
int k4_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                            __nv_bfloat16* out, int BH, int S, int d, int groups, int window, int causal,
                            float scale, void* stream) {
    return launch(q, k, v, out, BH, S, d, groups, window, causal, scale, stream);
}

// The tile sizes and the dynamic shared memory of one block, for the
// wrapper's checks.
int k4_block_rows() { return k4::BQ; }
int k4_tile_keys() { return k4::BK; }
int k4_max_d() { return k4::MAX_D; }
long long k4_smem_bytes(int d) { return k4::smem_bytes(d); }

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
