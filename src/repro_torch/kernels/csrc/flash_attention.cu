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
// the caller; q, k, v and out start on 16-byte boundaries. See
// flash_attention_kernels.cuh for what the two bodies compute and how.
//
//   k4_flash_attention        q fp32 (BH, S, d), k/v fp32 (BH/groups, S, d) → out fp32 (BH, S, d);
//                             IEEE fp32 on the CUDA cores
//   k4_flash_attention_bf16   the same in bf16: Q·Kᵀ and P·V on the tensor cores (mma.sync),
//                             fp32 accumulators, softmax and p in fp32

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace k4 {
using namespace ptx;   // the PTX wrappers the kernel bodies call unqualified
}

#include "flash_attention_kernels.cuh"

namespace {

using Bf16Body = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int,
                          int, int, int, int, int, float);

// The bf16 body for each head width in steps of 16 columns (N16 = 1 .. 16).
constexpr Bf16Body BF16_BODIES[k4::MAX_D / 16] = {
    k4::flash_attention_bf16_kernel<1>,  k4::flash_attention_bf16_kernel<2>,  k4::flash_attention_bf16_kernel<3>,
    k4::flash_attention_bf16_kernel<4>,  k4::flash_attention_bf16_kernel<5>,  k4::flash_attention_bf16_kernel<6>,
    k4::flash_attention_bf16_kernel<7>,  k4::flash_attention_bf16_kernel<8>,  k4::flash_attention_bf16_kernel<9>,
    k4::flash_attention_bf16_kernel<10>, k4::flash_attention_bf16_kernel<11>, k4::flash_attention_bf16_kernel<12>,
    k4::flash_attention_bf16_kernel<13>, k4::flash_attention_bf16_kernel<14>, k4::flash_attention_bf16_kernel<15>,
    k4::flash_attention_bf16_kernel<16>};

// The body that runs head width d; 0 .. 15 name the bf16 instantiations, 16 the fp32 body.
int body_index(bool bf16, int d) { return bf16 ? k4::bf16_width(d) / 16 - 1 : k4::MAX_D / 16; }

const void* kernel_of(int body) {
    return body < k4::MAX_D / 16 ? reinterpret_cast<const void*>(BF16_BODIES[body])
                                 : reinterpret_cast<const void*>(k4::flash_attention_f32_kernel);
}

// Opt each body in to the dynamic shared memory of the widest head, once.
cudaError_t opt_in(bool bf16, int d) {
    static bool done[k4::MAX_D / 16 + 1] = {};
    const int body = body_index(bf16, d);
    if (done[body]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(kernel_of(body), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)k4::smem_bytes(k4::MAX_D, bf16));
    if (err == cudaSuccess) done[body] = true;
    return err;
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int BH, int S, int d, int groups, int window,
           int causal, float scale, void* stream) {
    constexpr bool bf16 = sizeof(T) == 2;
    if (S < 1 || BH < 1 || groups < 1 || BH % groups != 0 || d < 4 || d % 4 != 0 || d > k4::MAX_D)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = opt_in(bf16, d);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)BH * ((S + k4::block_rows(bf16) - 1) / k4::block_rows(bf16));
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)k4::smem_bytes(d, bf16);
    window = k4::clamp_window(window, S);
    if constexpr (bf16) {
        BF16_BODIES[body_index(true, d)]<<<(unsigned)blocks, k4::BF16_THREADS, smem, (cudaStream_t)stream>>>(
            q, k, v, out, BH, S, d, groups, window, causal, scale);
    } else {
        k4::flash_attention_f32_kernel<<<(unsigned)blocks, k4::F32_THREADS, smem, (cudaStream_t)stream>>>(
            q, k, v, out, BH, S, d, groups, window, causal, scale);
    }
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

// The tiles and the dynamic shared memory of one block of each body (bf16
// 0: the fp32 body, 1: the bf16 body), for the wrapper's checks.
int k4_block_rows(int bf16) { return k4::block_rows(bf16); }
int k4_tile_keys(int bf16) { return k4::tile_keys(bf16); }
int k4_block_threads(int bf16) { return k4::block_threads(bf16); }
int k4_max_d() { return k4::MAX_D; }
long long k4_smem_bytes(int d, int bf16) { return k4::smem_bytes(d, bf16); }

// What the compiler gave the body that runs head width d: registers a
// thread, local memory a thread (spills; 0 when none) and the blocks that fit
// an SM.
int k4_kernel_attributes(int bf16, int d, int* registers, long long* local_bytes, int* blocks_per_sm) {
    if (d < 4 || d % 4 != 0 || d > k4::MAX_D) return (int)cudaErrorInvalidValue;
    cudaError_t err = opt_in(bf16, d);
    if (err != cudaSuccess) return (int)err;
    const void* body = kernel_of(body_index(bf16, d));
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, body);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (long long)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, body,
                                                              k4::block_threads(bf16),
                                                              (size_t)k4::smem_bytes(d, bf16));
}

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
