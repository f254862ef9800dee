// Host launchers of DeepFM's FM interaction (K3), with a plain C interface
// for ctypes (no PyTorch headers, so nvcc builds this in seconds):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfm_interaction.so fm_interaction.cu
//
// Every launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the kernel does not take (B, F or D below 1). The output buffer is
// allocated by the caller. See fm_interaction_kernels.cuh for what the
// kernel computes and how.
//
//   k3_fm_interaction        emb fp32 (B, F, D) → out fp32 (B,)
//   k3_fm_interaction_bf16   emb bf16 (B, F, D) → out bf16 (B,), fp32 sums

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"
#include "fm_interaction_kernels.cuh"

namespace {

template <typename T>
int launch(const T* emb, T* out, int B, int F, int D, void* stream) {
    const k3::Tile t = k3::tile_for(B, F, D, (int)sizeof(T));
    if (t.bt < 1) return (int)cudaErrorInvalidValue;
    const auto kernel = k3::fm_interaction_kernel<T>;
    // Staging copies 16-byte pieces from the tile's start: emb must start on a 16-byte boundary.
    const bool staged = t.staged && reinterpret_cast<std::uintptr_t>(emb) % 16 == 0;
    const long long smem = staged ? k3::smem_bytes(B, F, D, (int)sizeof(T)) : 0;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // One wave: the blocks that fit the card at once, no more than the tiles.
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, k3::THREADS, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = ((long long)B + t.bt - 1) / t.bt, wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    kernel<<<(int)(tiles < wave ? tiles : wave), k3::THREADS, smem, (cudaStream_t)stream>>>(emb, out, B, F, D, t.bt,
                                                                                           staged ? 1 : 0);
    return (int)cudaGetLastError();
}

// What the compiler gave one instantiation, and the blocks of it that fit an
// SM with `smem` bytes of dynamic shared memory.
template <typename T>
int attributes(long long smem, int* registers, long long* local_bytes, int* blocks_per_sm) {
    const auto kernel = k3::fm_interaction_kernel<T>;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (long long)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, k3::THREADS, (size_t)smem);
}

}  // namespace

extern "C" {

int k3_fm_interaction(const float* emb, float* out, int B, int F, int D, void* stream) {
    return launch(emb, out, B, F, D, stream);
}
int k3_fm_interaction_bf16(const __nv_bfloat16* emb, __nv_bfloat16* out, int B, int F, int D,
                           void* stream) {
    return launch(emb, out, B, F, D, stream);
}

// The tile one block takes (examples, whether staged) and its dynamic shared
// memory, for elements of elem bytes (4 fp32, 2 bf16), for the wrapper's checks.
int k3_tile_examples(int B, int F, int D, int elem) { return k3::tile_for(B, F, D, elem).bt; }
int k3_tile_staged(int B, int F, int D, int elem) { return k3::tile_for(B, F, D, elem).staged ? 1 : 0; }
long long k3_smem_bytes(int B, int F, int D, int elem) { return k3::smem_bytes(B, F, D, elem); }

// Registers, local memory (spills) and blocks per SM of the fp32 (bf16 = 0)
// or bf16 instantiation at the tile of (B, F, D).
int k3_attributes(int bf16, int B, int F, int D, int* registers, long long* local_bytes, int* blocks_per_sm) {
    const long long smem = k3::smem_bytes(B, F, D, bf16 ? 2 : 4);
    return bf16 ? attributes<__nv_bfloat16>(smem, registers, local_bytes, blocks_per_sm)
                : attributes<float>(smem, registers, local_bytes, blocks_per_sm);
}

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
