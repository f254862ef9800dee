// Host launchers of DeepFM's FM interaction (K3), with a plain C interface
// for ctypes (no PyTorch headers, so nvcc builds this in seconds):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfm_interaction.so fm_interaction.cu
//
// Every launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the tiling does not take (D > k3::MAX_D). The output buffer is
// allocated by the caller. See fm_interaction_kernels.cuh for what the
// kernel computes.
//
//   k3_fm_interaction        emb fp32 (B, F, D) → out fp32 (B,)
//   k3_fm_interaction_bf16   emb bf16 (B, F, D) → out bf16 (B,), fp32 sums

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fm_interaction_kernels.cuh"

namespace {

template <typename T>
int launch(const T* emb, T* out, int B, int F, int D, void* stream) {
    const k3::Tile t = k3::tile_for(F, D);
    if (t.bt < 1 || B < 1) return (int)cudaErrorInvalidValue;
    const long long smem = k3::smem_bytes(F, D);
    const int blocks = (B + t.bt - 1) / t.bt;
    k3::fm_interaction_kernel<T><<<blocks, k3::THREADS, smem, (cudaStream_t)stream>>>(
        emb, out, B, F, D, t.bt, t.fc);
    return (int)cudaGetLastError();
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

// The tile one block takes (examples, fields per chunk) and its dynamic
// shared memory, for the wrapper's checks.
int k3_tile_examples(int F, int D) { return k3::tile_for(F, D).bt; }
int k3_tile_fields(int F, int D) { return k3::tile_for(F, D).fc; }
long long k3_smem_bytes(int F, int D) { return k3::smem_bytes(F, D); }

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
