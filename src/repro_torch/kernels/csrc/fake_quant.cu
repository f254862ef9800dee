// Host launchers of the GCN's fake quantization, with a plain C interface
// for ctypes (no PyTorch headers, so nvcc builds this in seconds):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfake_quant.so fake_quant.cu
//
// Every launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it does not take. The caller allocates the output (zeroed
// where k ≥ 1), the State workspace (fq_state_words() 32-bit words, zeroed
// before every call) and the scratch buffer of 2 · cap words (the bits and
// the positions of up to cap elements). See fake_quant_kernels.cuh for
// what the kernels compute and how.
//
//   fq_fake_quant        x fp32 (n,) → out fp32 (n,)
//   fq_fake_quant_bf16   x bf16 (n,) → out bf16 (n,)
//
// k = 0 takes max |x|; 1 ≤ k ≤ n the k-th largest |x|. qmax, lo and hi are
// the clip's bounds as the caller's ops see them (qmax, −qmax − 1, qmax in
// fp32). The launches: k = 0 max_pass then quantize; else one select_pass
// per digit (fq_passes) then quantize.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fake_quant_kernels.cuh"

namespace {

// One wave of `kernel`'s blocks, no more than `work` blocks' worth.
template <typename K>
int wave(K kernel, long long work, int smem, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, fq::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
    *blocks = (int)(work < 1 ? 1 : work < full ? work : full);
    return 0;
}

template <typename T>
int launch(const T* x, T* out, long long n, float qmax, float lo, float hi, long long k, unsigned* state,
           unsigned* scratch, long long cap, void* stream) {
    if (n < 1 || n >= (1ll << 31) || k < 0 || k > n || cap < 0 || cap > n) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    fq::State* st = reinterpret_cast<fq::State*>(state);
    const int vec = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 ? 1 : 0;
    const long long per_block = (long long)fq::THREADS * fq::LANE_VECS * fq::Elem<T>::PER_VEC;   // elements a step
    const long long steps = (n + per_block - 1) / per_block;
    constexpr int smem = fq::smem_bytes<T>();
    int blocks = 0, err = 0;
    if (k == 0) {
        if ((err = wave(fq::max_pass<T>, steps, fq::WARPS * 4, &blocks))) return err;
        fq::max_pass<T><<<blocks, fq::THREADS, fq::WARPS * 4, s>>>(x, n, vec, st);
        if ((err = (int)cudaGetLastError())) return err;
    } else {
        if ((err = wave(fq::select_pass<T>, steps, smem, &blocks))) return err;
        for (int p = 0; p < fq::digit_passes(fq::Elem<T>::KEY_BITS); ++p) {
            fq::select_pass<T><<<blocks, fq::THREADS, smem, s>>>(x, n, vec, scratch, (unsigned)cap, st, p, (unsigned)k);
            if ((err = (int)cudaGetLastError())) return err;
        }
    }
    const long long vecs = (n + fq::Elem<T>::PER_VEC - 1) / fq::Elem<T>::PER_VEC;
    if ((err = wave(fq::quantize<T>, (vecs + 2 * fq::THREADS - 1) / (2 * fq::THREADS), 0, &blocks))) return err;
    fq::quantize<T><<<blocks, fq::THREADS, 0, s>>>(x, out, n, vec, st, qmax, lo, hi, scratch, (unsigned)cap,
                                                   k > 0 ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fq_fake_quant(const float* x, float* out, long long n, float qmax, float lo, float hi, long long k,
                  unsigned* state, unsigned* scratch, long long cap, void* stream) {
    return launch(x, out, n, qmax, lo, hi, k, state, scratch, cap, stream);
}
int fq_fake_quant_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, long long n, float qmax, float lo, float hi,
                       long long k, unsigned* state, unsigned* scratch, long long cap, void* stream) {
    return launch(x, out, n, qmax, lo, hi, k, state, scratch, cap, stream);
}

// The State workspace in 32-bit words, and the digit passes of a key of
// elem bytes (4 fp32, 2 bf16), for the wrapper's checks.
long long fq_state_words() { return (long long)(sizeof(fq::State) / 4); }
int fq_passes(int elem) { return fq::digit_passes(elem == 2 ? 15 : 31); }

const char* fq_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
