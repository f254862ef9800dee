// Device code of DeepFM's second-order FM term for Hopper (K3), which
// replaces `repro/kernels/fm_interaction.py::fm_interaction_pallas`.
//
//   out[b] = ½ · Σ_d [ (Σ_f e[b, f, d])² − Σ_f e[b, f, d]² ]
//
// over emb (B, F, D), row-major and contiguous, in fp32 or bf16 (template
// argument T); sums and products in IEEE fp32, the output rounded once to T.
// Every product is rounded on its own (__fmul_rn: never contracted into a
// fused multiply-add), as the reference's separate `e * e` and `s * s - sq`
// are, so one field gives exactly zero, as there.
//
// What bounds it: bytes. Every element is read once and takes three
// operations (an add to the field sum, a square, an add to the sum of
// squares), far below the card's ratio of operations to bytes; the least
// time is B·F·D·sizeof(T) over the HBM rate.
//
// Layout and design. One example is F·D contiguous values (DeepFM: 39 · 10 =
// 390 floats, 1,560 B: 8-byte but not 16-byte aligned), and D = 10 is no
// warp width, so one thread per d reading from device memory would leave
// most lanes idle and read with a stride. Instead each block owns a tile of
// `bt` consecutive examples, which is one contiguous run of bt·F·D values
// when the whole example fits in a chunk, and
//   1. stages it into shared memory with all threads on consecutive
//      addresses (coalesced), widening bf16 to fp32 as it goes;
//   2. gives one thread to each (example, d) pair of the tile (bt·D ≤ the
//      block's threads where D allows): it walks the F fields in shared
//      memory, accumulating the field sum and the sum of squares;
//   3. reduces the D terms s² − q of each example in shared memory, in
//      order, one thread per example, and writes the output.
// An example larger than the stage is taken `fc` fields at a time; the pair
// accumulators then live in shared memory across chunks. Nothing crosses
// blocks: no atomics, and the result does not depend on the launch.
//
// This file holds device code only and includes no header: fm_interaction.cu
// includes <cuda_bf16.h> before it, and a host-compiler check may include it
// after stand-ins for the built-ins it uses.

#pragma once

namespace k3 {

constexpr int THREADS = 256;           // threads per block
constexpr int BUDGET = 12 * 1024;      // fp32 words of shared memory per block (48 KB: no opt-in)
constexpr int MAX_D = BUDGET / 3;      // widest D the tiling takes (one field + two accumulators)

// The tile of one block: bt examples, taken fc fields at a time.
struct Tile {
    int bt, fc;
};

// bt·D ≤ THREADS where D allows (one pair per thread), and the staged chunk
// (bt·fc·D) plus the pair accumulators (2·bt·D) within BUDGET words. A
// D > MAX_D gives bt = fc = 0: the launcher refuses it.
__host__ __device__ inline Tile tile_for(int F, int D) {
    if (D > MAX_D || F < 1 || D < 1) return {0, 0};
    int bt = THREADS / D;
    const int fit = BUDGET / (F * D + 2 * D);
    if (fit < bt) bt = fit;
    if (bt >= 1) return {bt, F};
    const int fc = BUDGET / D - 2;
    return {1, fc < F ? fc : F};
}

// Dynamic shared memory of one block: the staged chunk and the two pair
// accumulators, in fp32 words.
__host__ __device__ inline long long smem_bytes(int F, int D) {
    const Tile t = tile_for(F, D);
    return 4LL * ((long long)t.bt * t.fc * D + 2LL * t.bt * D);
}

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> struct Narrow;
template <> struct Narrow<float> {
    __device__ static float from(float v) { return v; }
};
template <> struct Narrow<__nv_bfloat16> {
    __device__ static __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fm_interaction_kernel(const T* __restrict__ emb, T* __restrict__ out, int B, int F, int D, int bt, int fc) {
    extern __shared__ float smem_dyn[];
    float* stage = smem_dyn;                              // (bt, fc, D) of this chunk
    float* acc_s = stage + (long long)bt * fc * D;        // (bt, D) field sums
    float* acc_q = acc_s + bt * D;                        // (bt, D) sums of squares

    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * bt;
    const int nb = (int)((B - b0) < bt ? (B - b0) : bt);  // examples of this tile (the last may be short)
    const long long row = (long long)F * D;               // values per example
    const int pairs = nb * D;

    for (int f0 = 0; f0 < F; f0 += fc) {
        const int nf = F - f0 < fc ? F - f0 : fc;
        const int chunk = nf * D;                         // values of one example in this chunk
        const int n = nb * chunk;
        if (nf == F) {
            // Whole examples: the tile is one contiguous run of memory.
            const T* src = emb + b0 * row;
            for (int i = tid; i < n; i += THREADS) stage[i] = widen(src[i]);
        } else {
            for (int i = tid; i < n; i += THREADS) {
                const int b = i / chunk;
                stage[i] = widen(emb[(b0 + b) * row + (long long)f0 * D + (i - b * chunk)]);
            }
        }
        __syncthreads();
        for (int p = tid; p < pairs; p += THREADS) {
            const int b = p / D;
            const int d = p - b * D;
            float s = f0 == 0 ? 0.0f : acc_s[p];
            float q = f0 == 0 ? 0.0f : acc_q[p];
            const float* col = stage + b * chunk + d;
            for (int f = 0; f < nf; ++f) {
                const float v = col[f * D];
                s += v;
                q += __fmul_rn(v, v);
            }
            acc_s[p] = s;
            acc_q[p] = q;
        }
        __syncthreads();
    }
    // s² − q per pair, then the D terms of each example summed in order.
    for (int p = tid; p < pairs; p += THREADS) acc_s[p] = __fmul_rn(acc_s[p], acc_s[p]) - acc_q[p];
    __syncthreads();
    for (int b = tid; b < nb; b += THREADS) {
        float total = 0.0f;
        for (int d = 0; d < D; ++d) total += acc_s[b * D + d];
        out[b0 + b] = Narrow<T>::from(0.5f * total);
    }
}

}  // namespace k3
