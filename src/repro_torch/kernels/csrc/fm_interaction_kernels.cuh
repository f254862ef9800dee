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
// time is B·F·D·sizeof(T) over the HBM rate. At a small batch (serving, B =
// 512: 0.8 MB) the floor is a launch and one round trip to memory.
//
// Design. One example is F·D contiguous values (DeepFM: 39 · 10 fp32 =
// 1,560 B, 8-byte but not 16-byte aligned). A block of 256 threads owns a
// tile of bt consecutive examples, one contiguous run of memory:
//   1. Staging: every thread issues all its 16-byte cp.async copies of the
//      tile at once, so the whole tile is in flight together; a block
//      loops over its tiles (one wave of blocks) with two tiles in a ring,
//      the next tile in flight while the current one is summed. bt is a
//      multiple of u, the fewest examples whose bytes are a multiple of 16
//      (DeepFM: 2 in fp32, 4 in bf16), so every tile starts 16-byte
//      aligned; the last tile's tail under 16 bytes is copied by plain
//      loads. A tile that would pass STAGE_BYTES (an
//      example wider than the stage) is not staged: the pair pass reads it
//      from device memory, where consecutive lanes read consecutive d.
//   2. Pair pass: each example gets G = min(32, D rounded up to a power of
//      two) lanes of one warp; lane j walks the F fields of d = j, j + G,
//      … in order, accumulating the field sum s and the sum of squares q,
//      and adds s² − q of each of its d.
//   3. The D reduction: a butterfly of shuffles over the G lanes (a fixed
//      tree, so the same bits on every run); the example's first lane
//      writes ½ · total.
// The tile is chosen from B as well: at most one pass of the block (256 / G
// examples), and no more than B / COVER rounded up to u, so that a serving
// batch of 512 still spreads over 128 blocks. Each output is one example's
// sum in one warp, whatever block takes its tile: no atomics, the same bits
// on every run.
//
// This file holds device code only and includes no header: fm_interaction.cu
// includes <cuda_bf16.h> and ptx.cuh before it, and a host-compiler check
// may include it after stand-ins for the built-ins it uses.

#pragma once

namespace k3 {

constexpr int THREADS = 256;            // threads per block
constexpr int STAGE_BYTES = 48 * 1024;  // the largest staged tile (a block holds two)
constexpr int COVER = 128;              // blocks the grid reaches where B allows

// Lanes that share one example: D rounded up to a power of two, at most a warp.
__host__ __device__ inline int lanes_per_example(int D) {
    int g = 1;
    while (g < D && g < 32) g *= 2;
    return g;
}

// The fewest examples whose bytes (E each) are a multiple of 16.
__host__ __device__ inline int align_examples(long long E) {
    int u = 1;
    while ((E * u) % 16 != 0) u *= 2;
    return u;
}

// The tile of one block: bt examples, staged in shared memory or read in place.
struct Tile {
    int bt;
    bool staged;
};

// bt ≤ one pass of the block (THREADS / G examples), ≤ B / COVER rounded up
// to u, and, staged, a multiple of u within STAGE_BYTES. A shape outside the
// kernel (B, F or D below 1) gives bt = 0: the launcher refuses it.
__host__ __device__ inline Tile tile_for(long long B, int F, int D, int elem) {
    if (B < 1 || F < 1 || D < 1) return {0, false};
    const long long E = (long long)F * D * elem;
    const int u = align_examples(E);
    const bool staged = E * u <= STAGE_BYTES;
    long long bt = THREADS / lanes_per_example(D);
    if (staged && STAGE_BYTES / E / u * u < bt) bt = STAGE_BYTES / E / u * u;
    const long long cover = ((B + COVER - 1) / COVER + u - 1) / u * u;
    if (cover < bt) bt = cover;
    return {(int)bt, staged};
}

// Bytes of one staged tile of bt examples, in whole 16-byte pieces.
__host__ __device__ inline long long slot_bytes(int bt, int F, int D, int elem) {
    return ((long long)bt * F * D * elem + 15) / 16 * 16;
}

// Dynamic shared memory of one block: a ring of two staged tiles.
__host__ __device__ inline long long smem_bytes(long long B, int F, int D, int elem) {
    const Tile t = tile_for(B, F, D, elem);
    return t.staged ? 2 * slot_bytes(t.bt, F, D, elem) : 0;
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

// Steps 2 and 3 over the nb examples at src (shared or device memory).
template <typename T>
__device__ inline void pair_pass(const T* __restrict__ src, T* __restrict__ out, int nb, int F, int D) {
    const int G = lanes_per_example(D);
    const int slot = threadIdx.x / G, lg = threadIdx.x % G;
    const long long FD = (long long)F * D;
    for (int p0 = 0; p0 < nb; p0 += THREADS / G) {       // the same trip count in every lane
        const int b = p0 + slot;
        float t = 0.0f;
        if (b < nb) {
            for (int d = lg; d < D; d += G) {
                const T* col = src + b * FD + d;
                float s = 0.0f, q = 0.0f;
#pragma unroll 8
                for (int f = 0; f < F; ++f) {
                    const float v = widen(col[(long long)f * D]);
                    s += v;
                    q += __fmul_rn(v, v);
                }
                t += __fmul_rn(s, s) - q;
            }
        }
        for (int off = G / 2; off > 0; off /= 2) t += __shfl_xor_sync(0xffffffffu, t, off);
        if (b < nb && lg == 0) out[b] = Narrow<T>::from(0.5f * t);
    }
}

// Grid: at most one wave (blocks_per_sm · SMs blocks, the launcher's), each
// block taking tiles blockIdx.x, blockIdx.x + gridDim.x, …. Staged, a block
// keeps two tiles in a ring: the next tile's copies are in flight while it
// sums the current one.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fm_interaction_kernel(const T* __restrict__ emb, T* __restrict__ out, int B, int F, int D, int bt, int staged) {
    extern __shared__ float4 k3_stage[];
    const long long FD = (long long)F * D;
    const long long tiles = ((long long)B + bt - 1) / bt;
    const auto examples = [&](long long t) { return (int)(B - t * bt < bt ? B - t * bt : bt); };   // the last is short
    if (!staged) {
        for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
            pair_pass(emb + t * bt * FD, out + t * bt, examples(t), F, D);
        return;
    }
    unsigned char* ring = reinterpret_cast<unsigned char*>(k3_stage);
    const long long slot = slot_bytes(bt, F, D, (int)sizeof(T));
    // Tile t into ring slot `s`: 16-byte pieces by cp.async, the tail under 16 bytes by plain loads.
    const auto issue = [&](long long t, int s) {
        const long long n = examples(t) * FD;
        const T* src = emb + t * bt * FD;
        T* dst = reinterpret_cast<T*>(ring + s * slot);
        const long long pieces = n * (long long)sizeof(T) / 16;
        const unsigned char* s8 = reinterpret_cast<const unsigned char*>(src);
        unsigned char* d8 = reinterpret_cast<unsigned char*>(dst);
        for (long long i = threadIdx.x; i < pieces; i += THREADS) ptx::cp_async<16>(d8 + 16 * i, s8 + 16 * i, true);
        for (long long i = pieces * 16 / (long long)sizeof(T) + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
    };
    long long t = blockIdx.x;
    if (t < tiles) issue(t, 0);
    ptx::cp_async_commit();
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        if (t + gridDim.x < tiles) issue(t + gridDim.x, s ^ 1);
        ptx::cp_async_commit();
        ptx::cp_async_wait_group<1>();                  // tile t has landed (this thread's pieces)
        __syncthreads();                                // every thread's pieces and tail
        pair_pass<T>(reinterpret_cast<const T*>(ring + s * slot), out + t * bt, examples(t), F, D);
        __syncthreads();                                // slot s is refilled on the next step
    }
}

}  // namespace k3
