// Device code of the LM's flash attention for Hopper (K4), which replaces
// `repro/kernels/flash_attention.py::flash_attention_pallas`: causal and
// sliding-window online-softmax attention, forward only.
//
//   out[bh, i] = Σ_j softmax_j(s[i, j]) · v[bh / G, j],
//   s[i, j]    = (q[bh, i] · k[bh / G, j]) · d^-0.5   if k > i − window (and j ≤ i when causal)
//              = −1e30                                 otherwise
//
// over q (BH, S, d) and k, v (BH / G, S, d), row-major and contiguous, in fp32
// or bf16 (template argument T): every product and sum in IEEE fp32, the
// output rounded once to T. G is the number of query heads that share one
// key/value head (grouped-query attention): query row bh reads key/value row
// bh / G, which for the layout b·H + h is b·Hk + h / G, so the key/value heads
// are never copied out per group. A masked score is −1e30, not −∞, as in the
// TPU kernel: a row with no valid key at all (window ≤ 0 when causal) gets
// p = 1 for every key and so averages v over all S keys, as the dense
// reference's softmax does.
//
// What bounds it: operations. Each valid (query, key) pair costs 4·d
// operations (two d-long dot products), against 4·d·sizeof(T) bytes per row
// read once; at d = 240 and S = 4,096 that is ~1,000 operations per byte of
// fp32, above the card's ratio for the CUDA cores (67 TFLOP/s over
// 3.35 TB/s = 20). This first kernel runs on the CUDA cores in fp32 for both
// types; the tensor cores (mma / wgmma) for bf16 are later work.
//
// Design. The TPU grid (BH, S/bq, S/bk) carries the running max m, the
// normaliser l and the accumulator in VMEM from one k-step to the next. Here
// one block owns one (bh, q-tile of BQ = 64 rows) and loops over the k-tiles
// of BK = 32 keys itself; nothing crosses blocks. Per k-tile:
//   1. stage the K tile in shared memory (rows padded to d + 4 floats, which
//      keeps the 16-byte reads of eight neighbouring rows on distinct banks);
//   2. S = Q·Kᵀ: each of the 256 threads computes a 4 × 2 register tile
//      (rows ty + 16r, columns tx + 16c) with 16-byte reads along d, scales
//      and masks it, and writes it to a score tile in shared memory;
//   3. one thread per query row takes the new max, turns the row into
//      p = exp(s − m_new), sums it, and keeps m, l and the rescale
//      exp(m − m_new) in shared memory;
//   4. stage the V tile into the same buffer (K is no longer read) and add
//      p·V to the accumulator, which stays in registers: each thread owns
//      rows ty + 16r and columns 4·tx + 64m .. + 3 (m < 4, so d ≤ 256).
// Q (64 × 244 floats at d = 240), the K/V buffer (32 × 244) and the score
// tile take 101 KB, so two blocks share an SM. The last q-tile and k-tile may
// be short (any S): rows past S are staged as zeros and never written, and
// keys past S get a score of −∞, so p = 0 there and they are not counted
// among "all keys" of a row without a valid one. The q-tiles run heaviest
// first (the last q-tile has the most keys under the causal mask).
//
// Skipped k-tiles. The TPU kernel visits every k-block. When causal and
// window ≥ 1, this one visits only the k-tiles that hold a valid pair for
// some row of its q-tile: from the tile of key q0 − window + 1 to the tile of
// the last row's own key. Every row then has its own key as a valid one, so
// a skipped tile's terms are either zero already (exp(−1e30 − m) = 0 after a
// valid key) or are zeroed by the first valid key's rescale
// exp(−1e30 − m_new) = 0; the result is the same, except when a masked key's
// k or v holds NaN or ∞ (0 · ∞ is NaN in the TPU kernel, and such a key is
// not read here). With window < 1, or when not causal, every k-tile is
// visited. At S = 32,768 this removes about half of a global layer's work and
// 31/32 of a local (window 1,024) layer's.
//
// This file holds device code only and includes no header:
// flash_attention.cu includes <cuda_bf16.h> before it, and a host-compiler
// check may include it after stand-ins for the built-ins it uses.

#pragma once

namespace k4 {

constexpr int THREADS = 256;           // 16 × 16
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per k-tile
constexpr int MAX_D = 256;             // 4 column groups of 64 per thread
constexpr float MASKED = -1e30f;       // the TPU kernel's NEG_INF

// Floats per staged row: d + 4 keeps float4 alignment (d % 4 == 0) and puts
// the rows of eight neighbouring threads on distinct 16-byte bank groups.
__host__ __device__ inline int row_stride(int d) { return d + 4; }

// Dynamic shared memory of one block: Q, the K/V buffer, the score tile
// (padded to BK + 1 columns) and m, l and the rescale per row.
__host__ __device__ inline long long smem_bytes(int d) {
    return 4LL * ((long long)(BQ + BK) * row_stride(d) + BQ * (BK + 1) + 3 * BQ);
}

// A window past ±S means the same as ±S; clamping keeps q − window in int32.
__host__ __device__ inline int clamp_window(int window, int S) {
    return window > S ? S : (window < -S ? -S : window);
}

// The k-tiles [*begin, *end) a q-tile at q0 visits (see "Skipped k-tiles").
__host__ __device__ inline void k_tiles(int q0, int S, int window, int causal, int* begin, int* end) {
    *begin = 0;
    *end = (S + BK - 1) / BK;
    if (causal && window >= 1) {
        const int last = q0 + BQ - 1 < S - 1 ? q0 + BQ - 1 : S - 1;
        const int first = q0 - window + 1;
        *end = last / BK + 1;
        *begin = first > 0 ? first / BK : 0;
    }
}

__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) {
    float4 r;
    r.x = __bfloat162float(p[0]);
    r.y = __bfloat162float(p[1]);
    r.z = __bfloat162float(p[2]);
    r.w = __bfloat162float(p[3]);
    return r;
}

__device__ inline void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ inline void store4(__nv_bfloat16* p, float4 v) {
    p[0] = __float2bfloat16_rn(v.x);
    p[1] = __float2bfloat16_rn(v.y);
    p[2] = __float2bfloat16_rn(v.z);
    p[3] = __float2bfloat16_rn(v.w);
}

// Rows [r0, r0 + n) of src (S rows of d values) into dst (n rows of
// row_stride(d) floats), widened to fp32; rows past S are zeros. Consecutive
// threads take consecutive 4-value pieces of a row (coalesced).
template <typename T>
__device__ inline void stage(float* dst, const T* src, int r0, int n, int S, int d) {
    const int d4 = d / 4;
    const int dp = row_stride(d);
    for (int i = threadIdx.x; i < n * d4; i += THREADS) {
        const int r = i / d4;
        const int c = (i - r * d4) * 4;
        float4 val = {0.0f, 0.0f, 0.0f, 0.0f};
        if (r0 + r < S) val = load4(src + (long long)(r0 + r) * d + c);
        store4(dst + r * dp + c, val);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int S, int d, int groups, int window, int causal, float scale) {
    extern __shared__ float4 k4_smem[];
    float* qs = reinterpret_cast<float*>(k4_smem);        // (BQ, dp)
    const int dp = row_stride(d);
    float* kv = qs + BQ * dp;                             // (BK, dp): K, then V
    float* ps = kv + BK * dp;                             // (BQ, BK + 1) scores, then p
    float* m_s = ps + BQ * (BK + 1);                      // running max per row
    float* l_s = m_s + BQ;                                // running normaliser per row
    float* a_s = l_s + BQ;                                // this k-tile's rescale per row

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int n_qt = (S + BQ - 1) / BQ;
    const long long bh = blockIdx.x / n_qt;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * BQ;    // heaviest q-tile first
    const T* qb = q + bh * S * d;
    const T* kb = k + (bh / groups) * S * d;
    const T* vb = v + (bh / groups) * S * d;

    stage(qs, qb, q0, BQ, S, d);
    if (tid < BQ) {
        m_s[tid] = MASKED;
        l_s[tid] = 0.0f;
    }
    float acc[4][4][4];
    for (int r = 0; r < 4; ++r)
        for (int m = 0; m < 4; ++m)
            for (int c = 0; c < 4; ++c) acc[r][m][c] = 0.0f;

    int kt_begin, kt_end;
    k_tiles(q0, S, window, causal, &kt_begin, &kt_end);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                                  // the last tile's V reads are done
        stage(kv, kb, k0, BK, S, d);
        __syncthreads();

        // 2. scores of rows ty + 16r, keys tx + 16c
        float s[4][2];
        for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.0f;
        for (int x = 0; x < d; x += 4) {
            float4 a[4], b[2];
            for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * dp + x);
            for (int c = 0; c < 2; ++c) b[c] = *reinterpret_cast<const float4*>(kv + (tx + 16 * c) * dp + x);
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 2; ++c)
                    s[r][c] += a[r].x * b[c].x + a[r].y * b[c].y + a[r].z * b[c].z + a[r].w * b[c].w;
        }
        for (int r = 0; r < 4; ++r) {
            const int qi = q0 + ty + 16 * r;
            for (int c = 0; c < 2; ++c) {
                const int kj = k0 + tx + 16 * c;
                float val;
                if (kj >= S) {
                    val = -INFINITY;                      // no key: p = 0 whatever the row's max
                } else {
                    const bool valid = kj > qi - window && (!causal || kj <= qi);
                    val = valid ? s[r][c] * scale : MASKED;
                }
                ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] = val;
            }
        }
        __syncthreads();

        // 3. online softmax, one thread per row
        if (tid < BQ) {
            float* row = ps + tid * (BK + 1);
            const float m_old = m_s[tid];
            float m_new = m_old;
            for (int j = 0; j < BK; ++j) m_new = fmaxf(m_new, row[j]);
            float sum = 0.0f;
            for (int j = 0; j < BK; ++j) {
                const float p = expf(row[j] - m_new);
                row[j] = p;
                sum += p;
            }
            const float a = expf(m_old - m_new);
            l_s[tid] = l_s[tid] * a + sum;
            m_s[tid] = m_new;
            a_s[tid] = a;
        }
        __syncthreads();

        // 4. acc = acc · rescale + p · V
        stage(kv, vb, k0, BK, S, d);
        __syncthreads();
        for (int r = 0; r < 4; ++r) {
            const float a = a_s[ty + 16 * r];
            for (int m = 0; m < 4; ++m)
                for (int c = 0; c < 4; ++c) acc[r][m][c] *= a;
        }
        for (int j = 0; j < BK; ++j) {
            float p[4];
            for (int r = 0; r < 4; ++r) p[r] = ps[(ty + 16 * r) * (BK + 1) + j];
            for (int m = 0; m < 4; ++m) {
                const int col = 4 * tx + 64 * m;
                if (col < d) {
                    const float4 w = *reinterpret_cast<const float4*>(kv + j * dp + col);
                    for (int r = 0; r < 4; ++r) {
                        acc[r][m][0] += p[r] * w.x;
                        acc[r][m][1] += p[r] * w.y;
                        acc[r][m][2] += p[r] * w.z;
                        acc[r][m][3] += p[r] * w.w;
                    }
                }
            }
        }
    }

    // out = acc / max(l, 1e-30), rows past S not written
    for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
        if (q0 + row >= S) continue;
        const float l = fmaxf(l_s[row], 1e-30f);
        T* dst = out + (bh * S + q0 + row) * d;
        for (int m = 0; m < 4; ++m) {
            const int col = 4 * tx + 64 * m;
            if (col < d) {
                const float4 o = {acc[r][m][0] / l, acc[r][m][1] / l, acc[r][m][2] / l, acc[r][m][3] / l};
                store4(dst + col, o);
            }
        }
    }
}

}  // namespace k4
