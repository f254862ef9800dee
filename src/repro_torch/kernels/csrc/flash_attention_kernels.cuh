// Device code of the LM's flash attention for Hopper (K4), which replaces
// `repro/kernels/flash_attention.py::flash_attention_pallas`: causal and
// sliding-window online-softmax attention, forward only.
//
//   out[bh, i] = Σ_j softmax_j(s[i, j]) · v[bh / G, j],
//   s[i, j]    = (q[bh, i] · k[bh / G, j]) · d^-0.5   if k > i − window (and j ≤ i when causal)
//              = −1e30                                 otherwise
//
// over q (BH, S, d) and k, v (BH / G, S, d), row-major and contiguous, in fp32
// (`flash_attention_f32_kernel`) or bf16 (`flash_attention_bf16_kernel`). G
// is the number of query heads that share one key/value head (grouped-query
// attention): query row bh reads key/value row bh / G, which for the layout
// b·H + h is b·Hk + h / G, so the key/value heads are never copied out per
// group. A masked score is −1e30, not −∞, as in the TPU kernel: a row with no
// valid key at all (window ≤ 0 when causal) gets p = 1 for every key and so
// averages v over all S keys, as the dense reference's softmax does. Keys past
// S score −∞ (p = 0), so they never count among "all keys". l is clamped at
// 1e-30, and the output is rounded once to the input's type.
//
// What bounds it: operations. Each valid (query, key) pair costs 4·d
// operations (two d-long dot products), against 4·d·sizeof(T) bytes per row
// read once; at d = 240 and S = 4,096 that is ~1,000 operations per byte of
// fp32 and ~500 of bf16, above the card's ratio for the CUDA cores
// (67 TFLOP/s over 3.35 TB/s = 20) and for the bf16 tensor cores (295).
//
// Both bodies. One block owns one (bh, q-tile) and loops over the k-tiles
// itself (the TPU grid's sequential k axis); nothing crosses blocks. Each warp
// owns 16 query rows end to end: their scores, running max m, normaliser l
// and output accumulator stay in its registers, and the softmax is spread
// over the lanes that hold a row, reduced with warp shuffles. Q stays in
// shared memory for the whole loop. K and V tiles arrive by cp.async in the
// order of FlashAttention-2: V_j's copy overlaps S = Q·K_jᵀ and the softmax,
// K_{j+1}'s copy overlaps P·V_j, with two __syncthreads per k-tile. Rows past
// S are zero-filled by the copy, never written back. Only k-tiles that hold a
// masked pair for some row of the block (the diagonal, the window's edge, the
// ragged end) test each element. Blocks run the heaviest q-tiles of every
// head first.
//
// bf16 body (tensor cores, mma.sync m16n8k16 with fp32 accumulators, fed by
// ldmatrix). 4 warps, BQ = 64 rows, BK = 64 keys, two blocks an SM. Rows of
// Q, K and V are padded to a multiple of 16 with zero columns plus 8 more
// (d = 240: 496 bytes), which keeps the eight rows of an ldmatrix on distinct
// bank groups. S = Q·Kᵀ is N16 = 15 k-steps of 16 at d = 240; P·V is 30
// n-tiles of 8, whose fp32 accumulator (120 registers a thread) rescales in
// place. N16 is a template argument (one instantiation per head width in
// steps of 16), so the accumulator holds exactly the head's columns and no
// loop is guarded. p stays fp32 where the reference keeps it: the row sum l
// is taken on the fp32 p, and the product with v carries p as P_hi + P_lo,
// two bf16 fragments (P_hi = bf16(p), P_lo = bf16(p − P_hi)) in two mma into
// the same fp32 sum, so p keeps 16 significant bits: rounding p to one bf16
// leaves only ~60 % of the outputs bit-equal to the fp32-inside result, the
// split ~99.7 %, for 1.5× the mma of a one-fragment design. mma.sync rather
// than wgmma: it needs no shared-memory descriptors or swizzled layouts, and
// its fragments have a stand-in that runs on the CPU.
//
// fp32 body (IEEE fp32 on the CUDA cores, no TF32). 8 warps, BQ = 128 rows,
// BK = 32 keys. Lane (rg = lane / 8, kl = lane % 8) of a warp owns rows
// rg + 4r (r < 4) of the warp's 16: it scores them against keys kl + 8c
// (c < 4), a 4 × 4 register tile fed by four 16-byte reads of Q and four of K
// per four values of d (64 FMAs per 8 reads), and accumulates their output in
// columns 4·(kl + 8m) .. + 3 (m < 8, so d ≤ 256), fed by one 16-byte read of
// p and eight of V per key (128 FMAs per 9 reads), all eight issued before
// the FMAs. Eight neighbouring rows of Q, K or V sit on distinct bank groups
// (rows padded to d + 4 floats). p goes through a per-warp tile in shared
// memory (rows padded to 20 floats). Q resident at 128 rows of d = 240 takes
// 122 KB, so with K, V and p one block fills an SM (203 KB): two would need
// 64-row q-tiles, which read every K and V tile twice as often.
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
// visited.
//
// This file holds device code only and includes no header:
// flash_attention.cu includes <cuda_bf16.h> and ptx.cuh (namespace ptx,
// brought into k4) before it, and a host-compiler check may include it after stand-ins for
// the built-ins and the PTX wrappers it uses.

#pragma once

namespace k4 {

constexpr int MAX_D = 256;                 // widest head either body takes
constexpr float MASKED = -1e30f;           // the TPU kernel's NEG_INF
constexpr unsigned FULL_MASK = 0xffffffffu;

// fp32 body: 8 warps × 16 rows, 32-key tiles.
constexpr int F32_THREADS = 256;
constexpr int F32_BQ = 128;
constexpr int F32_BK = 32;
constexpr int F32_P_STRIDE = 20;           // floats per key of a warp's p tile: 16 rows + 4

// bf16 body: 4 warps × 16 rows, 64-key tiles.
constexpr int BF16_THREADS = 128;
constexpr int BF16_BQ = 64;
constexpr int BF16_BK = 64;

__host__ __device__ inline int block_rows(bool bf16) { return bf16 ? BF16_BQ : F32_BQ; }
__host__ __device__ inline int tile_keys(bool bf16) { return bf16 ? BF16_BK : F32_BK; }
__host__ __device__ inline int block_threads(bool bf16) { return bf16 ? BF16_THREADS : F32_THREADS; }

// Elements per staged row. fp32: d + 4 keeps 16-byte alignment (d % 4 == 0)
// and puts eight neighbouring rows on distinct 16-byte bank groups. bf16: d
// rounded up to 16 (zero columns) + 8, an odd number of 16-byte groups.
__host__ __device__ inline int f32_row_stride(int d) { return d + 4; }
__host__ __device__ inline int bf16_width(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ inline int bf16_row_stride(int d) { return bf16_width(d) + 8; }

// Dynamic shared memory of one block: Q, K and V (and the fp32 body's p tiles).
__host__ __device__ inline long long smem_bytes(int d, bool bf16) {
    if (bf16) return 2LL * (BF16_BQ + 2 * BF16_BK) * bf16_row_stride(d);
    return 4LL * ((long long)(F32_BQ + 2 * F32_BK) * f32_row_stride(d) +
                  (F32_THREADS / 32) * F32_BK * F32_P_STRIDE);
}

// A window past ±S means the same as ±S; clamping keeps q − window in int32.
__host__ __device__ inline int clamp_window(int window, int S) {
    return window > S ? S : (window < -S ? -S : window);
}

// The k-tiles [*begin, *end) a q-tile of bq rows at q0 visits (see "Skipped k-tiles").
__host__ __device__ inline void k_tiles(int q0, int S, int window, int causal, int bq, int bk, int* begin,
                                        int* end) {
    *begin = 0;
    *end = (S + bk - 1) / bk;
    if (causal && window >= 1) {
        const int last = q0 + bq - 1 < S - 1 ? q0 + bq - 1 : S - 1;
        const int first = q0 - window + 1;
        *end = last / bk + 1;
        *begin = first > 0 ? first / bk : 0;
    }
}

// Whether some (row, key) of the q-tile at q0 and the k-tile at k0 is masked
// or past S; a tile without one needs no test per element.
__device__ inline bool tile_needs_mask(int q0, int k0, int S, int window, int causal, int bq, int bk) {
    return k0 + bk > S || (causal && k0 + bk - 1 > q0) || k0 <= q0 + bq - 1 - window;
}

// The masked and scaled score of row qi and key kj.
__device__ inline float masked_score(float s, int qi, int kj, int S, int window, int causal) {
    if (kj >= S) return -INFINITY;         // no key: p = 0 whatever the row's max
    return kj > qi - window && (!causal || kj <= qi) ? s : MASKED;
}

// Rows [r0, r0 + n) of src (S rows of d values) into dst (rows of `stride`
// elements) by cp.async in BYTES-byte pieces; rows past S are zero-filled.
// Consecutive threads take consecutive pieces of a row.
template <typename T, int THREADS, int BYTES>
__device__ inline void stage_pieces(T* dst, const T* src, int r0, int n, int S, int d, int stride) {
    constexpr int E = BYTES / sizeof(T);
    const int pieces = d / E;
    for (int i = threadIdx.x; i < n * pieces; i += THREADS) {
        const int r = i / pieces, c = (i - r * pieces) * E;
        const bool in = r0 + r < S;
        cp_async<BYTES>(dst + r * stride + c, src + (long long)(in ? r0 + r : 0) * d + c, in);
    }
}

// The same in 16-byte pieces, or 8-byte ones when a row is not a whole
// number of 16 bytes (bf16 with d % 8 == 4).
template <typename T, int THREADS>
__device__ inline void stage(T* dst, const T* src, int r0, int n, int S, int d, int stride) {
    if ((d * (int)sizeof(T)) % 16 == 0)
        stage_pieces<T, THREADS, 16>(dst, src, r0, n, S, d, stride);
    else
        stage_pieces<T, THREADS, 8>(dst, src, r0, n, S, d, stride);
}

// ------------------------------------------------------------------ fp32 body
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           float* __restrict__ out, int BH, int S, int d, int groups, int window, int causal,
                           float scale) {
    extern __shared__ float4 k4_smem[];
    const int dp = f32_row_stride(d);
    float* qs = reinterpret_cast<float*>(k4_smem);       // (BQ, dp)
    float* ks = qs + F32_BQ * dp;                         // (BK, dp)
    float* vs = ks + F32_BK * dp;                         // (BK, dp)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rg = lane / 8, kl = lane % 8;
    float* ps = vs + F32_BK * dp + warp * F32_BK * F32_P_STRIDE;   // this warp's p: (BK, 16 + 4)

    const int n_qt = (S + F32_BQ - 1) / F32_BQ;
    const long long bh = blockIdx.x % BH;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / BH)) * F32_BQ;   // heaviest q-tiles first
    const float* kb = k + (bh / groups) * S * d;
    const float* vb = v + (bh / groups) * S * d;

    int kt_begin, kt_end;
    k_tiles(q0, S, window, causal, F32_BQ, F32_BK, &kt_begin, &kt_end);
    stage<float, F32_THREADS>(qs, q + bh * S * d, q0, F32_BQ, S, d, dp);
    stage<float, F32_THREADS>(ks, kb, kt_begin * F32_BK, F32_BK, S, d, dp);
    cp_async_commit();

    float4 acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[r][m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float m_run[4], l_run[4];                             // l: this lane's share of the row sum
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m_run[r] = MASKED;
        l_run[r] = 0.0f;
    }
    const int d4 = d / 4;
    const int row_w = warp * 16 + rg;                     // the lane's rows: row_w + 4r
    const float* q_rows = qs + row_w * dp;
    const float* k_rows = ks + kl * dp;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * F32_BK;
        cp_async_wait_all();
        __syncthreads();                                  // K_kt has landed; every warp is done with V
        stage<float, F32_THREADS>(vs, vb, k0, F32_BK, S, d, dp);
        cp_async_commit();

        // S = Q·Kᵀ on rows row_w + 4r, keys kl + 8c
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
        for (int x = 0; x < d; x += 4) {
            float4 b[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(k_rows + 8 * c * dp + x);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 a = *reinterpret_cast<const float4*>(q_rows + 4 * r * dp + x);
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s[r][c] = fmaf(a.w, b[c].w, fmaf(a.z, b[c].z, fmaf(a.y, b[c].y, fmaf(a.x, b[c].x, s[r][c]))));
            }
        }
        const bool edge = tile_needs_mask(q0, k0, S, window, causal, F32_BQ, F32_BK);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[r][c] *= scale;
                if (edge) s[r][c] = masked_score(s[r][c], q0 + row_w + 4 * r, k0 + kl + 8 * c, S, window, causal);
            }

        // online softmax: a row's 32 keys lie on the 8 lanes of its group
        float alpha[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float mx = fmaxf(fmaxf(m_run[r], fmaxf(s[r][0], s[r][1])), fmaxf(s[r][2], s[r][3]));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 4));
            alpha[r] = expf(m_run[r] - mx);
            m_run[r] = mx;
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[r][c] = expf(s[r][c] - mx);
                sum += s[r][c];
            }
            l_run[r] = l_run[r] * alpha[r] + sum;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(ps + (kl + 8 * c) * F32_P_STRIDE + 4 * rg) =
                make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                acc[r][m].x *= alpha[r];
                acc[r][m].y *= alpha[r];
                acc[r][m].z *= alpha[r];
                acc[r][m].w *= alpha[r];
            }

        cp_async_wait_all();
        __syncthreads();                                  // V_kt and p have landed; every warp is done with K
        if (kt + 1 < kt_end) stage<float, F32_THREADS>(ks, kb, k0 + F32_BK, F32_BK, S, d, dp);
        cp_async_commit();

        // acc += p · V on rows row_w + 4r, columns 4·(kl + 8m). All eight
        // reads of a key are issued before its FMAs and none is predicated:
        // columns past d read padding or the next rows (inside the block's
        // shared memory) into accumulators that are never stored.
        const float* v_cols = vs + 4 * kl;
#pragma unroll 4
        for (int j = 0; j < F32_BK; ++j) {
            const float4 p = *reinterpret_cast<const float4*>(ps + j * F32_P_STRIDE + 4 * rg);
            float4 w[8];
#pragma unroll
            for (int m = 0; m < 8; ++m) w[m] = *reinterpret_cast<const float4*>(v_cols + j * dp + 32 * m);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    acc[r][m].x = fmaf(pr[r], w[m].x, acc[r][m].x);
                    acc[r][m].y = fmaf(pr[r], w[m].y, acc[r][m].y);
                    acc[r][m].z = fmaf(pr[r], w[m].z, acc[r][m].z);
                    acc[r][m].w = fmaf(pr[r], w[m].w, acc[r][m].w);
                }
        }
    }

    // out = acc / max(l, 1e-30), rows past S not written
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(FULL_MASK, l, 1);
        l += __shfl_xor_sync(FULL_MASK, l, 2);
        l += __shfl_xor_sync(FULL_MASK, l, 4);
        const int row = q0 + row_w + 4 * r;
        if (row >= S) continue;
        l = fmaxf(l, 1e-30f);
        float* dst = out + (bh * S + row) * d + 4 * kl;
#pragma unroll
        for (int m = 0; m < 8; ++m)
            if (kl + 8 * m < d4)
                *reinterpret_cast<float4*>(dst + 32 * m) =
                    make_float4(acc[r][m].x / l, acc[r][m].y / l, acc[r][m].z / l, acc[r][m].w / l);
    }
}

// ------------------------------------------------------------------ bf16 body
// Two floats as the .b32 of a bf16x2 fragment register (lo in the lower half),
// each rounded to nearest even.
__device__ inline unsigned pack_bf16x2(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// p0, p1 (fp32) as P_hi = bf16(p) and P_lo = bf16(p − P_hi), packed.
__device__ inline void split_bf16x2(float p0, float p1, unsigned* hi, unsigned* lo) {
    const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
    const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
    *hi = pack_bf16x2(h0, h1);
    *lo = pack_bf16x2(p0 - h0, p1 - h1);
}

// N16 = bf16_width(d) / 16: the k-steps of Q·Kᵀ and the pairs of 8-column
// n-tiles of P·V, a template argument so that the accumulator holds exactly
// the head's columns (d = 240: N16 = 15, 120 registers) and no loop is guarded.
template <int N16>
__global__ void __launch_bounds__(BF16_THREADS, 2)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int BH, int S,
                            int d, int groups, int window, int causal, float scale) {
    using bf16 = __nv_bfloat16;
    extern __shared__ float4 k4_smem[];
    const int dp = bf16_row_stride(d), dw = bf16_width(d);
    bf16* qs = reinterpret_cast<bf16*>(k4_smem);         // (BQ, dp)
    bf16* ks = qs + BF16_BQ * dp;                         // (BK, dp)
    bf16* vs = ks + BF16_BK * dp;                         // (BK, dp)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;

    const int n_qt = (S + BF16_BQ - 1) / BF16_BQ;
    const long long bh = blockIdx.x % BH;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / BH)) * BF16_BQ;  // heaviest q-tiles first
    const bf16* kb = k + (bh / groups) * S * d;
    const bf16* vb = v + (bh / groups) * S * d;

    if (dw > d) {                                         // zero columns d .. dw of Q, K and V
        const int pad = dw - d;
        for (int i = threadIdx.x; i < (BF16_BQ + 2 * BF16_BK) * pad; i += BF16_THREADS)
            qs[(i / pad) * dp + d + i % pad] = __float2bfloat16_rn(0.0f);
    }
    int kt_begin, kt_end;
    k_tiles(q0, S, window, causal, BF16_BQ, BF16_BK, &kt_begin, &kt_end);
    stage<bf16, BF16_THREADS>(qs, q + bh * S * d, q0, BF16_BQ, S, d, dp);
    stage<bf16, BF16_THREADS>(ks, kb, kt_begin * BF16_BK, BF16_BK, S, d, dp);
    cp_async_commit();

    constexpr int NT = 2 * N16;                           // 8-column tiles of the output
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.0f, 0.0f};   // rows g and g + 8; l: this lane's share
    const int row0 = q0 + warp * 16 + g;
    // ldmatrix row addresses: A from Q (rows of the warp, 16 columns), B
    // from K (keys 16 at a time, 16 columns of d), B from V transposed.
    const bf16* q_frag = qs + (warp * 16 + lane % 16) * dp + (lane / 16) * 8;
    const bf16* k_frag = ks + ((lane / 16) * 8 + lane % 8) * dp + ((lane / 8) % 2) * 8;
    const bf16* v_frag = vs + (((lane / 8) % 2) * 8 + lane % 8) * dp + (lane / 16) * 8;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BF16_BK;
        cp_async_wait_all();
        __syncthreads();                                  // K_kt has landed; every warp is done with V
        stage<bf16, BF16_THREADS>(vs, vb, k0, BF16_BK, S, d, dp);
        cp_async_commit();

        // S = Q·Kᵀ: 16 rows × 64 keys per warp, 8 n-tiles of 8 keys
        float s[BF16_BK / 8][4];
#pragma unroll
        for (int n = 0; n < BF16_BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < N16; ++kk) {
            unsigned a[4];
            ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
            for (int np = 0; np < BF16_BK / 16; ++np) {
                unsigned b[4];
                ldmatrix_x4(b, k_frag + np * 16 * dp + kk * 16);
                mma_bf16_16816(s[2 * np], a, b[0], b[1]);
                mma_bf16_16816(s[2 * np + 1], a, b[2], b[3]);
            }
        }
        const bool edge = tile_needs_mask(q0, k0, S, window, causal, BF16_BQ, BF16_BK);
#pragma unroll
        for (int n = 0; n < BF16_BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[n][e] *= scale;
                if (edge)
                    s[n][e] = masked_score(s[n][e], row0 + 8 * (e / 2), k0 + 8 * n + 2 * t + e % 2, S, window,
                                           causal);
            }

        // online softmax: a row's 64 keys lie on the 4 lanes of its quad
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = m_run[h];
#pragma unroll
            for (int n = 0; n < BF16_BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
            alpha[h] = expf(m_run[h] - mx);
            m_run[h] = mx;
            float sum = 0.0f;
#pragma unroll
            for (int n = 0; n < BF16_BK / 8; ++n) {
                s[n][2 * h] = expf(s[n][2 * h] - mx);
                s[n][2 * h + 1] = expf(s[n][2 * h + 1] - mx);
                sum += s[n][2 * h] + s[n][2 * h + 1];
            }
            l_run[h] = l_run[h] * alpha[h] + sum;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }

        cp_async_wait_all();
        __syncthreads();                                  // V_kt has landed; every warp is done with K
        if (kt + 1 < kt_end) stage<bf16, BF16_THREADS>(ks, kb, k0 + BF16_BK, BF16_BK, S, d, dp);
        cp_async_commit();

        // acc += (P_hi + P_lo) · V: the score accumulators of keys 16kk ..
        // 16kk + 15 are the A fragment of that k-step
#pragma unroll
        for (int kk = 0; kk < BF16_BK / 16; ++kk) {
            unsigned hi[4], lo[4];
            split_bf16x2(s[2 * kk][0], s[2 * kk][1], &hi[0], &lo[0]);
            split_bf16x2(s[2 * kk][2], s[2 * kk][3], &hi[1], &lo[1]);
            split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], &hi[2], &lo[2]);
            split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], &hi[3], &lo[3]);
#pragma unroll
            for (int np = 0; np < N16; ++np) {
                unsigned b[4];
                ldmatrix_x4_trans(b, v_frag + kk * 16 * dp + np * 16);
                mma_bf16_16816(acc[2 * np], hi, b[0], b[1]);
                mma_bf16_16816(acc[2 * np], lo, b[0], b[1]);
                mma_bf16_16816(acc[2 * np + 1], hi, b[2], b[3]);
                mma_bf16_16816(acc[2 * np + 1], lo, b[2], b[3]);
            }
        }
    }

    // out = acc / max(l, 1e-30), rows past S and columns past d not written
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(FULL_MASK, l, 1);
        l += __shfl_xor_sync(FULL_MASK, l, 2);
        const int row = row0 + 8 * h;
        if (row >= S) continue;
        l = fmaxf(l, 1e-30f);
        bf16* dst = out + (bh * S + row) * d + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (8 * n + 2 * t < d) {
                dst[8 * n] = __float2bfloat16_rn(acc[n][2 * h] / l);
                dst[8 * n + 1] = __float2bfloat16_rn(acc[n][2 * h + 1] / l);
            }
        }
    }
}

}  // namespace k4
