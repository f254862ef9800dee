// Device code of the graph kernels for Hopper: the fused GCN layer (K2),
// which replaces `repro/kernels/fused_gcn.py::fused_gcn_layer_pallas`, and
// the ragged block-sparse product (K1), which replaces
// `repro/kernels/bsr_spmm.py::bsr_spmm_pallas`.
//
//   xw_kernel                 Z = X · W            (K2 feature-first, launch 1 of 2)
//   ragged_layer_kernel<0>    act(Ã · Z + b)        (K2 feature-first, launch 2 of 2)
//   ragged_layer_kernel<1>    act((Ã · X) · W + b)  (K2 aggregation-first, one launch)
//   ragged_layer_kernel<2>    Ã · Z                 (K1, one launch)
//
// Ã is the ragged 128×128 blocked adjacency: vals (R, T, 128, 128), cols
// (R, T) int32 block-column ids, lens (R,) int32 valid tiles per block-row.
// Tiles t >= lens[r] are padding and are never read.
//
// Element types. K2 takes fp32 or bf16 operands (the TPU kernel's
// bf16-operand mode, fused_gcn.py:57-59 and :88-90), as template arguments:
// TV for vals, TX for X (and the output), TW for W. Every operand is widened
// to fp32 as it is staged, all arithmetic is IEEE fp32 on the CUDA cores (no
// tensor cores, no TF32), and values are rounded (to nearest even) exactly
// where the TPU kernel rounds: feature-first Z = X·W to vals' type,
// aggregation-first Ã·X to W's type before the product with W, and the
// output to X's type. Bias and activation apply in fp32.
//
// K1 takes fp32 or bf16 vals with a Z of the same or bf16 type, and writes
// Z's type (the TPU kernel's out_shape). With a bf16 Z its output block is
// bf16 and the TPU kernel adds each tile's product into it
// (bsr_spmm.py:81-83), so the running sum is rounded after every tile:
// acc = bf16(acc + bf16(vals[r,t] · Z[cols[r,t]])), the tile product in
// fp32. The kernel does the same, holding the rounded sum in a second fp32
// accumulator.
//
// fp32 operands reach shared memory through asynchronous copies
// (__pipeline_memcpy_async, cp.async) into two stages: the copy of chunk
// q + 1 is in flight while the block computes on chunk q. bf16 operands are
// loaded and widened by the threads themselves (8 values per 16-byte load
// for the adjacency, one at a time for feature rows) into the same fp32
// stages, so the shared-memory layout, and with it the aggregation-first
// width limit, is that of fp32.
//
// This file holds device code only and includes no header: fused_gcn.cu
// includes <cuda_pipeline.h> and <cuda_bf16.h> before it, and a
// host-compiler check may include it after stand-ins for the built-ins it
// uses.

#pragma once

namespace k2 {

constexpr int TILE = 128;        // adjacency tile edge; one thread per tile row
constexpr int THREADS = 128;     // threads per block
constexpr int KC = 32;           // depth of one staged chunk
constexpr int CPT = TILE / KC;   // chunks per adjacency tile
constexpr int NC = 16;           // accumulator columns a thread holds in registers
constexpr int LDA = KC + 4;      // staged adjacency row stride: 16-byte rows, conflict-free float4 reads
constexpr int LDX = KC + 1;      // staged X row stride (xw_kernel): conflict-free scalar reads
constexpr int STAGES = 2;        // shared-memory stages of the copy pipeline

// Width of the per-block accumulator, padded to whole NC chunks.
__host__ __device__ inline int padded_width(int ft) { return (ft + NC - 1) / NC * NC; }

// Dynamic shared memory of ragged_layer_kernel for an accumulator of width
// ft: per stage an adjacency chunk and the source rows it multiplies, then
// the accumulator.
__host__ __device__ inline long long layer_smem_bytes(int ft) {
    const int ftp = padded_width(ft);
    return 4LL * (STAGES * (TILE * LDA + KC * ftp) + TILE * (ftp + 1));
}

// fp32 or not, for the element types (the header includes no <type_traits>).
template <typename T> struct is_f32 { static constexpr bool value = false; };
template <> struct is_f32<float> { static constexpr bool value = true; };

// Whether ragged_layer_kernel<MODE, ..., TO> rounds its running sum to TO
// after every tile: K1 with a bf16 output, as the TPU kernel does.
template <int MODE, typename TO> struct PerTileRound {
    static constexpr bool value = MODE == 2 && !is_f32<TO>::value;
};

// Dynamic shared memory of one ragged_layer_kernel<MODE, ..., TO> block: a
// per-tile-rounding block adds the rounded running sum (TILE × (ftp + 1)).
template <int MODE, typename TO>
__host__ __device__ inline long long kernel_smem_bytes(int ft) {
    return layer_smem_bytes(ft) + (PerTileRound<MODE, TO>::value ? 4LL * TILE * (padded_width(ft) + 1) : 0);
}

// Dynamic shared memory of xw_kernel: per stage a chunk of X and of W.
__host__ __device__ inline long long xw_smem_bytes() { return 4LL * STAGES * (TILE * LDX + KC * NC); }

// fp32 ↔ element type. bf16 rounds to nearest even, as torch's
// .to(torch.bfloat16) and JAX's astype do.
__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T's precision, kept in fp32.
template <typename T> __device__ inline float round_to(float v) { return to_f32(from_f32<T>(v)); }

// One element of global memory into an fp32 stage slot: an asynchronous
// 4-byte copy for fp32, a load and widening for bf16.
__device__ inline void stage1(float* dst, const float* src) { __pipeline_memcpy_async(dst, src, 4); }
__device__ inline void stage1(float* dst, const __nv_bfloat16* src) { *dst = __bfloat162float(*src); }

// Stage X[m0:m0+TILE, k0:k0+KC] and W[k0:k0+KC, n0:n0+NC] into one stage
// (fp32 elements asynchronously, bf16 ones widened in place); elements past
// the matrix edges are written as zeros.
template <typename TX, typename TW>
__device__ inline void xw_copy_chunk(const TX* __restrict__ x, const TW* __restrict__ w,
                                     long long m0, int n0, int k0, int M, int K, int N,
                                     float* xs, float* ws, int tid) {
    for (int i = tid; i < TILE * KC; i += THREADS) {   // each warp: KC consecutive elements of a row
        const int row = i / KC, col = i % KC;
        const long long m = m0 + row;
        const int k = k0 + col;
        if (m < M && k < K) stage1(xs + row * LDX + col, x + m * K + k);
        else xs[row * LDX + col] = 0.f;
    }
    for (int i = tid; i < KC * NC; i += THREADS) {
        const int kk = i / NC, c = i % NC;
        const int k = k0 + kk, n = n0 + c;
        if (k < K && n < N) stage1(ws + i, w + (long long)k * N + n);
        else ws[i] = 0.f;
    }
}

// Z[m, n0:n0+NC] = X[m, :] · W[:, n0:n0+NC], accumulated in fp32 and stored
// as TZ. One block owns TILE rows and NC output columns; thread i owns row
// m0+i and keeps its NC sums in registers. X (M, K), W (K, N), Z (M, N),
// all row-major.
template <typename TX, typename TW, typename TZ>
__global__ void __launch_bounds__(THREADS)
xw_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TZ* __restrict__ z,
          int M, int K, int N) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const long long m0 = (long long)blockIdx.x * TILE;
    const int n0 = blockIdx.y * NC;
    float* xs = smem;                    // STAGES × TILE × LDX
    float* ws = smem + STAGES * TILE * LDX;  // STAGES × KC × NC

    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;

    const int chunks = (K + KC - 1) / KC;
    if (chunks > 0) xw_copy_chunk(x, w, m0, n0, 0, M, K, N, xs, ws, tid);
    __pipeline_commit();
    for (int q = 0; q < chunks; ++q) {
        const int s = q & 1, next = s ^ 1;
        if (q + 1 < chunks)
            xw_copy_chunk(x, w, m0, n0, (q + 1) * KC, M, K, N, xs + next * TILE * LDX,
                          ws + next * KC * NC, tid);
        __pipeline_commit();
        __pipeline_wait_prior(1);        // chunk q has landed; q + 1 may still be in flight
        __syncthreads();
        const float* xrow = xs + s * TILE * LDX + tid * LDX;
        const float* wst = ws + s * KC * NC;
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
            const float a = xrow[kk];
            const float4* wv = reinterpret_cast<const float4*>(wst + kk * NC);
#pragma unroll
            for (int v = 0; v < NC / 4; ++v) {
                const float4 b = wv[v];
                acc[4 * v + 0] = fmaf(a, b.x, acc[4 * v + 0]);
                acc[4 * v + 1] = fmaf(a, b.y, acc[4 * v + 1]);
                acc[4 * v + 2] = fmaf(a, b.z, acc[4 * v + 2]);
                acc[4 * v + 3] = fmaf(a, b.w, acc[4 * v + 3]);
            }
        }
        __syncthreads();                 // stage s is refilled in the next iteration
    }
    const long long m = m0 + tid;
    if (m < M) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
            if (n0 + c < N) z[m * N + n0 + c] = from_f32<TZ>(acc[c]);
    }
}

// Stage the adjacency chunk rows[0:TILE] × [j0, j0+KC) of one tile: fp32
// moves in 16-byte asynchronous pieces (4 values), bf16 in 16-byte loads
// (8 values) widened to fp32. vals is 16-byte aligned and a chunk row is
// KC values, so every piece is aligned.
__device__ inline void stage_tile_chunk(const float* __restrict__ tile, int j0, float* as, int tid) {
    for (int i = tid; i < TILE * KC / 4; i += THREADS) {   // each warp: 4 rows × KC floats
        const int row = i / (KC / 4), c4 = 4 * (i % (KC / 4));
        __pipeline_memcpy_async(as + row * LDA + c4, tile + row * TILE + j0 + c4, 16);
    }
}
__device__ inline void stage_tile_chunk(const __nv_bfloat16* __restrict__ tile, int j0, float* as, int tid) {
    for (int i = tid; i < TILE * KC / 8; i += THREADS) {   // each warp: 8 rows × KC values
        const int row = i / (KC / 8), c8 = 8 * (i % (KC / 8));
        const float4 raw = *reinterpret_cast<const float4*>(tile + row * TILE + j0 + c8);
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
        float* dst = as + row * LDA + c8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(v[e]);
    }
}

// Stage chunk q of block-row r — columns [j0, j0+KC) of tile t = q / CPT
// and the KC source rows they multiply — into one stage. Source columns
// past the block's range or the source width are written as zeros.
template <typename TV, typename TS>
__device__ inline void layer_copy_chunk(const TV* __restrict__ vals, const int* __restrict__ cols,
                                        int r, int T, int n_src_blocks, const TS* __restrict__ src,
                                        int f_src, int ft, int ftp, int f0, int q,
                                        float* as, float* ss, int tid) {
    const int t = q / CPT, j0 = (q % CPT) * KC;
    int cb = cols[(long long)r * T + t];
    cb = cb < 0 ? 0 : (cb >= n_src_blocks ? n_src_blocks - 1 : cb);
    stage_tile_chunk(vals + ((long long)r * T + t) * (TILE * TILE), j0, as, tid);
    const TS* sblk = src + (long long)cb * TILE * f_src;
    for (int i = tid; i < KC * ftp; i += THREADS) {
        const int jj = i / ftp, cc = i % ftp;
        const int f = f0 + cc;
        if (cc < ft && f < f_src) stage1(ss + i, sblk + (long long)(j0 + jj) * f_src + f);
        else ss[i] = 0.f;
    }
}

// One block owns block-row r (TILE output rows) and, in MODE 0, the output
// columns [blockIdx.y·ft, blockIdx.y·ft + ft). It walks its own tiles
// t < lens[r] — the sequential grid axis of the TPU kernel becomes this loop,
// so nothing crosses blocks — and accumulates Ã[r, t] · src[cols[r, t]] in
// shared memory, thread i owning accumulator row i. A block-row with no tile
// still runs the epilogue and writes act(b) (zeros in MODE 2).
//
// MODE 0 (feature-first): src = Z (width f_src = f_out); out = act(acc + b).
// MODE 1 (aggregation-first): src = X (width f_src = ft = f_in);
//                             out = act(round_W(acc) · W + b), W (f_in, f_out).
// MODE 2 (K1, the plain product): src = Z (width f_src = f_out); out = acc,
//                             with no bias and no activation (w, b unused).
//                             With a bf16 output the running sum is rounded
//                             to bf16 after every tile (PerTileRound): acc
//                             then holds one tile's product, run the sum.
// TV, TS, TW, TO are the element types of vals, src, W and out; b is fp32.
//
// Column ids outside [0, n_src_blocks) are clamped and lens to [0, T], so a
// malformed table cannot read outside the operands; the host side
// (BlockedAdjacency.arrays) rejects such tables before they get here.
template <int MODE, typename TV, typename TS, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
ragged_layer_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                    const int* __restrict__ lens, int T, int n_src_blocks,
                    const TS* __restrict__ src, int f_src, int ft,
                    const TW* __restrict__ w, const float* __restrict__ b,
                    TO* __restrict__ out, int f_out, int relu) {
    extern __shared__ float smem[];
    const int ftp = padded_width(ft);
    const int ldc = ftp + 1;             // odd stride: each thread's row sits in its own banks
    float* as = smem;                                         // STAGES × TILE × LDA adjacency chunks
    float* ss = smem + STAGES * TILE * LDA;                   // STAGES × KC × ftp source rows
    float* acc = smem + STAGES * (TILE * LDA + KC * ftp);     // TILE × ldc accumulator
    constexpr bool per_tile = PerTileRound<MODE, TO>::value;
    float* run = acc + TILE * ldc;                            // TILE × ldc rounded sum (per_tile only)
    const int tid = threadIdx.x;
    const int r = blockIdx.x;
    const int f0 = blockIdx.y * ft;      // first source/output column of this block

    float* crow = acc + tid * ldc;       // this thread's accumulator row
    float* rrow = run + tid * ldc;       // and its rounded running sum (per_tile only)
    for (int c = 0; c < ldc; ++c) crow[c] = 0.f;
    if (per_tile)
        for (int c = 0; c < ldc; ++c) rrow[c] = 0.f;

    int n = lens[r];
    n = n < 0 ? 0 : (n > T ? T : n);
    const int chunks = n * CPT;
    if (chunks > 0)
        layer_copy_chunk(vals, cols, r, T, n_src_blocks, src, f_src, ft, ftp, f0, 0, as, ss, tid);
    __pipeline_commit();
    for (int q = 0; q < chunks; ++q) {
        const int s = q & 1, next = s ^ 1;
        if (q + 1 < chunks)
            layer_copy_chunk(vals, cols, r, T, n_src_blocks, src, f_src, ft, ftp, f0, q + 1,
                             as + next * TILE * LDA, ss + next * KC * ftp, tid);
        __pipeline_commit();
        __pipeline_wait_prior(1);        // chunk q has landed; q + 1 may still be in flight
        __syncthreads();
        const float* arow = as + s * TILE * LDA + tid * LDA;
        const float* sst = ss + s * KC * ftp;
        for (int fc = 0; fc < ftp; fc += NC) {
            float a_acc[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) a_acc[c] = crow[fc + c];
#pragma unroll 2
            for (int j4 = 0; j4 < KC; j4 += 4) {
                const float4 a4 = *reinterpret_cast<const float4*>(arow + j4);
                const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4* sv = reinterpret_cast<const float4*>(sst + (j4 + u) * ftp + fc);
#pragma unroll
                    for (int v = 0; v < NC / 4; ++v) {
                        const float4 e = sv[v];
                        a_acc[4 * v + 0] = fmaf(av[u], e.x, a_acc[4 * v + 0]);
                        a_acc[4 * v + 1] = fmaf(av[u], e.y, a_acc[4 * v + 1]);
                        a_acc[4 * v + 2] = fmaf(av[u], e.z, a_acc[4 * v + 2]);
                        a_acc[4 * v + 3] = fmaf(av[u], e.w, a_acc[4 * v + 3]);
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) crow[fc + c] = a_acc[c];
        }
        if (per_tile && q % CPT == CPT - 1) {
            // Tile q / CPT is complete: the TPU kernel's
            // out += dot(a, z).astype(out.dtype) in out's (bf16) type.
            for (int c = 0; c < ftp; ++c) {
                rrow[c] = round_to<TO>(rrow[c] + round_to<TO>(crow[c]));
                crow[c] = 0.f;
            }
        }
        __syncthreads();                 // stage s is refilled in the next iteration
    }

    TO* o = out + ((long long)r * TILE + tid) * f_out;
    if (MODE == 2) {
        const float* sum = per_tile ? rrow : crow;
        for (int c = 0; c < ft; ++c)
            if (f0 + c < f_out) o[f0 + c] = from_f32<TO>(sum[c]);
    } else if (MODE == 0) {
        for (int c = 0; c < ft; ++c) {
            const int f = f0 + c;
            if (f < f_out) {
                const float h = crow[c] + b[f];
                o[f] = from_f32<TO>(relu ? fmaxf(h, 0.f) : h);
            }
        }
    } else {
        for (int o0 = 0; o0 < f_out; o0 += NC) {
            float h[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) h[c] = 0.f;
            for (int k = 0; k < ft; ++k) {
                const float a = round_to<TW>(crow[k]);   // the TPU kernel's acc.astype(W.dtype)
                const TW* wrow = w + (long long)k * f_out + o0;
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    if (o0 + c < f_out) h[c] = fmaf(a, to_f32(wrow[c]), h[c]);
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (o0 + c < f_out) {
                    const float v = h[c] + b[o0 + c];
                    o[o0 + c] = from_f32<TO>(relu ? fmaxf(v, 0.f) : v);
                }
            }
        }
    }
}

}  // namespace k2
