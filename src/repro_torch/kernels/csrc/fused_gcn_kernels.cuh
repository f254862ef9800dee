// Device code of the graph kernels for Hopper: the fused GCN layer (K2),
// which replaces `repro/kernels/fused_gcn.py::fused_gcn_layer_pallas`, and
// the ragged block-sparse product (K1), which replaces
// `repro/kernels/bsr_spmm.py::bsr_spmm_pallas`.
//
//   xw_kernel                 Z = X · W            (K2 feature-first, launch 1 of 2; xw_kernel.cuh)
//   ragged_layer_kernel<0>    act(Ã · Z + b)        (K2 feature-first, launch 2 of 2)
//   ragged_layer_kernel<1>    act((Ã · X) · W + b)  (K2 aggregation-first, one launch)
//   ragged_layer_kernel<2>    Ã · Z                 (K1, one launch)
//
// Ã is the ragged 128×128 blocked adjacency: vals (R, T, 128, 128), cols
// (R, T) int32 block-column ids, lens (R,) int32 valid tiles per block-row.
// Tiles t >= lens[r] are padding and are never read. The ragged kernels take
// `ends`, the inclusive prefix sum of lens clamped to [0, T] (the wrapper
// computes it on the card), instead of lens.
//
// What bounds the ragged kernels: bytes. They must read every valid tile
// once (Nell: 11,662 fp32 tiles, 0.76 GB, 0.23 ms at 3.35 TB/s, against
// 6.1 GFLOP at F = 16). Block-rows are skewed (Nell: the longest holds 299
// tiles, the median 19), so a grid of one block per block-row finishes when
// its longest row does, with the card idle around it. The schedule below
// gives every block an even share of the valid tiles instead:
//
// * The valid tiles, ordered (r, t) with t < lens[r], are one sequence of
//   positions, and each row ends in row_weight more positions that stand
//   for its epilogue: row r holds positions [ends[r-1], ends[r]), ends the
//   inclusive prefix sum of lens + row_weight (so a block of many short
//   rows takes fewer of them, and an empty row has positions too). Of the
//   grid's gridDim.x blocks, the first G = min(gridDim.x, ⌊N / min_tiles⌋)
//   (at least one) take positions [⌊g·N/G⌋, ⌊(g+1)·N/G⌋) of the N; the rest
//   exit at once. A block finds its first row by binary search in ends and
//   streams its tiles through one cp.async pipeline across row boundaries.
// * A row whose positions one block holds is finished by that block. A row
//   split over blocks g_first..g_last is finished by the last of them to
//   arrive: each writes its fp32 partial (128 × ft; zeros if it holds none
//   of the row's tiles) to a workspace slot, fences, and adds one to the
//   row's arrival counter; the block that sees the final count adds the
//   partials in block order (so the bits do not depend on which block came
//   last) and runs the epilogue. The counters are zeroed by the caller for
//   each launch. No block waits for another, and no float is added
//   atomically. An empty block-row (lens[r] = 0) writes the epilogue of a
//   zero sum: act(b), or zeros in MODE 2.

// Element types. K2 takes fp32 or bf16 operands (the TPU kernel's
// bf16-operand mode, fused_gcn.py:57-59 and :88-90), as template arguments:
// TV for vals, TX for X (and the output), TW for W. Operands are widened to
// fp32 where the compute loop reads them, all arithmetic is IEEE fp32 on the
// CUDA cores (no TF32; only the dense transform's all-bf16 instantiation runs
// on the tensor cores, see xw_kernel.cuh), and values are rounded (to nearest
// even) exactly where the TPU kernel rounds: feature-first Z = X·W to vals'
// type, aggregation-first Ã·X to W's type before the product with W, and
// the output to X's type. Bias and activation apply in fp32.
//
// K1 takes fp32 or bf16 vals with a Z of the same or bf16 type, and writes
// Z's type (the TPU kernel's out_shape). With a bf16 Z its output block is
// bf16 and the TPU kernel adds each tile's product into it
// (bsr_spmm.py:81-83), so the running sum is rounded after every tile:
// acc = bf16(acc + bf16(vals[r,t] · Z[cols[r,t]])), the tile product in
// fp32. The chain must run in tile order, but each tile's product depends on
// nothing else: any block computes the products of its tiles. A row held
// whole runs the chain in the block; for a split row every block writes its
// tiles' rounded products to a workspace indexed by tile position, and the
// finishing block runs the chain over the whole row in order.
//
// Staging. Adjacency chunks (128 × 32) reach shared memory through cp.async
// (__pipeline_memcpy_async) two stages deep, fp32 in 16-byte pieces, bf16
// loaded 16 bytes at a time and widened. Source rows stay in their own type
// in the stage: 16-byte cp.async pieces (4 fp32 or 8 bf16 values) where the
// width allows, else one element at a time; the compute loop widens bf16
// rows as it reads them.
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
constexpr int STAGES = 2;        // shared-memory stages of the copy pipeline

// Width of the per-block accumulator, padded to whole NC chunks.
__host__ __device__ inline int padded_width(int ft) { return (ft + NC - 1) / NC * NC; }

// Dynamic shared memory of ragged_layer_kernel for an accumulator of width
// ft and source elements of src_bytes bytes: per stage an fp32 adjacency
// chunk and the KC source rows it multiplies (in their own type), then the
// fp32 accumulator.
__host__ __device__ inline long long layer_smem_bytes(int ft, int src_bytes = 4) {
    const int ftp = padded_width(ft);
    return 4LL * (STAGES * TILE * LDA + TILE * (ftp + 1)) + (long long)STAGES * KC * ftp * src_bytes;
}

// fp32 or not, for the element types (the header includes no <type_traits>).
template <typename T> struct is_f32 { static constexpr bool value = false; };
template <> struct is_f32<float> { static constexpr bool value = true; };

// Whether ragged_layer_kernel<MODE, ..., TO> rounds its running sum to TO
// after every tile: K1 with a bf16 output, as the TPU kernel does.
template <int MODE, typename TO> struct PerTileRound {
    static constexpr bool value = MODE == 2 && !is_f32<TO>::value;
};

// Dynamic shared memory of one ragged_layer_kernel<MODE, ..., TS, ..., TO>
// block: a per-tile-rounding block adds the rounded running sum
// (TILE × (ftp + 1)).
template <int MODE, typename TS, typename TO>
__host__ __device__ inline long long kernel_smem_bytes(int ft) {
    return layer_smem_bytes(ft, (int)sizeof(TS)) +
           (PerTileRound<MODE, TO>::value ? 4LL * TILE * (padded_width(ft) + 1) : 0);
}

// Blocks of a grid of `grid` that take tiles: at most grid, at least one,
// and no fewer than min_tiles positions each where n allows.
__host__ __device__ inline int split_blocks(long long n, int grid, int min_tiles) {
    const long long per = min_tiles < 1 ? 1 : min_tiles;
    const long long want = n / per;
    return (int)(want < 1 ? 1 : (want < grid ? want : grid));
}

// The block g of G whose positions [⌊g·N/G⌋, ⌊(g+1)·N/G⌋) hold pos (0 ≤ pos < N).
__host__ __device__ inline int owner_block(long long pos, long long n, long long g) {
    return (int)(((pos + 1) * g + n - 1) / n - 1);
}

// fp32 ↔ element type. bf16 rounds to nearest even, as torch's
// .to(torch.bfloat16) and JAX's astype do.
__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T's precision, kept in fp32.
template <typename T> __device__ inline float round_to(float v) { return to_f32(from_f32<T>(v)); }

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

// One source element into a stage slot of its own type: an asynchronous
// 4-byte copy for fp32, a plain 2-byte copy for bf16 (cp.async moves 4, 8 or
// 16 bytes).
__device__ inline void stage_elem(float* dst, const float* src) { __pipeline_memcpy_async(dst, src, 4); }
__device__ inline void stage_elem(__nv_bfloat16* dst, const __nv_bfloat16* src) { *dst = *src; }

// Stage source rows [j0, j0+KC) of one source block, columns [f0, f0+ft)
// padded with zeros to ftp, in the source's type. With `vec` (the widths and
// the base are 16-byte aligned) in 16-byte asynchronous pieces, else one
// element at a time; columns past ft or past the source width are zeros.
template <typename TS>
__device__ inline void stage_src_rows(const TS* __restrict__ sblk, int f_src, int ft, int ftp, int f0,
                                      int j0, bool vec, TS* ss, int tid) {
    constexpr int PV = 16 / (int)sizeof(TS);     // elements per 16-byte piece
    if (vec) {
        const int pr = ftp / PV;                 // pieces per staged row
        for (int i = tid; i < KC * pr; i += THREADS) {
            const int jj = i / pr, cc = (i % pr) * PV;
            TS* dst = ss + jj * ftp + cc;
            if (cc < ft && f0 + cc < f_src)
                __pipeline_memcpy_async(dst, sblk + (long long)(j0 + jj) * f_src + f0 + cc, 16);
            else
                *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int i = tid; i < KC * ftp; i += THREADS) {
            const int jj = i / ftp, cc = i % ftp;
            const int f = f0 + cc;
            if (cc < ft && f < f_src) stage_elem(ss + i, sblk + (long long)(j0 + jj) * f_src + f);
            else ss[i] = from_f32<TS>(0.f);
        }
    }
}

// 16 consecutive staged source values, widened to fp32.
__device__ inline void load16(const float* p, float e[16]) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
        const float4 q = reinterpret_cast<const float4*>(p)[v];
        e[4 * v + 0] = q.x;
        e[4 * v + 1] = q.y;
        e[4 * v + 2] = q.z;
        e[4 * v + 3] = q.w;
    }
}
__device__ inline void load16(const __nv_bfloat16* p, float e[16]) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        const float4 raw = reinterpret_cast<const float4*>(p)[v];
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) e[8 * v + k] = __bfloat162float(h[k]);
    }
}

// The epilogue of one output row block, written by the whole block: `sum`
// is the block's TILE × ft aggregate (row stride ldc) in shared memory. It
// starts and ends with a barrier (every row of `sum` is in place before, and
// read before anyone resets it), so it is called where the whole block is.
// Each output sums over k in order, as the TPU kernel's dot; stores are
// consecutive across a warp.
//
// MODE 1 takes F_in in nch chunks of ft columns: `sum` is chunk ch's
// aggregate, and the call adds its product with W's rows [ch·ft, ch·ft +
// ft) to the output sum, continuing the FMA chain of chunk ch − 1 (kept in
// `osum`, this block's TILE × f_out fp32 slot in global memory, between the
// calls), so the sum over k runs in ascending k across chunks, as one pass
// would; bias and activation apply after the last chunk. Each thread owns
// the same outputs in every call, so it reads back only what it wrote. With
// one chunk (F_in ≤ 240) `osum` is never touched.
template <int MODE, typename TW, typename TO>
struct Epilogue {
    const TW* w;
    const float* b;
    TO* out;
    int f_out, relu, ft, f0;
    float* osum;                 // MODE 1 with nch > 1: this block's running output sum
    int f_in, nch;               // MODE 1: the input width and its chunks

    __device__ inline void operator()(const float* sum, int ldc, int r, int tid, int ch = 0) const {
        __syncthreads();
        TO* o = out + (long long)r * TILE * f_out;
        if (MODE == 1) {
            // act(round_W(sum) · W + b): warp v owns rows [32v, 32v + 32),
            // lane l the columns c0 + l and c0 + 32 + l, in register tiles of
            // 4 rows × 2 columns (6 loads for 8 FMAs).
            const int lane = tid % 32, r_begin = (tid / 32) * 32;
            const int k0 = ch * ft, kw = f_in - k0 < ft ? f_in - k0 : ft;
            const bool first = ch == 0, last = ch == nch - 1;
            for (int c0 = 0; c0 < f_out; c0 += 64) {
                const int ca = c0 + lane, cb = ca + 32;
                if (ca >= f_out) continue;
                const bool has_b = cb < f_out;
                for (int r0 = r_begin; r0 < r_begin + 32; r0 += 4) {
                    float h[4][2] = {};
                    if (!first) {
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float* srow = osum + (long long)(r0 + i) * f_out;
                            h[i][0] = srow[ca];
                            if (has_b) h[i][1] = srow[cb];
                        }
                    }
#pragma unroll 4
                    for (int k = 0; k < kw; ++k) {
                        const TW* wrow = w + (long long)(k0 + k) * f_out;
                        const float wa = to_f32(wrow[ca]), wb = has_b ? to_f32(wrow[cb]) : 0.f;
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float a = round_to<TW>(sum[(r0 + i) * ldc + k]);   // the TPU kernel's acc.astype(W.dtype)
                            h[i][0] = fmaf(a, wa, h[i][0]);
                            h[i][1] = fmaf(a, wb, h[i][1]);
                        }
                    }
                    if (!last) {
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            float* srow = osum + (long long)(r0 + i) * f_out;
                            srow[ca] = h[i][0];
                            if (has_b) srow[cb] = h[i][1];
                        }
                        continue;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        TO* orow = o + (long long)(r0 + i) * f_out;
                        const float va = h[i][0] + b[ca];
                        orow[ca] = from_f32<TO>(relu ? fmaxf(va, 0.f) : va);
                        if (has_b) {
                            const float vb = h[i][1] + b[cb];
                            orow[cb] = from_f32<TO>(relu ? fmaxf(vb, 0.f) : vb);
                        }
                    }
                }
            }
        } else {
            // act(sum + b) (MODE 0) or sum (MODE 2) into columns [f0, f0 + ft):
            // thread tid takes elements tid, tid + THREADS, ... in row-major order.
            int row = tid / ft, col = tid % ft;
            for (int i = tid; i < TILE * ft; i += THREADS) {
                if (f0 + col < f_out) {
                    const float v = MODE == 0 ? sum[row * ldc + col] + b[f0 + col] : sum[row * ldc + col];
                    o[(long long)row * f_out + f0 + col] = from_f32<TO>(MODE == 0 && relu ? fmaxf(v, 0.f) : v);
                }
                col += THREADS % ft;
                row += THREADS / ft;
                if (col >= ft) {
                    col -= ft;
                    ++row;
                }
            }
        }
        __syncthreads();
    }
};

__device__ inline int row_start(const int* __restrict__ ends, int r) { return r > 0 ? ends[r - 1] : 0; }

// First row r with ends[r] >= pos (R when none); ends is non-decreasing.
__device__ inline int first_row_reaching(const int* __restrict__ ends, int R, int pos) {
    int lo = 0, hi = R;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (ends[mid] < pos) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// The split schedule over Ã's valid tiles (see the top of this file). Grid
// (gridDim.x, gridDim.y): block (g, y) takes its share of the positions and,
// in MODE 0 and 2, the output columns [y·ft, y·ft + ft). Row r holds
// positions [ends[r-1], ends[r]): its lens[r] tiles, then row_weight
// positions that stand for its epilogue (no copy, no arithmetic), so that a
// block of many short rows takes fewer of them, and every row, an empty one
// too, has a position and so a block. Thread i owns accumulator row i, in
// shared memory.
//
// MODE 0 (feature-first): src = Z (width f_src = f_out); out = act(acc + b).
// MODE 1 (aggregation-first): src = X (width f_src = f_in), taken in
//                             nch = ⌈f_in / ft⌉ chunks of ft columns (ft =
//                             f_in and nch = 1 up to 240 columns);
//                             out = act(round_W(acc) · W + b), W (f_in, f_out).
//                             A block runs each row's chunks one after another:
//                             it streams the row's tiles (its share of them) once
//                             per chunk, aggregating that chunk's columns, and
//                             the epilogue adds the chunk's product with W to
//                             the output sum (Epilogue, osum). Shared memory
//                             holds one chunk, so any F_in runs.
// MODE 2 (K1, the plain product): src = Z (width f_src = f_out); out = acc,
//                             with no bias and no activation (w, b unused).
//                             With a bf16 output the running sum is rounded
//                             to bf16 after every tile (PerTileRound).
// TV, TS, TW, TO are the element types of vals, src, W and out; b is fp32.
//
// Workspace, allocated by the caller: `part` holds 2 · gridDim.x ·
// gridDim.y · nch slots of TILE × ftp floats (a block's partial of the row it
// starts inside, slot 0, and of the row it leaves unfinished, slot 1, for
// each chunk: a block writes a chunk's partial as soon as it has aggregated
// it, and the finishing block reads all of them);
// `arrivals` R · gridDim.y ints, zero on entry; `prods` (per
// tile rounding only) one TILE × ftp slot of bf16 values per position and
// feature tile, each thread's ftp contiguous: the rounded products of split
// rows; `osum` (MODE 1 with nch > 1 only) gridDim.x slots of TILE × f_out
// floats, each block's running output sum.
//
// Column ids outside [0, n_src_blocks) are clamped, so a malformed table
// cannot read outside the operands; the host side (BlockedAdjacency.arrays)
// rejects such tables before they get here, and the wrapper clamps lens to
// [0, T] before the prefix sum.
template <int MODE, typename TV, typename TS, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
ragged_layer_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                    const int* __restrict__ ends, int R, int T, int n_src_blocks,
                    const TS* __restrict__ src, int f_src, int ft,
                    const TW* __restrict__ w, const float* __restrict__ b,
                    TO* __restrict__ out, int f_out, int relu, int row_weight, int min_tiles,
                    float* __restrict__ part, int* __restrict__ arrivals,
                    unsigned short* __restrict__ prods, float* __restrict__ osum) {
    extern __shared__ float smem[];
    const int ftp = padded_width(ft);
    const int ldc = ftp + 1;             // odd stride: each thread's row sits in its own banks
    float* as = smem;                                                      // STAGES × TILE × LDA adjacency chunks
    TS* ss = reinterpret_cast<TS*>(smem + STAGES * TILE * LDA);            // STAGES × KC × ftp source rows
    float* acc = reinterpret_cast<float*>(ss + STAGES * KC * ftp);         // TILE × ldc accumulator
    constexpr bool per_tile = PerTileRound<MODE, TO>::value;
    float* run = acc + TILE * ldc;                                         // TILE × ldc rounded sum (per_tile only)
    const int tid = threadIdx.x;
    const int y = blockIdx.y, gy = gridDim.y;
    const int f0 = y * ft;               // first source/output column of this block (MODE 0, 2)
    const int nch = MODE == 1 ? (f_src + ft - 1) / ft : 1;     // chunks of F_in (MODE 1)

    const int n = R > 0 ? ends[R - 1] : 0;
    const int G = split_blocks(n, gridDim.x, min_tiles);
    const int g = blockIdx.x;
    if (g >= G) return;                  // a block with no share (uniform across the block)
    const Epilogue<MODE, TW, TO> epilogue{w, b, out, f_out, relu, ft, f0,
                                          nch > 1 ? osum + (long long)g * TILE * f_out : nullptr, f_src, nch};
    const int lo = (int)((long long)g * n / G), hi = (int)((long long)(g + 1) * n / G);

    float* crow = acc + tid * ldc;       // this thread's accumulator row
    float* rrow = run + tid * ldc;       // and its rounded running sum (per_tile only)
    for (int c = 0; c < ldc; ++c) crow[c] = 0.f;
    if (per_tile)
        for (int c = 0; c < ldc; ++c) rrow[c] = 0.f;

    constexpr int PV = 16 / (int)sizeof(TS);
    const bool vec = f_src % PV == 0 && ft % PV == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0;

    // The tiles [t0, t1) of row r that fall in this block's positions.
    auto tiles_in = [&](int r, int& t0, int& t1) {
        const int s = row_start(ends, r), e = ends[r] - row_weight;
        t0 = (lo > s ? lo : s) - s;
        t1 = (hi < e ? hi : e) - s;
        if (t1 < t0) t1 = t0;
    };
    const int first = first_row_reaching(ends, R, lo + 1);     // the row holding position lo

    // The copy cursor runs STAGES − 1 chunks ahead of the compute loop, over
    // the same sequence: (row kr, feature chunk kch, tile kt of [kt0, kt1),
    // chunk kc of the tile).
    int kr = first, kt = 0, kt0 = 0, kt1 = 0, kc = 0, kch = 0, issued = 0;
    auto seek = [&]() {                  // from row kr on, the next row with a tile of this block
        kch = 0;
        for (; kr < R && row_start(ends, kr) < hi; ++kr) {
            tiles_in(kr, kt0, kt1);
            kt = kt0;
            if (kt < kt1) return;
        }
        kt = kt1 = 0;
    };
    auto copy_next = [&]() {
        if (kt < kt1) {
            const int st = issued++ % STAGES;
            const long long tile = (long long)kr * T + kt;
            int cb = cols[tile];
            cb = cb < 0 ? 0 : (cb >= n_src_blocks ? n_src_blocks - 1 : cb);
            stage_tile_chunk(vals + tile * (TILE * TILE), kc * KC, as + st * TILE * LDA, tid);
            stage_src_rows(src + (long long)cb * TILE * f_src, f_src, ft, ftp, f0 + kch * ft,
                           kc * KC, vec, ss + st * KC * ftp, tid);
            if (++kc == CPT) {
                kc = 0;
                if (++kt == kt1) {
                    if (++kch < nch) {
                        kt = kt0;
                    } else {
                        ++kr;
                        seek();
                    }
                }
            }
        }
        __pipeline_commit();
    };

    // Thread tid's ftp rounded products of position p (K1 bf16, split rows).
    auto prod_slot = [&](int p) { return prods + (((long long)p * gy + y) * TILE + tid) * ftp; };

    // Block gg's workspace slot of feature chunk ch of a split row whose
    // first block is g_first.
    auto slot_of = [&](int gg, int g_first, int ch) {
        const int k = gg == g_first ? 1 : 0;       // the first block leaves the row unfinished; the others start inside it
        return part + ((((long long)(2 * gg + k) * nch + ch) * gy + y) * ftp * TILE);
    };

    // Finish row r (positions [s, e)), split over blocks g_first..g_last,
    // whose shares (every chunk's) are in the workspace: arrive, and if this
    // block is the last to arrive, add the shares in block order and write
    // the epilogue, chunk by chunk.
    auto finish_split = [&](int r, int s, int e) {
        const int g_first = owner_block(s, n, G), g_last = owner_block(e - 1, n, G);
        __threadfence();                 // this block's share (or products) before its arrival
        __syncthreads();
        int is_last = 0;
        if (tid == 0) is_last = atomicAdd(arrivals + (long long)r * gy + y, 1) == g_last - g_first;
        if (!__syncthreads_or(is_last)) return;
        __threadfence();
        if (per_tile) {
            // The reference's chain over the whole row, in tile order, NC
            // columns at a time in registers; each tile's NC products are
            // two 16-byte loads.
            const int nt = e - s - row_weight;
            for (int fc = 0; fc < ftp; fc += NC) {
                float chain[NC];
#pragma unroll
                for (int c = 0; c < NC; ++c) chain[c] = 0.f;
#pragma unroll 4
                for (int t = 0; t < nt; ++t) {
                    const float4* pp = reinterpret_cast<const float4*>(prod_slot(s + t) + fc);
                    const float4 raw[2] = {__ldcg(pp), __ldcg(pp + 1)};
                    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
                    for (int c = 0; c < NC; ++c) chain[c] = round_to<TO>(chain[c] + __bfloat162float(h[c]));
                }
#pragma unroll
                for (int c = 0; c < NC; ++c) rrow[fc + c] = chain[c];
            }
            epilogue(run, ldc, r, tid);
        } else {
            for (int ch = 0; ch < nch; ++ch) {
                for (int c = 0; c < ftp; ++c) {
                    float v = 0.f;
                    for (int gg = g_first; gg <= g_last; ++gg) v += __ldcg(slot_of(gg, g_first, ch) + c * TILE + tid);
                    crow[c] = v;
                }
                epilogue(acc, ldc, r, tid, ch);
            }
        }
    };

    seek();
    for (int i = 0; i < STAGES - 1; ++i) copy_next();    // the first chunks in flight
    int q = 0;                                           // chunks computed
    for (int r = first; r < R && row_start(ends, r) < hi; ++r) {
        const int s = row_start(ends, r), e = ends[r];
        const bool split = s < lo || e > hi;             // other blocks hold some of the row's positions
        int t0, t1;
        tiles_in(r, t0, t1);
        for (int ch = 0; ch < nch; ++ch) {
            for (int t = t0; t < t1; ++t) {
                for (int c = 0; c < CPT; ++c, ++q) {
                    copy_next();
                    __pipeline_wait_prior(STAGES - 1);       // chunk q has landed; the ones after it may be in flight
                    __syncthreads();
                    const float* arow = as + (q % STAGES) * TILE * LDA + tid * LDA;
                    const TS* sst = ss + (q % STAGES) * KC * ftp;
                    for (int fc = 0; fc < ftp; fc += NC) {
                        float a_acc[NC];
#pragma unroll
                        for (int k = 0; k < NC; ++k) a_acc[k] = crow[fc + k];
#pragma unroll 2
                        for (int j4 = 0; j4 < KC; j4 += 4) {
                            const float4 a4 = *reinterpret_cast<const float4*>(arow + j4);
                            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
                            for (int u = 0; u < 4; ++u) {
                                float ev[NC];
                                load16(sst + (j4 + u) * ftp + fc, ev);
#pragma unroll
                                for (int k = 0; k < NC; ++k) a_acc[k] = fmaf(av[u], ev[k], a_acc[k]);
                            }
                        }
#pragma unroll
                        for (int k = 0; k < NC; ++k) crow[fc + k] = a_acc[k];
                    }
                    __syncthreads();                         // this stage is refilled by a later copy
                }
                if (per_tile) {
                    // Tile t is complete: the TPU kernel's out += dot(a,
                    // z).astype(out.dtype) in out's (bf16) type, in the block for
                    // a whole row; a split row's product goes to the workspace
                    // for the finishing block.
                    if (split) {
                        float4* pp = reinterpret_cast<float4*>(prod_slot(s + t));
                        for (int v = 0; v < ftp / 8; ++v) {
                            float4 raw;
                            __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
                            for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(crow[8 * v + k]);
                            pp[v] = raw;
                        }
                    } else {
                        for (int c = 0; c < ftp; ++c) rrow[c] = round_to<TO>(rrow[c] + round_to<TO>(crow[c]));
                    }
                    for (int c = 0; c < ftp; ++c) crow[c] = 0.f;
                }
            }
            // Chunk ch of this block's part of row r is done: hand in a split
            // row's share, or add the chunk to the output of a whole row.
            if (!per_tile) {
                if (split) {
                    float* dst = slot_of(g, owner_block(s, n, G), ch);
                    for (int c = 0; c < ftp; ++c) dst[c * TILE + tid] = crow[c];
                } else {
                    epilogue(acc, ldc, r, tid, ch);
                }
                if (nch > 1)
                    for (int c = 0; c < ftp; ++c) crow[c] = 0.f;
            }
        }
        // This block's part of row r is done.
        if (split) finish_split(r, s, e);
        else if (per_tile) epilogue(run, ldc, r, tid);
        for (int c = 0; c < ftp; ++c) crow[c] = 0.f;
        if (per_tile)
            for (int c = 0; c < ftp; ++c) rrow[c] = 0.f;
    }
}

}  // namespace k2
