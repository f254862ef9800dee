// Device code of the fused GCN layer's dense transform for Hopper (K2,
// feature-first launch 1 of 2): Z = X · W, the product that
// `repro/kernels/fused_gcn.py::_ff_kernel` computes for every tile
// (`jnp.dot(x, w, preferred_element_type=f32).astype(vals.dtype)`).
//
//   xw_kernel<TX, TW, TZ>   X (M, K) · W (K, N) → Z (M, N), fp32 sums, stored as TZ
//
// Three instantiations (fused_gcn.cu): fp32 · fp32 → fp32 and bf16 · fp32 →
// fp32 in IEEE fp32 on the CUDA cores (no TF32), and bf16 · bf16 → bf16 on
// the tensor cores (mma.sync m16n8k16, fp32 accumulators; bf16 products are
// exact in fp32, so only the order of the sum differs from the plain fp32
// product).
//
// What bounds it: bytes. N ≤ 16 per block column, so every X element feeds
// 16 FMAs: at Nell (X 65,792 × 5,414 fp32, 1.42 GB) the read takes 0.43 ms at
// 3.35 TB/s and the 5.7 G FMAs 0.17 ms at the 67 TFLOP/s of the CUDA cores,
// so the arithmetic has to run under the stream. With a bf16 X and fp32 W
// the two are even (rank 0: 0.058 ms of bytes, 0.047 ms of FMAs).
//
// What the stream needs, measured on an H100 (tools/dense_bench.py; PERF.md,
// PR 20): long runs of each row, read by 16-byte copies. X's rows are
// 21,656 B at K = 5,414 fp32. A design that gives every warp its own rows
// and reads 64 or 128 bytes of each per step keeps tens of thousands of
// rows open at once, and its copies alone ran near 2 TB/s; so here the card
// reads each row 1 KB at a time (512 B in bf16):
//
// * Grid: one block of 8 warps per SM (per block column of 16 outputs,
//   blockIdx.y), the groups of xw_rows rows (64 fp32, 48 bf16) divided
//   evenly over the blocks; a block runs its groups one after another
//   (passes).
// * A chunk is XW_KC = 256 values of K of the pass's rows (1 KB of each
//   fp32 row) and the matching 256 rows of W, shared by the block's warps,
//   in a ring of xw_stages chunks (2 fp32, 3 bf16: measured best of 32-64
//   rows and 2-4 stages): the block copies the next chunks while it
//   computes one, one __syncthreads a chunk, the chunks of consecutive
//   passes in one stream.
// * Copies are 16-byte cp.async. X's rows at Nell are 8-byte aligned in
//   fp32 (21,656 B) and 4-byte in bf16 (10,828 B): the kernel copies the
//   16-byte-aligned run around each row's 1 KB (one piece more), so that
//   its data begins 4, 8 or 12 bytes into its slot, and reads it 8 or 4
//   bytes at a time (on the tensor cores: A's fragments as 32-bit words in
//   place of ldmatrix). Copies of the exact bytes in 8- or 4-byte pieces go
//   through L1 and streamed markedly slower than 16-byte ones. The partial
//   last piece of a row is zero-filled by cp.async itself (its source
//   size). Only an X that does not start 16-byte aligned is copied in the
//   widest piece that divides its start and pitch, read 16 bytes at a time
//   (a bf16 X of odd pitch by plain 2-byte loads). W's rows come in 16-byte
//   pieces where their pitch allows.
// * Each warp takes 32 of a chunk's 256 values of K for all the pass's rows
//   and 16 columns. CUDA cores: lane 4·rs + cg holds rows rs, rs + 8, … and
//   columns 4·cg .. 4·cg + 3; per 16 bytes of its rows it reads eight row
//   pieces (eight distinct 16-byte pieces a warp at a pitch of an odd number
//   of 16-byte units: one wavefront) and per k one 16-byte piece of W (four
//   distinct a warp): 12 shared reads per 128 FMAs in fp32; bf16 X is
//   widened in registers (a shift or a mask per value). Tensor cores: per 16
//   k, ldmatrix.x4.trans of W (both n8 halves) and, for each 16-row tile,
//   ldmatrix.x4 of X and two mma.sync.m16n8k16.
// * At the end of a pass the warps' partial tiles meet in the stage just
//   computed and are added in warp order, then stored. No atomics: the same
//   bits on every call.
//
// This file holds device code only and includes no header: fused_gcn.cu
// includes <cuda_bf16.h>, ptx.cuh and fused_gcn_kernels.cuh (NC, is_f32,
// from_f32) before it, and a host-compiler check may include it after
// stand-ins for the built-ins it uses.

#pragma once

namespace k2 {

constexpr int XW_WARPS = 8;                  // warps of a block
constexpr int XW_THREADS = 32 * XW_WARPS;
constexpr int XW_KC = 256;                   // values of K in one chunk
constexpr int XW_KW = XW_KC / XW_WARPS;      // values of K each warp takes from a chunk

// Rows of one pass and chunks in the block's ring, by X's element size: fp32
// 64 rows, two chunks; bf16 (a chunk of a row is 512 bytes) 48 rows, three.
__host__ __device__ constexpr int xw_rows(int x_bytes) { return x_bytes == 4 ? 64 : 48; }
__host__ __device__ constexpr int xw_stages(int x_bytes) { return x_bytes == 4 ? 2 : 3; }

// Pitches (bytes) of a staged X row (XW_KC values and 16 bytes: an odd number
// of 16-byte units, so eight rows' 16-byte reads, and ldmatrix's eight rows,
// fall on distinct banks) and of a staged W row of NC values (fp32 read 16
// bytes a column group; bf16 by ldmatrix.trans, 48 bytes: conflict-free).
__host__ __device__ constexpr int xw_x_pitch(int x_bytes) { return XW_KC * x_bytes + 16; }
__host__ __device__ constexpr int xw_w_pitch(int w_bytes) { return w_bytes == 4 ? NC * 4 : NC * 2 + 16; }

// Bytes of one stage: a chunk of the pass's rows of X and of W's rows. At the
// end of a pass the stage just computed holds the warps' partial tiles.
__host__ __device__ constexpr int xw_stage_bytes(int x_bytes, int w_bytes) {
    return xw_rows(x_bytes) * xw_x_pitch(x_bytes) + XW_KC * xw_w_pitch(w_bytes);
}
static_assert(XW_WARPS * xw_rows(4) * NC * 4 <= xw_stage_bytes(4, 4), "the partial tiles fit a stage");
static_assert(XW_WARPS * xw_rows(2) * NC * 4 <= xw_stage_bytes(2, 2), "the partial tiles fit a stage");

// Dynamic shared memory of one block.
__host__ __device__ inline long long xw_smem_bytes(int x_bytes, int w_bytes) {
    return (long long)xw_stages(x_bytes) * xw_stage_bytes(x_bytes, w_bytes);
}

// Blocks of one block column: one per SM, no more than the ⌈M / rows⌉ row
// groups (rows = xw_rows(x_bytes)).
__host__ __device__ inline int xw_blocks(long long M, int sms, int x_bytes) {
    const long long groups = (M + xw_rows(x_bytes) - 1) / xw_rows(x_bytes);
    return (int)(groups < sms ? (groups < 1 ? 1 : groups) : sms);
}

// Copy rows [0, rows) of BYTES bytes each from src (pitch `pitch`) to dst
// (pitch `dst_pitch`) in P-byte pieces, the block's threads taking every
// XW_THREADS-th piece: pieces of rows at or past valid_rows, or at or past
// valid_bytes in a row, are zeros. P < 4 copies synchronously (cp.async
// moves 4, 8 or 16 bytes).
template <int P, int BYTES>
__device__ inline void xw_copy_pieces(unsigned char* dst, int dst_pitch, const unsigned char* src, long long pitch,
                                      int rows, int valid_rows, long long valid_bytes) {
    constexpr int PER_ROW = BYTES / P;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += XW_THREADS) {
        const int r = i / PER_ROW, off = (i % PER_ROW) * P;
        const bool in = r < valid_rows && off < valid_bytes;
        unsigned char* d = dst + r * dst_pitch + off;
        const unsigned char* s = in ? src + r * pitch + off : src;
        if constexpr (P >= 4) {
            ptx::cp_async<P>(d, s, in);
        } else {
            *reinterpret_cast<unsigned short*>(d) = in ? *reinterpret_cast<const unsigned short*>(s) : 0;
        }
    }
}

template <int BYTES>
__device__ inline void xw_copy(int piece, unsigned char* dst, int dst_pitch, const unsigned char* src,
                               long long pitch, int rows, int valid_rows, long long valid_bytes) {
    switch (piece) {
        case 16: xw_copy_pieces<16, BYTES>(dst, dst_pitch, src, pitch, rows, valid_rows, valid_bytes); break;
        case 8: xw_copy_pieces<8, BYTES>(dst, dst_pitch, src, pitch, rows, valid_rows, valid_bytes); break;
        case 4: xw_copy_pieces<4, BYTES>(dst, dst_pitch, src, pitch, rows, valid_rows, valid_bytes); break;
        default: xw_copy_pieces<2, BYTES>(dst, dst_pitch, src, pitch, rows, valid_rows, valid_bytes); break;
    }
}

// Copy, for rows [0, ROWS) of a chunk, the 16-byte-aligned run around the
// row's BYTES bytes at row0 + r·pitch: 16-byte pieces (EXTRA = 1: one more
// than BYTES / 16, for rows that start off a 16-byte boundary), the bytes
// past the row's valid_bytes and whole rows at or past valid_rows zeroed.
// The run of row r lands at dst + r·dst_pitch; its chunk begins (row0 +
// r·pitch) mod 16 bytes in. Needs row0 − (row0 mod 16) inside X: X itself
// starts on a 16-byte boundary.
template <int ROWS, int BYTES, int EXTRA>
__device__ inline void xw_copy_runs(unsigned char* dst, int dst_pitch, const unsigned char* row0, long long pitch,
                                    int valid_rows, long long valid_bytes) {
    constexpr int PER_ROW = BYTES / 16 + EXTRA;
    const long long used = valid_bytes < BYTES ? valid_bytes : BYTES;
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += XW_THREADS) {
        const int r = i / PER_ROW, j = i % PER_ROW;
        const unsigned char* a = row0 + r * pitch;
        const unsigned char* piece = a - (reinterpret_cast<unsigned long long>(a) & 15) + 16 * j;
        long long n = r < valid_rows ? a + used - piece : 0;
        n = n < 0 ? 0 : (n > 16 ? 16 : n);
        ptx::cp_async_16(dst + r * dst_pitch + 16 * j, n > 0 ? piece : row0, (int)n);
    }
}

// 16 bytes of shared memory at p, read READ (16, 8 or 4) bytes at a time: p
// is READ-byte aligned.
template <int READ>
__device__ inline float4 xw_lds16(const unsigned char* p) {
    if constexpr (READ == 16) {
        return *reinterpret_cast<const float4*>(p);
    } else if constexpr (READ == 8) {
        const float2 a = *reinterpret_cast<const float2*>(p), b = *reinterpret_cast<const float2*>(p + 8);
        return make_float4(a.x, a.y, b.x, b.y);
    } else {
        const float* f = reinterpret_cast<const float*>(p);
        return make_float4(f[0], f[1], f[2], f[3]);
    }
}

// 16 staged bytes of an X row as fp32 values: 4 fp32, or 8 bf16 widened
// (the lower element of each 32-bit word first).
template <typename TX> struct XwPiece;
template <> struct XwPiece<float> {
    static constexpr int N = 4;
    __device__ static void widen(float4 p, float v[4]) {
        v[0] = p.x;
        v[1] = p.y;
        v[2] = p.z;
        v[3] = p.w;
    }
};
template <> struct XwPiece<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void widen(float4 p, float v[8]) {
        const unsigned u[4] = {__float_as_uint(p.x), __float_as_uint(p.y), __float_as_uint(p.z), __float_as_uint(p.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[2 * i] = __uint_as_float(u[i] << 16);
            v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
};

// A warp's XW_KW values of K of a staged chunk on the CUDA cores (xs: its
// slice of row 0's slot, ws: its first W row; row r's values begin
// (s0 + r·pm) mod 16 bytes into its slot, a multiple of READ). Lane l =
// 4·rs + cg holds rows rs + 8i (i < ROWS / 8) and columns 4·cg .. 4·cg + 3:
// acc[4i + j] += Σ_k X[rs + 8i, k] · W[k, 4·cg + j], k in order.
template <typename TX, int ROWS, int READ>
__device__ inline void xw_chunk_fma(const unsigned char* xs, const unsigned char* ws, int s0, int pm, float* acc,
                                    int lane) {
    using R = XwPiece<TX>;
    constexpr int XP = xw_x_pitch((int)sizeof(TX));
    constexpr int RL = ROWS / 8;                     // rows a lane holds
    const int rs = lane >> 2, cg = lane & 3;
    int row[RL];                                     // byte offsets of the lane's rows' values
#pragma unroll
    for (int i = 0; i < RL; ++i) row[i] = (rs + 8 * i) * XP + ((s0 + (rs + 8 * i) * pm) & 15);
#pragma unroll
    for (int p = 0; p < XW_KW * (int)sizeof(TX) / 16; ++p) {
        float v[RL][R::N];
#pragma unroll
        for (int i = 0; i < RL; ++i) R::widen(xw_lds16<READ>(xs + row[i] + 16 * p), v[i]);
#pragma unroll
        for (int j = 0; j < R::N; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(ws + (p * R::N + j) * (NC * 4) + 16 * cg);
#pragma unroll
            for (int i = 0; i < RL; ++i) {
                acc[4 * i + 0] = fmaf(v[i][j], b.x, acc[4 * i + 0]);
                acc[4 * i + 1] = fmaf(v[i][j], b.y, acc[4 * i + 1]);
                acc[4 * i + 2] = fmaf(v[i][j], b.z, acc[4 * i + 2]);
                acc[4 * i + 3] = fmaf(v[i][j], b.w, acc[4 * i + 3]);
            }
        }
    }
}

// The same on the tensor cores (all bf16): acc[(2·mt + nt)·4 + e] is C
// fragment e of the row tile mt (16 rows) and column half nt. A's fragments
// come by ldmatrix where every row starts 16-byte aligned (READ = 16), else
// as 32-bit words read in the fragment layout (PTX ISA: a0 = A[g][2t, 2t+1],
// a1 = A[g+8][2t, 2t+1], a2 and a3 the same 8 columns on).
template <int ROWS, int READ>
__device__ inline void xw_chunk_mma(const unsigned char* xs, const unsigned char* ws, int s0, int pm, float* acc,
                                    int lane) {
    constexpr int XP = xw_x_pitch(2), WP = xw_w_pitch(2);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k16 = 0; k16 < XW_KW / 16; ++k16) {
        unsigned b[4];
        ptx::ldmatrix_x4_trans(b, ws + (k16 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * WP + (lane >> 4) * 16);
#pragma unroll
        for (int mt = 0; mt < ROWS / 16; ++mt) {
            unsigned a[4];
            if constexpr (READ == 16) {
                ptx::ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * XP + k16 * 32 + (lane >> 4) * 16);
            } else {
                const int r0 = mt * 16 + g, r1 = r0 + 8;
                const unsigned char* p0 = xs + r0 * XP + ((s0 + r0 * pm) & 15) + k16 * 32 + 4 * t;
                const unsigned char* p1 = xs + r1 * XP + ((s0 + r1 * pm) & 15) + k16 * 32 + 4 * t;
                a[0] = *reinterpret_cast<const unsigned*>(p0);
                a[1] = *reinterpret_cast<const unsigned*>(p1);
                a[2] = *reinterpret_cast<const unsigned*>(p0 + 16);
                a[3] = *reinterpret_cast<const unsigned*>(p1 + 16);
            }
            ptx::mma_bf16_16816(acc + (2 * mt + 0) * 4, a, b[0], b[1]);
            ptx::mma_bf16_16816(acc + (2 * mt + 1) * 4, a, b[2], b[3]);
        }
    }
}

template <typename TX, typename TW, int READ>
__device__ inline void xw_chunk(const unsigned char* xs, const unsigned char* ws, int s0, int pm, float* acc,
                                int lane) {
    constexpr int ROWS = xw_rows((int)sizeof(TX));
    if constexpr (!is_f32<TX>::value && !is_f32<TW>::value) xw_chunk_mma<ROWS, READ>(xs, ws, s0, pm, acc, lane);
    else xw_chunk_fma<TX, ROWS, READ>(xs, ws, s0, pm, acc, lane);
}

// The (row, column) within the pass's rows × 16 tile of acc[i] in lane `lane`.
template <bool MMA>
__device__ inline void xw_position(int i, int lane, int& row, int& col) {
    if constexpr (MMA) {
        const int mt = i >> 3, nt = (i >> 2) & 1, e = i & 3;
        row = mt * 16 + (lane >> 2) + 8 * (e >> 1);
        col = nt * 8 + 2 * (lane & 3) + (e & 1);
    } else {
        row = (lane >> 2) + 8 * (i >> 2);
        col = 4 * (lane & 3) + (i & 3);
    }
}

// Z = X · W. x_read: 0 copies X's rows in x_piece-byte pieces (the widest
// that divides X's start and row pitch) and reads them 16 bytes at a time;
// 16, 8 or 4 (X starts 16-byte aligned, its pitch is a multiple of x_read)
// copies each row's aligned run in 16-byte pieces and reads x_read bytes at
// a time. w_piece: the copy width of W's rows. Grid (xw_blocks(M, SMs,
// sizeof(TX)), ⌈N / NC⌉), XW_THREADS threads, xw_smem_bytes(…) of dynamic
// shared memory.
template <typename TX, typename TW, typename TZ>
__global__ void __launch_bounds__(XW_THREADS, 1)
xw_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TZ* __restrict__ z, int M, int K, int N,
          int x_piece, int x_read, int w_piece) {
    constexpr int XP = xw_x_pitch((int)sizeof(TX)), WP = xw_w_pitch((int)sizeof(TW));
    constexpr int STAGE = xw_stage_bytes((int)sizeof(TX), (int)sizeof(TW));
    constexpr bool MMA = !is_f32<TX>::value && !is_f32<TW>::value;
    constexpr int ROWS = xw_rows((int)sizeof(TX)), STAGES = xw_stages((int)sizeof(TX));
    constexpr int ACC = ROWS / 2;                            // sums a lane holds: ROWS × 16 over 32 lanes
    extern __shared__ float4 xw_smem[];
    unsigned char* base = reinterpret_cast<unsigned char*>(xw_smem);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long groups = ((long long)M + ROWS - 1) / ROWS;
    const long long g_lo = blockIdx.x * groups / gridDim.x, g_hi = (blockIdx.x + 1) * groups / gridDim.x;
    const int n0 = blockIdx.y * NC;
    const int chunks = (K + XW_KC - 1) / XW_KC;
    const long long total = (g_hi - g_lo) * chunks;         // (pass, chunk) steps of this block
    const long long x_pitch = (long long)K * sizeof(TX), w_pitch = (long long)N * sizeof(TW);

    // Copy the next step, (group gi, chunk ci), into ring slot si: X[m0 : m0 + ROWS, k0 : k0 + XW_KC] and
    // W[k0 : k0 + XW_KC, n0 : n0 + 16]. Steps are counted, not divided out: a 64-bit division costs
    // dozens of instructions.
    long long gi = g_lo;
    int ci = 0, si = 0;
    auto issue_next = [&]() {
        const long long m0 = gi * ROWS;
        const int k0 = ci * XW_KC;
        const int rows = M - m0 < ROWS ? (int)(M - m0) : ROWS;
        unsigned char* st = base + si * STAGE;
        const unsigned char* row0 = reinterpret_cast<const unsigned char*>(x + m0 * K + k0);
        const long long valid = (long long)(K - k0) * sizeof(TX);
        if (x_read == 16)
            xw_copy_runs<ROWS, XW_KC * (int)sizeof(TX), 0>(st, XP, row0, x_pitch, rows, valid);
        else if (x_read)
            xw_copy_runs<ROWS, XW_KC * (int)sizeof(TX), 1>(st, XP, row0, x_pitch, rows, valid);
        else
            xw_copy<XW_KC * (int)sizeof(TX)>(x_piece, st, XP, row0, x_pitch, ROWS, rows, valid);
        xw_copy<NC * (int)sizeof(TW)>(w_piece, st + ROWS * XP, WP,
                                      reinterpret_cast<const unsigned char*>(w + (long long)k0 * N + n0), w_pitch,
                                      XW_KC, K - k0, (long long)(N - n0) * sizeof(TW));
        if (++ci == chunks) ci = 0, ++gi;
        if (++si == STAGES) si = 0;
    };

    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    long long to_issue = total;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (to_issue > 0) issue_next(), --to_issue;
        ptx::cp_async_commit();
    }
    long long g = g_lo;                              // the step computed: group g, chunk c, ring slot slot
    int c = 0, slot = 0;
    for (long long q = 0; q < total; ++q) {
        ptx::cp_async_wait_group<STAGES - 2>();   // step q has landed (this thread's pieces)
        __syncthreads();                             // every thread's pieces; every warp done with step q − 1
        if (to_issue > 0) issue_next(), --to_issue;  // into step q − 1's slot
        ptx::cp_async_commit();
        const unsigned char* st = base + slot * STAGE;
        if (++slot == STAGES) slot = 0;
        const unsigned char* xs = st + warp * XW_KW * (int)sizeof(TX);
        const unsigned char* ws = st + ROWS * XP + warp * XW_KW * WP;
        // Where each staged row's values begin: (s0 + r·pm) mod 16 bytes into its slot.
        const int s0 = x_read ? (int)(reinterpret_cast<unsigned long long>(x + g * ROWS * K) & 15) : 0;
        const int pm = x_read ? (int)(x_pitch & 15) : 0;
        switch (x_read) {
            case 8: xw_chunk<TX, TW, 8>(xs, ws, s0, pm, acc, lane); break;
            case 4: xw_chunk<TX, TW, 4>(xs, ws, s0, pm, acc, lane); break;
            default: xw_chunk<TX, TW, 16>(xs, ws, s0, pm, acc, lane); break;
        }
        if (++c < chunks) continue;
        c = 0;
        const long long m0 = g++ * ROWS;

        // The pass's last chunk: the warps' partials, added in warp order, are the pass's Z rows. They
        // meet in the stage just computed, which no copy refills before the next iteration's barrier.
        float* part = reinterpret_cast<float*>(const_cast<unsigned char*>(st));
        __syncthreads();                             // every warp done reading the stage
        int row, col;
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
            xw_position<MMA>(i, lane, row, col);
            part[(warp * ROWS + row) * NC + col] = acc[i];
            acc[i] = 0.0f;
        }
        __syncthreads();
        for (int o = tid; o < ROWS * NC / 4; o += XW_THREADS) {   // four consecutive outputs at a time
            const int r = o >> 2, c4 = 4 * (o & 3);
            float4 sum = *reinterpret_cast<const float4*>(part + r * NC + c4);
#pragma unroll
            for (int v = 1; v < XW_WARPS; ++v) {
                const float4 p = *reinterpret_cast<const float4*>(part + (v * ROWS + r) * NC + c4);
                sum = make_float4(sum.x + p.x, sum.y + p.y, sum.z + p.z, sum.w + p.w);
            }
            if (m0 + r >= M) continue;
            TZ* out = z + (m0 + r) * N + n0 + c4;
            if (is_f32<TZ>::value && N % 4 == 0 && n0 + c4 + 4 <= N) {
                *reinterpret_cast<float4*>(out) = sum;
            } else {
                const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
                for (int j = 0; j < 4; ++j)
                    if (n0 + c4 + j < N) out[j] = from_f32<TZ>(s4[j]);
            }
        }
    }
}

}  // namespace k2
