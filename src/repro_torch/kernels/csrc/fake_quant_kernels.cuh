// Device code of the GCN's fake quantization (`core/quant.py::fake_quant`)
// for Hopper. It replaces no Pallas kernel: the TPU package leaves fake
// quant to XLA. It replaces the PyTorch ops that `fake_quant` ran on the
// card (abs, torch.topk or max, where, div, round, clamp, mul, sub, add),
// and computes the same bits:
//
//   amax  = the k-th largest |x| (nearest-rank percentile), or max |x|
//   scale = amax > 0 ? amax · (1 / qmax) : 1
//   out   = x + (clamp(rint(x / scale), −qmax − 1, qmax) · scale − x)
//
// over x in fp32 or bf16 (template argument T). Every operation is rounded
// on its own, as each of those ops rounds its output: __fdiv_rn, rintf,
// __fmul_rn, __fsub_rn, __fadd_rn (the build allows fused multiply-adds,
// and a contracted q · scale − x would change the last bit). The scale is
// amax times the fp32 reciprocal of qmax, as PyTorch's CUDA division by a
// host scalar computes it; x / scale is a true division. In bf16 every
// operation is done in fp32 and its result rounded to bf16
// (__float2bfloat16_rn), as PyTorch's bf16 ops are.
//
// What bounds it: bytes. At Nell's X (65,755 × 5,414 fp32, 1.424 GB) the
// least is X read once and the output written once: 2.85 GB, 0.85 ms at
// 3.35 TB/s. torch.topk and eight elementwise passes moved 25–30 GB.
//
// Design. The statistic is an exact radix select on the magnitude's bits
// with the sign bit cleared (key): non-negative IEEE values order as
// unsigned integers, zeros are key 0, and NaN sorts above inf, as in
// torch.topk. fp32 keys take three digit passes (11, 10 and 10 bits from
// the top), bf16 keys two (11 and 4). Each pass:
//   1. reads its keys — x, or the scratch buffer of keys an earlier pass
//      compacted — with 16-byte loads in a grid-stride loop over one wave
//      of blocks, and skips exact zeros (99.33 % of X: one hot bin would
//      serialise every atomic; the k-th largest is a zero when k passes
//      the count of nonzero keys) and keys off the chosen prefix;
//   2. counts the digit of each key in a histogram in shared memory, one
//      atomic per group of lanes that share a bin (__match_any_sync: ties
//      are the rule, each row of X holds 32 ones), and adds the block's
//      histogram to a global one;
//   3. while it reads x, copies its elements (bits and position) into the
//      scratch buffer through a stage of each warp in shared memory (one
//      global atomic per flush of ≥ 256); a count past the buffer's
//      capacity leaves the buffer unread;
//   4. the last block to arrive (an arrival counter after a fence) picks
//      the digit from the global histogram and keeps the prefix, the rank
//      left within it and what the next pass reads: the scratch buffer if
//      this pass's keys fitted it, else x again.
// So X's 2.4 M nonzero elements are read from X once, and the next passes
// read 9.6 MB of scratch; a tensor whose chosen bin overflows the buffer is
// read once more per digit. The host reads nothing: every decision is on
// the card. With percentile None the statistic is a max over the keys.
// The quantize kernel computes the scale from the statistic's bits in
// every block. A zero quantizes to +0 whatever the scale, if it is finite
// and above 0; so where every nonzero element fitted the buffer, the
// caller's zeroed output takes only those (out[position] from their bits)
// and X is not read again. Else it reads x and writes the output in
// 16-byte vectors.
//
// This file holds device code only and includes no header: fake_quant.cu
// includes <cuda_bf16.h> before it, and a host-compiler check may include
// it after stand-ins for the built-ins it uses.

#pragma once

namespace fq {

constexpr int THREADS = 256;                     // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int LANE_VECS = 2;                     // 16-byte vectors a lane reads per step
constexpr int MAX_BINS = 2048;                   // 11-bit digits at most
constexpr int MAX_PASSES = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_BIN = 0xffffffffu;         // never a bin: lanes that count nothing

// Digit p of a key of kb bits: 11 bits from the top, then 10-bit digits.
__host__ __device__ constexpr int digit_shift(int kb, int p) { return kb - 11 - 10 * p > 0 ? kb - 11 - 10 * p : 0; }
__host__ __device__ constexpr int digit_width(int kb, int p) { return (p == 0 ? kb : digit_shift(kb, p - 1)) - digit_shift(kb, p); }
__host__ __device__ constexpr int digit_passes(int kb) { return 1 + (kb - 11 + 9) / 10; }

// What the next digit pass does; written by the last block of a pass.
struct Cursor {
    unsigned prefix;   // the digits chosen so far
    unsigned rank;     // rank, from the largest, of the statistic among keys with that prefix
    unsigned src;      // 0: the next pass reads x; 1: the first m elements of the scratch buffer
    unsigned m;
    unsigned done;     // 1: key holds the statistic
};

// The launcher's workspace, zeroed by the caller before every call.
struct State {
    unsigned key;                           // the statistic's key (its bits, sign cleared)
    unsigned scale;                         // the scale's bits, written by the quantize kernel
    unsigned arrivals[MAX_PASSES];          // blocks that finished each pass
    unsigned count[MAX_PASSES];             // elements each pass copied to the buffer (may pass its capacity)
    Cursor cur;
    unsigned hist[MAX_PASSES][MAX_BINS];    // each pass's global histogram
};

template <typename T> struct Elem;
template <> struct Elem<float> {
    static constexpr int KEY_BITS = 31;
    static constexpr int PER_VEC = 4;        // elements in 16 bytes
    static constexpr unsigned MAG = 0x7fffffffu;
    __device__ static unsigned bits(float v) { return __float_as_uint(v); }
    __device__ static float from_bits(unsigned w) { return __uint_as_float(w); }
    __device__ static unsigned key(float v) { return bits(v) & MAG; }
    __device__ static void keys(uint4 v, unsigned k[4]) {
        k[0] = v.x & MAG;
        k[1] = v.y & MAG;
        k[2] = v.z & MAG;
        k[3] = v.w & MAG;
    }
    // amax · (1 / qmax) where amax > 0, else 1 (NaN is not > 0).
    __device__ static float scale(unsigned key, float qmax) {
        const float amax = __uint_as_float(key);
        return amax > 0.0f ? __fmul_rn(amax, __fdiv_rn(1.0f, qmax)) : 1.0f;
    }
    __device__ static unsigned scale_bits(float s) { return __float_as_uint(s); }
    __device__ static float quant(float x, float s, float lo, float hi) {
        float v = rintf(__fdiv_rn(x, s));
        if (v == v) v = fminf(fmaxf(v, lo), hi);       // clamp keeps NaN
        return __fadd_rn(x, __fsub_rn(__fmul_rn(v, s), x));
    }
    // One element's bits; with `zeros`, ±0 gives +0 without the arithmetic.
    __device__ static unsigned quant_bits(unsigned w, float s, float lo, float hi, bool zeros) {
        return zeros && (w & MAG) == 0u ? 0u : bits(quant(from_bits(w), s, lo, hi));
    }
    __device__ static uint4 quant(uint4 v, float s, float lo, float hi, bool zeros) {
        return make_uint4(quant_bits(v.x, s, lo, hi, zeros), quant_bits(v.y, s, lo, hi, zeros),
                          quant_bits(v.z, s, lo, hi, zeros), quant_bits(v.w, s, lo, hi, zeros));
    }
};

__device__ inline float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <> struct Elem<__nv_bfloat16> {
    static constexpr int KEY_BITS = 15;
    static constexpr int PER_VEC = 8;
    static constexpr unsigned MAG = 0x7fffu;
    __device__ static unsigned bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
    __device__ static __nv_bfloat16 from_bits(unsigned h) { return __ushort_as_bfloat16((unsigned short)h); }
    __device__ static unsigned key(__nv_bfloat16 v) { return bits(v) & MAG; }
    __device__ static void keys(uint4 v, unsigned k[8]) {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
        for (int i = 0; i < 4; ++i) {
            k[2 * i] = w[i] & MAG;
            k[2 * i + 1] = (w[i] >> 16) & MAG;
        }
    }
    __device__ static float scale(unsigned key, float qmax) {
        const float amax = __bfloat162float(__ushort_as_bfloat16((unsigned short)key));
        return amax > 0.0f ? bf16r(__fmul_rn(amax, __fdiv_rn(1.0f, qmax))) : 1.0f;
    }
    __device__ static unsigned scale_bits(float s) { return __bfloat16_as_ushort(__float2bfloat16_rn(s)); }
    // Each op in fp32, its result rounded to bf16; x / scale and the
    // clamped code also, since rint of a bf16 value and the clamp's fp32
    // bounds are rounded back to bf16 there.
    __device__ static __nv_bfloat16 quant(__nv_bfloat16 xb, float s, float lo, float hi) {
        const float x = __bfloat162float(xb);
        float v = bf16r(rintf(bf16r(__fdiv_rn(x, s))));
        if (v == v) v = bf16r(fminf(fmaxf(v, lo), hi));
        const float d = bf16r(__fsub_rn(bf16r(__fmul_rn(v, s)), x));
        return __float2bfloat16_rn(__fadd_rn(x, d));
    }
    // One element's bits (the low 16 of h); with `zeros`, ±0 gives +0
    // without the arithmetic.
    __device__ static unsigned quant_bits(unsigned h, float s, float lo, float hi, bool zeros) {
        return zeros && (h & MAG) == 0u ? 0u : bits(quant(from_bits(h), s, lo, hi));
    }
    __device__ static unsigned quant2(unsigned w, float s, float lo, float hi, bool zeros) {
        return quant_bits(w & 0xffffu, s, lo, hi, zeros) | (quant_bits(w >> 16, s, lo, hi, zeros) << 16);
    }
    __device__ static uint4 quant(uint4 v, float s, float lo, float hi, bool zeros) {
        return make_uint4(quant2(v.x, s, lo, hi, zeros), quant2(v.y, s, lo, hi, zeros), quant2(v.z, s, lo, hi, zeros),
                          quant2(v.w, s, lo, hi, zeros));
    }
};

// A warp's stage of the positions of its keys: twice what one step of the
// warp reads (512 fp32 keys, 1,024 bf16 keys), flushed at half. The dynamic
// shared memory of a digit pass: the block's histogram, each warp's stage,
// the last block's flag (24.6 KB in fp32, 40.0 KB in bf16).
template <typename T>
__host__ __device__ constexpr int stage_keys() { return 2 * 32 * LANE_VECS * Elem<T>::PER_VEC; }
template <typename T>
__host__ __device__ constexpr int smem_bytes() { return 4 * (MAX_BINS + WARPS * stage_keys<T>() + 1); }

// Copy a warp's staged elements to the scratch buffer at slots taken from
// the pass's count: their bits (x just read them: a cache hit) to
// scratch[slot], their positions to scratch[cap + slot]. Elements past the
// capacity are dropped (the count still grows).
template <typename T>
__device__ inline void flush(const T* x, const unsigned* stage, unsigned& staged, unsigned* count, unsigned* scratch,
                             unsigned cap, int lane) {
    __syncwarp();
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(count, staged);
    base = __shfl_sync(FULL, base, 0);
    for (unsigned i = lane; i < staged; i += 32)
        if (base + i < cap) {
            const unsigned at = stage[i];
            scratch[base + i] = Elem<T>::bits(x[at]);
            scratch[cap + base + i] = at;
        }
    __syncwarp();
    staged = 0;
}

// The last block of pass p: picks the digit whose bin holds the rank-th
// largest key and writes the cursor of the next pass (or the statistic).
// ``cur`` is the cursor every thread read when the pass began: one thread
// rewrites st->cur here. Thread t sums bins [t·per, (t+1)·per); a suffix
// scan over the threads finds the one whose bins hold the rank, and it
// walks them from the top.
__device__ inline void resolve(State* st, const Cursor& cur, unsigned* h, unsigned* scan, int p, int kb, unsigned k,
                               unsigned cap) {
    const int t = threadIdx.x, width = digit_width(kb, p), bins = 1 << width;
    for (int b = t; b < bins; b += THREADS) h[b] = __ldcg(&st->hist[p][b]);
    __syncthreads();
    const int per = (bins + THREADS - 1) / THREADS;
    const int lo = t * per < bins ? t * per : bins, hi = lo + per < bins ? lo + per : bins;
    unsigned s = 0;
    for (int b = lo; b < hi; ++b) s += h[b];
    scan[t] = s;
    __syncthreads();
    for (int off = 1; off < THREADS; off *= 2) {      // scan[t] = Σ of threads t' ≥ t
        const unsigned v = t + off < THREADS ? scan[t + off] : 0u;
        __syncthreads();
        scan[t] += v;
        __syncthreads();
    }
    const unsigned r = p == 0 ? k : cur.rank;
    if (p == 0 && r > scan[0]) {                       // the k-th largest is a zero: key stays 0
        if (t == 0) st->cur.done = 1;
        return;
    }
    const unsigned above = scan[t] - s;
    if (!(above < r && r <= scan[t])) return;
    unsigned acc = above;
    int d = hi - 1;
    for (; d > lo; --d) {
        if (acc + h[d] >= r) break;
        acc += h[d];
    }
    const unsigned prefix = (p == 0 ? 0u : cur.prefix << width) | (unsigned)d;
    if (p + 1 == digit_passes(kb)) {
        st->key = prefix;
        st->cur.done = 1;
        return;
    }
    st->cur.prefix = prefix;
    st->cur.rank = r - acc;
    if (cur.src == 0) {
        const unsigned c = __ldcg(&st->count[p]);
        if (c <= cap) {
            st->cur.src = 1;
            st->cur.m = c;
        }
    }
}

// Digit pass p of the k-th largest key (1 ≤ k ≤ n). vec: x is 16-byte
// aligned (else it is read element by element). scratch: 2 · cap words.
// Launched with smem_bytes<T>() of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
select_pass(const T* __restrict__ x, long long n, int vec, unsigned* __restrict__ scratch, unsigned cap, State* st,
            int p, unsigned k) {
    using E = Elem<T>;
    constexpr int KB = E::KEY_BITS, V = E::PER_VEC, U = LANE_VECS, STAGE = stage_keys<T>();
    extern __shared__ unsigned fq_smem[];
    unsigned* hist = fq_smem;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    unsigned* stage = fq_smem + MAX_BINS + warp * STAGE;
    unsigned* last = fq_smem + MAX_BINS + WARPS * STAGE;
    const Cursor cur = st->cur;
    if (cur.done) return;
    const int shift = digit_shift(KB, p), width = digit_width(KB, p), bins = 1 << width;
    const int above = shift + width;                  // the chosen prefix's bits lie above
    const bool from_x = cur.src == 0;
    const bool compact = from_x && p + 1 < digit_passes(KB);
    for (int b = threadIdx.x; b < bins; b += THREADS) hist[b] = 0;
    __syncthreads();

    const unsigned lt = (1u << lane) - 1u;
    unsigned staged = 0;                               // the same in every lane of the warp
    auto take = [&](unsigned key, bool valid, unsigned at) {     // at: the element's position in x
        const bool hit = valid && key != 0u && (key >> above) == cur.prefix;
        const unsigned act = __ballot_sync(FULL, hit);
        if (act == 0u) return;
        const unsigned bin = (key >> shift) & (unsigned)(bins - 1);
        const unsigned peers = __match_any_sync(FULL, hit ? bin : NO_BIN);
        if (hit && (peers & lt) == 0u) atomicAdd(&hist[bin], (unsigned)__popc(peers));
        if (compact) {
            if (hit) stage[staged + __popc(act & lt)] = at;
            staged += __popc(act);
        }
    };
    const long long gw = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32, tw = (long long)gridDim.x * WARPS;
    if (from_x && vec) {
        const long long nvec = n / V;
        const uint4* xv = reinterpret_cast<const uint4*>(x);
        for (long long v0 = gw * 32 * U; v0 < nvec; v0 += tw * 32 * U) {
            uint4 raw[U];
            for (int u = 0; u < U; ++u) {
                const long long v = v0 + u * 32 + lane;
                raw[u] = v < nvec ? xv[v] : make_uint4(0u, 0u, 0u, 0u);
            }
            for (int u = 0; u < U; ++u) {
                unsigned keys[V];
                E::keys(raw[u], keys);
                const unsigned at = (unsigned)((v0 + u * 32 + lane) * V);
                for (int j = 0; j < V; ++j) take(keys[j], true, at + j);   // zeros stand in past the end
            }
            if (compact && staged >= STAGE / 2) flush(x, stage, staged, &st->count[p], scratch, cap, lane);
        }
        if (gw == 0) {                                 // the last n mod V elements
            const long long i = nvec * V + lane;
            take(i < n ? E::key(x[i]) : 0u, i < n, (unsigned)i);
        }
    } else if (from_x) {
        for (long long i0 = gw * 32; i0 < n; i0 += tw * 32) {
            const long long i = i0 + lane;
            take(i < n ? E::key(x[i]) : 0u, i < n, (unsigned)i);
            if (compact && staged >= STAGE / 2) flush(x, stage, staged, &st->count[p], scratch, cap, lane);
        }
    } else {
        const long long m = cur.m;
        for (long long i0 = gw * 32; i0 < m; i0 += tw * 32) {
            const long long i = i0 + lane;
            take(i < m ? scratch[i] & E::MAG : 0u, i < m, 0u);
        }
    }
    if (compact && staged) flush(x, stage, staged, &st->count[p], scratch, cap, lane);
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += THREADS)
        if (hist[b]) atomicAdd(&st->hist[p][b], hist[b]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(&st->arrivals[p], 1u) == gridDim.x - 1 ? 1u : 0u;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    resolve(st, cur, hist, fq_smem + MAX_BINS, p, KB, k, cap);
}

// The largest key (percentile None). Launched with WARPS words of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS) max_pass(const T* __restrict__ x, long long n, int vec, State* st) {
    using E = Elem<T>;
    constexpr int V = E::PER_VEC;
    extern __shared__ unsigned fq_smem[];
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x, stride = (long long)gridDim.x * THREADS;
    unsigned best = 0;
    const long long nvec = vec ? n / V : 0;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long v = tid; v < nvec; v += stride) {
        unsigned keys[V];
        E::keys(xv[v], keys);
        for (int j = 0; j < V; ++j) best = keys[j] > best ? keys[j] : best;
    }
    for (long long i = nvec * V + tid; i < n; i += stride) {
        const unsigned key = E::key(x[i]);
        best = key > best ? key : best;
    }
    for (int off = 16; off > 0; off /= 2) {
        const unsigned o = __shfl_xor_sync(FULL, best, off);
        best = o > best ? o : best;
    }
    if (threadIdx.x % 32 == 0) fq_smem[threadIdx.x / 32] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < WARPS; ++w) best = fq_smem[w] > best ? fq_smem[w] : best;
        if (best) atomicMax(&st->key, best);
    }
}

// out = fake-quantized x, the scale from st->key. vec: x is 16-byte aligned
// (out always is). With a finite scale above 0 (a tiny amax's scale can
// round to 0), ±0 quantizes to +0 (±0 / s, rint, clamp and · s keep ±0;
// ±0 − ±0 is +0, and ±0 + +0 is +0). So where the caller zeroed out
// (zeroed: the percentile, whose first digit pass copied every nonzero
// element to the scratch buffer) and they all fitted, only those are
// written: out[position] from their bits. Else every element is read and
// written, zeros without the arithmetic, element by element: a warp runs
// the division only for the elements some lane holds a nonzero in.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize(const T* __restrict__ x, T* __restrict__ out, long long n, int vec, State* st, float qmax, float lo, float hi,
         const unsigned* __restrict__ scratch, unsigned cap, int zeroed) {
    using E = Elem<T>;
    constexpr int V = E::PER_VEC;
    const float s = E::scale(st->key, qmax);
    const bool fast_zeros = s > 0.0f && s < __uint_as_float(0x7f800000u);
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x, stride = (long long)gridDim.x * THREADS;
    if (tid == 0) st->scale = E::scale_bits(s);
    if (zeroed && fast_zeros && st->count[0] <= cap) {
        const long long m = st->count[0];
        for (long long i = tid; i < m; i += stride)
            out[scratch[cap + i]] = E::from_bits(E::quant_bits(scratch[i], s, lo, hi, false));
        return;
    }
    const long long nvec = vec ? n / V : 0;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    long long v = tid;
    for (; v + stride < nvec; v += 2 * stride) {      // two vectors in flight a thread
        const uint4 a = xv[v], b = xv[v + stride];
        ov[v] = E::quant(a, s, lo, hi, fast_zeros);
        ov[v + stride] = E::quant(b, s, lo, hi, fast_zeros);
    }
    if (v < nvec) ov[v] = E::quant(xv[v], s, lo, hi, fast_zeros);
    for (long long i = nvec * V + tid; i < n; i += stride) out[i] = E::quant(x[i], s, lo, hi);
}

}  // namespace fq
