// The PTX instructions the port's hand-written kernels use, each in one small
// inline device function: the asynchronous global → shared copy (cp.async),
// the shared-memory matrix load (ldmatrix) and the bf16 tensor-core product
// (mma.sync m16n8k16). Used by the LM's flash attention (K4), the fused GCN
// layer's dense transform (K2, xw_kernel) and the FM interaction (K3): each
// launcher file includes this header before its kernels; a host-compiler
// check of the kernels includes stand-ins with the same names and the PTX
// ISA's fragment layouts instead.
//
// Fragments of mma.sync.m16n8k16 with bf16 A and B and fp32 C (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"), for lane l, g = l / 4, t = l % 4:
//   A (16 × 16, row-major), four .b32 of two bf16 (lower column in the lower
//     half): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
//     a3 = A[g+8][2t+8, 2t+9];
//   B (16 × 8, column-major): b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 × 8 fp32): c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// ldmatrix .x4 loads four 8 × 8 b16 matrices whose rows lanes 8i .. 8i+7 point
// at; register i of lane l holds row l / 4, elements 2(l % 4) and 2(l % 4) + 1
// of matrix i, or with .trans the elements [2(l % 4)][l / 4] and
// [2(l % 4) + 1][l / 4].

#pragma once

namespace ptx {

__device__ inline unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from global src to shared dst without the threads
// waiting; with fill false no byte is read and dst is zeroed. 16-byte copies
// bypass L1 (.cg), the smaller ones cannot (.ca).
template <int BYTES>
__device__ inline void cp_async(void* dst, const void* src, bool fill) {
    static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
    const int n = fill ? BYTES : 0;
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n)
                     : "memory");
    } else if constexpr (BYTES == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n)
                     : "memory");
    }
}

// Copy n of 16 bytes (0 ≤ n ≤ 16) from global src to shared dst and zero the
// other 16 − n, bypassing L1; both addresses 16-byte aligned.
__device__ inline void cp_async_16(void* dst, const void* src, int n) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// Close the group of copies issued since the last commit.
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until every copy this thread issued has landed (the other threads'
// copies are visible after the next __syncthreads()).
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Wait until at most N of this thread's most recent commit groups are still
// in flight.
template <int N>
__device__ inline void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void ldmatrix_x4(unsigned r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(unsigned r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += A · B on the tensor cores: A 16 × 16 and B 16 × 8 in bf16, c in fp32.
__device__ inline void mma_bf16_16816(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ptx
