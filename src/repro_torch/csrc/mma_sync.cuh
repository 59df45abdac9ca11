// mma.sync building blocks of flash_attention.cu's mma_sync forward (d 16
// and 32): ldmatrix fragment loads, the m16n8k16 product with float32
// accumulation, and cp.async copies of padded row tiles.
//
// Fragments of m16n8k16 (g = lane / 4, t4 = lane % 4): the A operand (16 x 16)
// holds a0 (row g, k 2 t4, 2 t4 + 1), a1 (row g + 8, the same k), a2 (row g,
// k 2 t4 + 8, + 9), a3 (row g + 8, those k); the accumulator (16 x 8) holds
// c0, c1 (row g, columns 2 t4, 2 t4 + 1) and c2, c3 (row g + 8, the same
// columns). So the accumulators of two neighbouring 8-column tiles, rounded
// to 16 bits in pairs, are the A operand of a product over those 16 columns.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ckv {

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] * b[16x8], float32 accumulation
template <typename T>
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 16-byte asynchronous copy; a false predicate fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of a (positions, HD) slab with row stride `ss` into a
// shared tile of row stride HD + 8 (the padding puts the 8 rows of an
// ldmatrix on distinct banks); rows at or past `n_rows` are zeros
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void tile_async(T* dst, const T* src, long long ss, int r0,
                                           int n_rows) {
  constexpr int VPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += blockDim.x) {
    int r = i / VPR, c = (i % VPR) * 8;
    bool ok = r0 + r < n_rows;
    cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * ss + c : src, ok);
  }
}

}  // namespace ckv
