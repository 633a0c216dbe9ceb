// PTX building blocks of the tensor-core attention kernels
// (flash_attention_*mma.cu, flash_attention*_wide.cu): 16-byte cp.async
// copies with zero-fill, ldmatrix (plain and transposed) and the bf16
// mma.sync m16n8k16 with f32 accumulation.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): with
// g = lane / 4 and t = lane % 4,
//   A (16x16, row-major), 4 registers of 2 bf16:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B (16x8, k x n), 2 registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//   C (16x8, f32), 4 floats: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// So the C fragments of two neighbouring n-blocks of a product are, pair
// for pair, the A fragment of the next product over those 16 columns:
// a0 = (c0, c1) and a1 = (c2, c3) of the first, a2 and a3 of the second.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory asynchronously; when `valid`
// is false nothing is read and the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// The same for one 4-byte word (an f32 of lse or dd).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives row l / 4, elements 2(l % 4) and
// 2(l % 4) + 1 of each matrix (r[i] from matrix i).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldsm_x4, each matrix transposed: lane l receives elements
// (2(l % 4), l / 4) and (2(l % 4) + 1, l / 4) of each matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A.B for one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Barrier over the `threads` threads (a multiple of 32, whole warps) that
// use hardware barrier `id` (1-15; __syncthreads takes 0). Like
// __syncthreads, it orders their shared-memory accesses.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Two f32 values rounded to bf16 (round to nearest even) in one register,
// `lo` in the low half: the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage rows [r0, r0 + kRows) of a [N, C] bf16 matrix into shared memory as
// [kRows][ld] (ld = C + 8 elements: a 16-byte pad, so that the 8 rows an
// ldmatrix reads start in 8 different bank groups), 16 bytes a copy, zeros
// past N. C % 8 == 0.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ src,
                                           __nv_bfloat16* dst, int r0, int N,
                                           int C, int ld, int tid) {
  const int chunks = C / 8;  // 16-byte chunks a row
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const bool valid = r0 + r < N;
    // a row past N reads nothing; its address is the (valid) base pointer
    cp_async16(dst + r * ld + c, valid ? src + (size_t)(r0 + r) * C + c : src,
               valid);
  }
}

}  // namespace mma
