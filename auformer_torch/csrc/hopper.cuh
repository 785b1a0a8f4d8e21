// Warp-level tensor-core and asynchronous-copy helpers shared by the
// kernels under csrc/ (Hopper, sm_90a; all of them exist since sm_80).
//
// Fragment layouts of mma.sync (PTX ISA, "Matrix Fragments for mma.m16n8k*"),
// with g = lane / 4 and t = lane % 4:
//   C, D (16 x 8 f32):         c0, c1 = (row g, cols 2t, 2t+1),
//                              c2, c3 = (row g+8, cols 2t, 2t+1)
//   m16n8k16 bf16 A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                              a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   m16n8k16 bf16 B (16 x 8):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, g)
//   m16n8k8 tf32 A (16 x 8):   a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4),
//                              a3 = (g+8, t+4)
//   m16n8k8 tf32 B (8 x 8):    b0 = (k t, col g), b1 = (k t+4, col g)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; both addresses 16-aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane (g, t) gets rows 2t, 2t+1 of col g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, tf32 operands (given as f32 bit patterns), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small with both parts tf32: the 3xTF32 split. big*big +
// big*small + small*big recovers an f32 product to ~2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// Two f32 -> one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo to ~2^-17 relative, hi and lo bf16 pairs: two bf16 MMAs
// on (hi, lo) carry an f32 operand at ~16 bits of mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

}  // namespace hk
