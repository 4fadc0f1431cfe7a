// Inline PTX for the port's tensor-core kernels on Hopper (sm_90a):
// asynchronous global -> shared copies (cp.async), shared -> register
// fragment loads (ldmatrix) and the warp-level bf16 product
// mma.sync.m16n8k16 with fp32 accumulation.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), each register
// two bf16 with the lower index in the low half:
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                           a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
//   B (16 x 8, "col"):      b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C (16 x 8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// ldmatrix gives lane l the elements (row l/4, cols 2(l%4), +1) of each 8x8
// matrix whose 8 row addresses lanes 8i..8i+7 supply; with .trans, the
// elements (rows 2(l%4), +1, col l/4).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1. With `pred` false nothing is
// read and the 16 bytes are zero-filled; `src` must still be a valid
// address.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on one 16 x 8 tile, k = 16, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx, results below 2^-126
// flushed to 0; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte i (0..3) of four packed int8, as an exact float: the byte, biased to
// unsigned, is placed in the mantissa of 2^23 and the bias taken off.
__device__ __forceinline__ float int8_byte_to_float(uint32_t biased, int i) {
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7540u | i);
  return __uint_as_float(bits) - 8388736.0f;  // 2^23 + 128
}

// Two floats that are small integers (|v| <= 255: at most 8 significant
// bits) -> bf16x2 by keeping each one's top 16 bits, which is exact for
// them; one byte permute in place of a conversion.
__device__ __forceinline__ uint32_t pack_bf16x2_small_ints(float lo,
                                                           float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// Four packed int8 (|v| <= 127 widens to bf16 exactly) -> two bf16x2.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t packed,
                                                 uint32_t& lo, uint32_t& hi) {
  const uint32_t biased = packed ^ 0x80808080u;
  lo = pack_bf16x2_small_ints(int8_byte_to_float(biased, 0),
                              int8_byte_to_float(biased, 1));
  hi = pack_bf16x2_small_ints(int8_byte_to_float(biased, 2),
                              int8_byte_to_float(biased, 3));
}

}  // namespace repro_ptx
