// fp32 products on the tensor cores, as sums of TF32 terms.
//
// mma.sync m16n8k8 with .tf32 operands multiplies 11-bit significands
// exactly and sums in fp32. An fp32 value x is the sum of two TF32 values,
// big = x with its 13 low significand bits cleared and small = the same of
// x - big (x - big is exact), to within 2^-20 |x|: two bit operations and
// a subtraction at the full rate of the ALU (`cvt.rna.tf32.f32`, which
// rounds, is slower: dropping it took the fp32 prefill at T = 1024 from
// 0.326 to 0.245 ms on an H100). So a product of an fp32 and an exact
// TF32 value (an int4 weight, an int8 cache entry) takes two mmas (big b +
// small b), and a product of two fp32 values three (big big + big small +
// small big; small small is below 2^-20 of the product): the fp32
// kernels' "fp32_tc" routes (int4_mm.cuh `int4_tf32_kernel`, flash_fp32.cu
// `attn_tf32_kernel`).

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace fs {
namespace tf32 {

constexpr uint32_t kTf32Mask = 0xFFFFE000u;  // sign, exponent, 10 significand bits

// x = big + small to within 2^-20 |x|, both TF32 values (truncated)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & kTf32Mask;
  small = __float_as_uint(x - __uint_as_float(big)) & kTf32Mask;
}

// waits until at most N groups of this thread's cp.async copies are in
// flight (the mmas read the tiles through the generic proxy: no proxy fence)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a b: m16n8k8, row-major A (16 x 8), column-major B (8 x 8), fp32 sums.
// A: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B: b0 (k t, column g), b1 (t + 4, g); D: d0 (g, 2t), d1 (g, 2t + 1),
// d2 (g + 8, 2t), d3 (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
// Not volatile: the compiler may interleave independent mmas, so that an
// accumulator's next mma need not wait on its last one.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The low nibble of byte j of w (the other bits of each byte 0) as the
// exact fp32 (TF32) value nibble - 8: 2^23 + n by OR-ing n into 0x4B000000,
// minus 2^23 + 8.
template <int J>
__device__ __forceinline__ uint32_t nibble_q(uint32_t w) {
  return __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + J)) -
                         8388616.0f);
}

}  // namespace tf32
}  // namespace fs
