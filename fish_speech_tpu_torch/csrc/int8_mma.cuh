// Pieces shared by the int8 weight-only kernels on the tensor cores
// (int8_mm.cu, int8_ffn.cu): the mma.sync product, the cp.async arrival
// on a stage's mbarrier, and the exact int8 -> bf16 conversion of a weight
// fragment in registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace fs {
namespace i8 {

// d += a b: m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the barrier counts one arrival of this thread once its cp.async copies
// so far have landed (its pending count is not raised: init counts them)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(fs::wg::smem_u32(bar)) : "memory");
}

// Byte E of lo and byte E of hi (int8) as a bf16 pair, lo in the low half.
// A byte v with low bits m (7) and sign bit z becomes bf16 (128 + m) by
// OR-ing m into 0x4300, plus -128 (0xC300) or, with z set, -256 (0xC380):
// both terms and their sum v are exact bf16 values, so the add is exact.
template <int E>
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t lo, uint32_t hi) {
  const uint32_t w = __byte_perm(lo, hi, E | ((E + 4) << 8));
  const uint32_t m = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t z = (w & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&z));
  return *reinterpret_cast<const uint32_t*>(&r);
}

}  // namespace i8
}  // namespace fs
