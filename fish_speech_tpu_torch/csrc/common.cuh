// Shared helpers for the attention kernels of fish_speech_tpu_torch.
//
// The kernels take bfloat16 or float32 tensors and sum in float32 (the
// tensor-core kernels multiply bf16 operands, wgmma.cuh).
// Each C entry point returns cudaGetLastError() after its launch (0 on
// success); the Python wrapper raises on anything else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace fs {

// Score of a masked key, as in the JAX package (ops/attention.py NEG_INF):
// finite, so a row with no visible key softmaxes to a uniform average
// instead of NaN.
constexpr float kMaskedScore = -1e30f;

constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Byte E of a word of four int8 values as an exact fp32 integer: wx is the
// word ^ 0x80808080 (each byte + 128), placed in the mantissa of 2^23, and
// 2^23 + 128 is taken off again (a byte permute and an add, in place of a
// conversion instruction, which the SM issues at a lower rate).
template <int E>
__device__ __forceinline__ float i8_to_f32(uint32_t wx) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 + E)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// atom.add with release and acquire semantics at GPU scope. After a
// __syncthreads(), one thread's call publishes the whole block's earlier
// global stores to the block that sees the last count (the pattern of
// CUTLASS's generic barrier), and that block's reads after a second
// __syncthreads() see every arrived block's stores.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

}  // namespace fs
