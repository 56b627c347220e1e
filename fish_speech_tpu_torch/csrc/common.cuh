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

// A wait that outlasts this ends the launch with an error (a trap) instead
// of hanging the card: the kernels that wait on other blocks or on copies
// take milliseconds.
constexpr uint64_t kStuckNs = 10000000000ull;

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One thread of every block of a co-resident grid, after its block's sync:
// returns once every block has arrived, and all stores a block made before
// its sync are then seen by the loads of every block after its next sync.
// The top bit of *bar flips once all blocks have arrived (block 0 adds
// 2^31 - (blocks - 1), the others 1, so the low bits come back unchanged
// and the word needs no reset: the scheme of cooperative groups' grid
// sync); a release add to arrive, acquire loads to wait (CUTLASS's generic
// barrier does the same; a __threadfence on each side instead was slower).
__device__ __forceinline__ void grid_arrive_wait(unsigned* bar) {
  const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
  unsigned old;  // the release publishes the block's stores (after the sync)
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(bar), "r"(inc) : "memory");
  const uint64_t t0 = now_ns();
  unsigned now;
  for (unsigned n = 1;; ++n) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(now) : "l"(bar) : "memory");
    if ((old ^ now) & 0x80000000u) break;
    if (n % 256 == 0 && now_ns() - t0 > kStuckNs) __trap();
  }
}

}  // namespace fs
