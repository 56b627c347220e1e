// Shared helpers for the attention kernels of fish_speech_tpu_torch.
//
// The kernels take bfloat16, float16 or float32 tensors and sum in float32
// (the tensor-core kernels multiply 16-bit operands, wgmma.cuh, and are
// templated on the 16-bit type through `Elem`).
// Each C entry point returns cudaGetLastError() after its launch (0 on
// success); the Python wrapper raises on anything else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
constexpr int kFloat16 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// The 16-bit element types of the tensor-core kernels, bf16 and fp16: the
// kernels are templated on the type and read from here what differs. kF16
// picks the PTX operand type (`.bf16` or `.f16`) of the mma and wgmma
// wrappers; from_float() rounds one fp32 value to nearest; pack() rounds two fp32 values to nearest into a pair (lo in
// the low half); lo()/hi() read a pair's halves as fp32; i8x2<E>(lo, hi)
// is byte E of lo and byte E of hi (int8) as an exact pair.
//  * bf16: a byte v with low bits m (7) and sign bit z becomes bf16
//    (128 + m) by OR-ing m into 0x4300, plus -128 (0xC300) or, with z set,
//    -256 (0xC380): both terms and their sum v are exact bf16 values.
//  * fp16: v ^ 0x80 (v + 128, 0..255) in the mantissa of 1024 (0x6400)
//    is the fp16 1024 + v + 128, exact (fp16 holds every integer up to
//    2048); taking 1152 (0x6480) off leaves v, exact.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kF16 = false;
  static constexpr int kCode = kBFloat16;
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
  template <int E>
  static __device__ __forceinline__ uint32_t i8x2(uint32_t lo, uint32_t hi) {
    const uint32_t w = __byte_perm(lo, hi, E | ((E + 4) << 8));
    const uint32_t m = (w & 0x007F007Fu) | 0x43004300u;
    const uint32_t z = (w & 0x00800080u) | 0xC300C300u;
    const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                     *reinterpret_cast<const __nv_bfloat162*>(&z));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};

template <>
struct Elem<__half> {
  static constexpr bool kF16 = true;
  static constexpr int kCode = kFloat16;
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  template <int E>
  static __device__ __forceinline__ uint32_t i8x2(uint32_t lo, uint32_t hi) {
    const uint32_t w = __byte_perm(lo, hi, E | ((E + 4) << 8));
    const uint32_t m = (w & 0x00FF00FFu) ^ 0x64806480u;  // 1024 + v + 128
    const uint32_t k = 0x64806480u;                      // 1152, 1152
    const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&m),
                              *reinterpret_cast<const __half2*>(&k));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};

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
