// Building blocks of the port's Hopper tensor-core (wgmma) kernels:
// `int4_wgmma_kernel` (int4_mm.cuh) and the attention forward of
// attn_wgmma.cuh (flash_train.cu, flash_prefill.cu).
//
// Shared-memory tiles are kept in the 128-byte swizzle: a tile is a stack
// of 1024-byte-aligned blocks of rows of 128 bytes (64 bf16), and the
// 16-byte chunk c of row m lies at chunk c ^ (m % 8) of its row. wgmma
// reads such a tile through a 64-bit descriptor (start address >> 4 in
// bits 0-13, leading byte offset >> 4 in bits 16-29, stride byte offset >> 4
// in bits 32-45, layout type 1 = 128-byte swizzle in bits 62-63).
//
// A register or descriptor that a wgmma reads must be computed before the
// `wgmma.fence` of its group: ptxas serializes the wgmmas of a group whose
// inputs are defined between them (warning C7513), so every caller builds
// its descriptors and fragments first and retires the group
// (`wgmma_wait<0>`) before it writes the group's registers again.
//
// Each product wrapper takes the 16-bit operand type T (bf16 by default,
// or __half): one asm body per wrapper, written once as a macro over the
// PTX type name and instantiated for `.bf16` and `.f16` (Elem<T>::kF16).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace fs {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte offset of the 16-byte chunk c of row m in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int m, int c) {
  return m * 128 + ((c ^ (m & 7)) << 4);
}

// 16-byte copy to shared memory; zero-filled when !valid (src must still
// be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4-byte copy to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N groups of this thread's copies are in flight, then
// makes the landed tiles visible to wgmma's (async proxy) reads
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a K-major, 128-byte-swizzled tile (rows of the operand are
// K-contiguous): leading byte offset 16 (unused by this layout), stride
// 1024 bytes between 8-row groups. A k16 step inside the 64-wide block is
// +32 bytes of start address; the next block of 64 K is the next stack.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// descriptor of an MN-major, 128-byte-swizzled tile (rows are K, each
// N-contiguous; read with the transpose-B flag): stride byte offset 1024
// between groups of 8 K rows, leading byte offset `mn_block` bytes between
// the stacked blocks of 64 N columns. A k16 step is +16 rows = +2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr, uint32_t mn_block) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(mn_block >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmmas
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator and A-fragment layout of an m64nNk16 wgmma, for the thread
// at lane 4g + t of warp w of the warpgroup: accumulator i holds row
// 16w + g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2t + i % 2; the A
// fragment's registers 0-3 hold rows (16w + g, 16w + g + 8, 16w + g,
// 16w + g + 8) at K (2t, 2t + 1), (2t, 2t + 1), (2t + 8, 2t + 9),
// (2t + 8, 2t + 9), the lower K in the low 16 bits.

// d (64 x 128, fp32) += a (64 x 16, T, registers) * b (16 x 128, T,
// shared memory, K-major)
#define FS_WGMMA_M64N128K16_RS(TY) \
  asm volatile(                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "                \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "                \
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),            \
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),            \
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
        "+f"(d[62]), "+f"(d[63])                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    FS_WGMMA_M64N128K16_RS("f16");
  } else {
    FS_WGMMA_M64N128K16_RS("bf16");
  }
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + a (64 x 16) * b (16 x 64), both
// T from shared memory, both K-major
#define FS_WGMMA_M64N64K16_SS(TY) \
  asm volatile(                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                \
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])             \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kF16) {
    FS_WGMMA_M64N64K16_SS("f16");
  } else {
    FS_WGMMA_M64N64K16_SS("bf16");
  }
}

// d (64 x 64, fp32) += a (64 x 16, T, registers) * b (16 x 64, T,
// shared memory, MN-major: the transpose-B flag is set)
#define FS_WGMMA_M64N64K16_RS_TB(TY) \
  asm volatile(                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                \
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    FS_WGMMA_M64N64K16_RS_TB("f16");
  } else {
    FS_WGMMA_M64N64K16_RS_TB("bf16");
  }
}

// d (64 x 128, fp32) += a (64 x 16, T, registers) * b (16 x 128, T,
// shared memory, MN-major: the transpose-B flag is set)
#define FS_WGMMA_M64N128K16_RS_TB(TY) \
  asm volatile(                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "                \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "                \
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),            \
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),            \
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
        "+f"(d[62]), "+f"(d[63])                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    FS_WGMMA_M64N128K16_RS_TB("f16");
  } else {
    FS_WGMMA_M64N128K16_RS_TB("bf16");
  }
}

#undef FS_WGMMA_M64N128K16_RS
#undef FS_WGMMA_M64N64K16_SS
#undef FS_WGMMA_M64N64K16_RS_TB
#undef FS_WGMMA_M64N128K16_RS_TB

}  // namespace wg
}  // namespace fs
