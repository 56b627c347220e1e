// Tensor Memory Accelerator (TMA) loads of 2D and 3D tiles into shared memory,
// for the split matvec and decode kernels (int4_mm.cuh, flash_decode.cu), and
// 1D bulk copies, for the fast-stack probe (faststack.cu), and the thread
// block cluster's pieces (its barrier and its distributed shared memory),
// for the int8 kernels (int8_mma.cuh).
//
// The host encodes a tensor map (`encode`, `encode_2d`: through
// cuTensorMapEncodeTiled, looked up once at run time; each map is encoded
// once and cached) and passes it by value as a __grid_constant__ kernel
// parameter, so a captured CUDA graph replays it.
// In the kernel one thread arms an mbarrier with the bytes to expect and
// issues the copy; the copy's completion flips the barrier's phase, which
// the consumers wait on. With the 128-byte swizzle a box row is 128 bytes
// and its 16-byte chunk c lands at chunk c ^ (row % 8) of a 1024-byte
// aligned tile, so eight rows read at one column hit eight bank groups.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

#include "common.cuh"
#include "wgmma.cuh"

namespace fs {
namespace tma {

// Everything that goes into a map: a cached map with an equal key is the
// map `encode_tiled` would build, whatever tensor now lives at `base`.
struct MapKey {
  int type = 0, rank = 0;
  const void* base = nullptr;
  cuuint64_t dims[3] = {0, 0, 0};
  cuuint64_t strides[2] = {0, 0};
  cuuint32_t box[3] = {0, 0, 0};
  int swizzle = 0;
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};
static_assert(sizeof(MapKey) == 72, "MapKey has no padding bytes");

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const auto* w = reinterpret_cast<const uint64_t*>(&k);
    uint64_t h = 0;
    for (size_t i = 0; i < sizeof(MapKey) / 8; ++i)
      h = (h ^ w[i]) * 0x9E3779B97F4A7C15ull;
    return (size_t)(h ^ (h >> 29));
  }
};

inline int encode_tiled(CUtensorMap* map, const MapKey& k) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode_fn = nullptr;
  if (encode_fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode_fn),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode_fn = nullptr;
      return (int)cudaErrorNotSupported;
    }
  }
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode_fn(
      map, (CUtensorMapDataType)k.type, k.rank, const_cast<void*>(k.base),
      k.dims, k.strides, k.box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      (CUtensorMapSwizzle)k.swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A map of a rank-`rank` (2 or 3) tensor: dims[0] contiguous elements, then
// dims[i] steps of strides[i - 1] bytes, read in boxes of box[] with the
// given swizzle (the 128-byte one unless named). Returns a CUDA error code
// (0 on success). Maps are encoded once and kept in one table keyed by
// every argument (a model's weights and a session's cache are fixed
// addresses, so the steady state encodes nothing); the table is cleared
// when it holds kMaxMaps, and a mutex guards it, as ctypes calls come
// without the GIL.
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                  const void* base, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  constexpr size_t kMaxMaps = 1 << 14;
  static std::mutex mu;
  struct Bytes {  // a map's bytes, kept without its 64-byte alignment
    unsigned char b[sizeof(CUtensorMap)];
  };
  static std::unordered_map<MapKey, Bytes, MapKeyHash> maps;
  if (rank < 1 || rank > 3) return (int)cudaErrorInvalidValue;
  MapKey k;
  k.type = (int)type;
  k.rank = rank;
  k.base = base;
  k.swizzle = (int)swizzle;
  for (int i = 0; i < rank; ++i) {
    k.dims[i] = dims[i];
    k.box[i] = box[i];
    if (i > 0) k.strides[i - 1] = strides[i - 1];
  }
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = maps.find(k);
  if (hit != maps.end()) {
    std::memcpy(map, hit->second.b, sizeof(CUtensorMap));
    return 0;
  }
  const int rc = encode_tiled(map, k);
  if (rc != 0) return rc;
  if (maps.size() >= kMaxMaps) maps.clear();
  Bytes bytes;
  std::memcpy(bytes.b, map, sizeof(CUtensorMap));
  maps.emplace(k, bytes);
  return 0;
}

// A 2D map of `outer` rows of `inner` elements, `row_bytes` apart, read in
// boxes of box_outer x box_inner.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, uint64_t inner, uint64_t outer,
                     uint64_t row_bytes, uint32_t box_inner,
                     uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode(map, type, 2, base, dims, strides, box);
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// that an arrival with expect_tx announced)
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(wg::smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(wg::smem_u32(bar)) : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(wg::smem_u32(bar)), "r"(bytes) : "memory");
}

// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra.uni WAIT;\n"
      "}\n"
      :: "r"(wg::smem_u32(bar)), "r"(parity) : "memory");
}

// true once the barrier's phase `parity` has completed (one try: the
// hardware may wait a little before it says no)
__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(wg::smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) writes to it, once a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar_try_wait whose thread sleeps until the phase completes (or a
// 1 ms hint runs out) instead of returning at once: waiting warps leave
// their issue slots to the warps that compute
__device__ __forceinline__ bool bar_try_wait_sleep(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(wg::smem_u32(bar)), "r"(parity), "r"(1000000u) : "memory");
  return done != 0;
}

// bar_wait_or_trap with bar_try_wait_sleep's tries
__device__ __forceinline__ void bar_wait_sleep_or_trap(uint64_t* bar, uint32_t parity) {
  if (bar_try_wait_sleep(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!bar_try_wait_sleep(bar, parity))
    if (now_ns() - t0 > kStuckNs) __trap();
}

// bar_wait, or a trap once the wait outlasts kStuckNs (common.cuh)
__device__ __forceinline__ void bar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t t0 = now_ns();
  for (unsigned n = 1; !bar_try_wait(bar, parity); ++n)
    if (n % 256 == 0 && now_ns() - t0 > kStuckNs) __trap();
}

// fetches a map's descriptor ahead of its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box at (x, y, z) of a rank-3 map into dst, counted on bar
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(wg::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(wg::smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// `bytes` (a multiple of 16) from src into dst, both 16-byte aligned, in one
// bulk copy counted on bar, with an L2 policy (`createpolicy`)
__device__ __forceinline__ void load_1d(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar,
                                        uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(wg::smem_u32(dst)), "l"(src), "r"(bytes), "r"(wg::smem_u32(bar)),
         "l"(policy)
      : "memory");
}

// the box at (x = inner coordinate, y = row) into dst, counted on bar
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(wg::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(wg::smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

}  // namespace tma

// Thread block clusters (sm_90). A launch without a cluster dimension is a
// grid of one-block clusters, where these act on the block alone.
namespace cluster {

// this block's rank in its cluster, and the cluster's size
__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every block of the cluster arrives, then waits for all:
// the memory accesses before it are seen by the accesses after it in
// every block of the cluster (release / acquire at cluster scope)
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the generic address of *p (this block's shared memory) in block `rank`
// of the cluster: plain loads through it read that block's shared memory
template <typename T>
__device__ __forceinline__ const T* map(const T* p, uint32_t rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

}  // namespace cluster
}  // namespace fs
