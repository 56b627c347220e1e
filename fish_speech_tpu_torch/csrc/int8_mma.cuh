// The int8 weight-only kernels on the tensor cores share two sets of
// pieces here. Their products' pieces: the exact int8 -> bf16 (or fp16)
// conversion of a weight fragment in registers (common.cuh
// `Elem<T>::i8x2`), the mma.sync product on T operands (`mma16`), and
// the cp.async arrival on a stage's mbarrier (the matvec at 1-16 rows,
// int8_mm.cu's "gemv_mma", and the fused FFN, int8_ffn.cu). And the
// skeleton of the matvec at 17-32 rows (int8_mm.cu's "gemv_cluster", the
// 32-row pool): y^T (O x B) = W^T x^T, W int8 (I, O) row-major as the
// session holds it, described below.
//
// An item is one 128-column box of W over a run of its rows (the K of the
// product). The split-K runs of one column tile are the blocks of one
// thread block cluster (at most 8, the portable limit), and their fp32
// sums meet in distributed shared memory: each block writes its sums of
// the tile to its own shared memory (`red`), the cluster meets at a
// barrier, and block r adds slice r of the tile's columns over every
// block's `red` in rank (run) order (`slice_sums`), then applies its
// epilogue. No partial leaves the SMs, no counter orders the blocks, and
// the order is fixed, so every run gives the same bits.
//
// A block is two consumer warpgroups (warps 0-3 and 4-7) and one producer
// warp (warp 8). The producer's lane 0 keeps STAGES stages in flight by
// TMA: a stage is a box of W (STAGE_ROWS rows x 128 bytes, 128-byte
// swizzle) and the same rows of x as a box of N8 = 8 ceil(B / 8) rows x 64
// bf16 (128-byte swizzle; TMA zero-fills the rows past B and the columns
// past I), both counted on the stage's `full` mbarrier; the eight consumer
// warps free a stage on its `empty` mbarrier. Warpgroup h takes k16 steps
// 2h and 2h + 1 of every stage over all 128 columns, and the two add their
// sums in a fixed order at the end. Lane (g = lane / 4, t = lane % 4) of
// warp w of a warpgroup reads 4 bytes, columns 32 w + 4 g .. + 3, of rows
// 2t, 2t + 1, 2t + 8, 2t + 9 of each k16 step (a warp's 32 loads fall on
// 32 banks through the swizzle) and turns each int8 into bf16 exactly
// (`Elem<T>::i8x2`): bytes 2j and 2j + 1 are M tile j of the warp (row g is
// column 32 w + 4 g + 2 j, row g + 8 the column after it). The products
// run on `mma.sync` m16n8k16 (W^T on M, x's rows on N in NT n8 tiles, x's
// fragments read from the stage's x box, conflict-free through the
// swizzle). A `wgmma.m64nN8k16` route (W^T on M from registers, x on N
// from shared memory, K-major) was built and timed beside it in one call on
// the H100: slower at 6 of the 7 serving shapes at 32 rows and 0.8% faster
// at the LM head (PERF.md), so mma.sync stays.
//
// The pieces take the type T of x (bf16, or fp16 on the `--half` serving
// path): x's boxes hold T, each int8 becomes T exactly, and the products
// run on mma.sync's `.bf16` or `.f16` operands; the fp32 sums, the scale
// and the one rounding of y are the same for both.
//
// The ring and the sums: dynamic shared memory is 1 KB of alignment slack
// | the W ring [STAGES][STAGE_ROWS][128] bytes | the x ring
// [STAGES][N8][64] bf16 | the sums [128 columns][N8 + 2] fp32 (a row of
// N8 + 2 words: the warps' pair stores fall on 32 banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

// What the consumers compute, for `scripts/int8_mm_bench.py`'s breakdown
// builds only: 0 the product; 1 the weight stream alone (each stage's words
// read from shared memory and folded by an xor, no conversion, no product);
// 2 the stream and the int8 -> bf16 conversions without the products.
#ifndef FS_INT8_PART
#define FS_INT8_PART 0
#endif

namespace fs {
namespace i8 {

constexpr int CONSUMERS = 256;               // two warpgroups
constexpr int THREADS = CONSUMERS + 32;      // and the producer warp
constexpr int PRODUCER_WARP = CONSUMERS / 32;
constexpr int BOX = 128;                     // an item's columns: one TMA box of W
constexpr int STAGE_ROWS = 64;               // W rows a stage: four k16 steps
constexpr int STAGES = 6;                    // stages in flight
constexpr int W_STAGE = STAGE_ROWS * BOX;    // bytes of a W box
constexpr int MAX_CLUSTER = 8;               // runs of a column tile (portable cluster size)

__host__ __device__ constexpr int x_stage_bytes(int n8) { return n8 * 128; }
__host__ __device__ constexpr int red_row(int n8) { return n8 + 2; }
__host__ __device__ constexpr int red_floats(int n8) { return BOX * red_row(n8); }

__host__ __device__ constexpr size_t smem_bytes(int n8) {
  return 1024 + (size_t)STAGES * (W_STAGE + x_stage_bytes(n8)) + (size_t)red_floats(n8) * 4;
}

// the cluster sizes the kernels take: 128 columns split evenly
__host__ __device__ constexpr bool cluster_ok(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8;
}

// the barrier counts one arrival of this thread once its cp.async copies
// so far have landed (its pending count is not raised: init counts them)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(fs::wg::smem_u32(bar)) : "memory");
}

// bar.sync on named barrier `id` (0 is __syncthreads') of n
// threads, whole warps
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The block's shared memory (see the top of the file).
struct Ring {
  uint8_t* w;    // [STAGES][STAGE_ROWS][BOX] int8
  uint8_t* x;    // [STAGES][N8][64] T (bf16 or fp16)
  float* red;    // [BOX][N8 + 2] fp32
  int xb;        // bytes of an x stage
  __device__ Ring(unsigned char* raw, int n8) {
    w = raw + ((1024 - wg::smem_u32(raw) % 1024) % 1024);  // swizzled boxes: 1 KB aligned
    x = w + STAGES * W_STAGE;
    xb = x_stage_bytes(n8);
    red = reinterpret_cast<float*>(x + STAGES * xb);
  }
};

// Stage barriers: `full` completes once the stage's bytes have landed (one
// arrival, the producer's, with the bytes it expects), `empty` once the
// eight consumer warps have read the stage.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      tma::bar_init(&full[st], 1);
      tma::bar_init(&empty[st], CONSUMERS / 32);
    }
    tma::bar_init_fence();
  }
  __syncthreads();
}

// The producer's slot for the block's stage `seq` (its count of stages so
// far): waits until the consumers have freed it; every lane of the
// producer warp calls it.
__device__ __forceinline__ int acquire_slot(uint64_t* empty, uint32_t seq) {
  const int slot = seq % STAGES;
  if (seq >= STAGES) tma::bar_wait_sleep_or_trap(&empty[slot], (seq / STAGES - 1) & 1);
  return slot;
}

// Lane 0 of the producer: stage `slot` expects a W box and an x box, and
// the W box (column col, row `row` of map w) is asked for. The x box
// comes with it (`load_x`) or later.
__device__ __forceinline__ void load_w(const Ring& r, uint64_t* full, int slot,
                                       const CUtensorMap* w, int col, int row) {
  tma::bar_expect(&full[slot], W_STAGE + r.xb);
  tma::load_2d(r.w + slot * W_STAGE, w, &full[slot], col, row);
}

// rows [k, k + 64) of every row of x (map xm: B rows of x, boxes of 64 x N8)
__device__ __forceinline__ void load_x(const Ring& r, uint64_t* full, int slot,
                                       const CUtensorMap* xm, int k) {
  tma::load_2d(r.x + slot * r.xb, xm, &full[slot], k, 0);
}

// d += a b: m16n8k16, T (bf16 or fp16) in, fp32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (Elem<T>::kF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// the int8 pairs of one M tile's A fragment: bytes LO and LO + 1 of the
// four words v (rows 2t, 2t + 1, 2t + 8, 2t + 9 of a k16 step) as exact T
// pairs: [0] = (LO of v0, LO of v1), [1] = (LO + 1 of v0, v1), [2] and [3]
// the same of v2, v3
template <typename T, int LO>
__device__ __forceinline__ void i8_fragment(uint32_t (&a)[4], uint32_t v0, uint32_t v1,
                                            uint32_t v2, uint32_t v3) {
  a[0] = Elem<T>::template i8x2<LO>(v0, v1);
  a[1] = Elem<T>::template i8x2<LO + 1>(v0, v1);
  a[2] = Elem<T>::template i8x2<LO>(v2, v3);
  a[3] = Elem<T>::template i8x2<LO + 1>(v2, v3);
}

// A consumer thread's sums: acc[j][nt][e] is M tile j of its warp against
// x rows 8 nt .. 8 nt + 7, in mma.sync's accumulator layout (e = 0, 1: row
// g, x rows 8 nt + 2t, + 1; e = 2, 3: row g + 8).
template <int NT>
using Acc = float[2][NT][4];

// The W fragments of k16 step kk of the box in T: f[j] is M tile j of the
// warp (the lane map at the top of the file), v the four words read.
template <typename T>
__device__ __forceinline__ void w_fragments(const uint8_t* box, int kk, int chunk,
                                            int byte4, int t, uint32_t (&f)[2][4],
                                            uint32_t (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 16 * kk + 2 * t + (e & 1) + 8 * (e >> 1);  // R % 8 = 2t, 2t + 1
    v[e] = *reinterpret_cast<const uint32_t*>(
        box + row * BOX + ((chunk ^ (2 * t + (e & 1))) << 4) + byte4);
  }
  i8_fragment<T, 0>(f[0], v[0], v[1], v[2], v[3]);
  i8_fragment<T, 2>(f[1], v[0], v[1], v[2], v[3]);
}

// The consumer warpgroups' sums over n_stage stages, the block's stages
// seq .. seq + n_stage - 1, into acc (zeroed here; warpgroup h's k16 steps
// 2h, 2h + 1 of each stage). Every consumer thread calls it; it frees each
// stage once read. T is x's type (bf16 or fp16).
template <int NT, typename T>
__device__ __forceinline__ void mainloop(const Ring& r, uint64_t* full, uint64_t* empty,
                                         uint32_t seq, int n_stage, Acc<NT>& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp >> 2, g = lane >> 2, t = lane & 3;
  // the lane's 4 bytes of a box row R: columns 32 w + 4 g .. + 3, in the
  // 16-byte chunk 2 w + g / 4 (at chunk ^ (R % 8)), bytes 4 (g % 4) ..
  const int chunk = 2 * (warp & 3) + (g >> 2), byte4 = 4 * (g & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
  for (int st = 0; st < n_stage; ++st) {
    const uint32_t at = seq + st;
    const int slot = at % STAGES;
    tma::bar_wait_sleep_or_trap(&full[slot], (at / STAGES) & 1);
    __syncwarp();  // the warp together again for the .aligned products
    const uint8_t* box = r.w + slot * W_STAGE;
    const uint8_t* xs = r.x + slot * r.xb;
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int kk = 2 * h + s2;
      uint32_t f[2][4], v[4];
      w_fragments<T>(box, kk, chunk, byte4, t, f, v);
      if (FS_INT8_PART == 1) {  // the stream alone
        acc[0][0][0] += __uint_as_float((v[0] ^ v[1] ^ v[2] ^ v[3]) & 0x3F7FFFFFu);
        continue;
      }
      if (FS_INT8_PART == 2) {  // the conversions, no product
        acc[0][0][0] += __uint_as_float((f[0][0] ^ f[0][3] ^ f[1][0] ^ f[1][3]) & 0x3F7FFFFFu);
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;  // x row n, (n & 7) == g
        const uint8_t* xr = xs + n * 128 + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + (((2 * kk) ^ g) << 4));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + (((2 * kk + 1) ^ g) << 4));
        mma16<T>(acc[0][nt], f[0], b0, b1);
        mma16<T>(acc[1][nt], f[1], b0, b1);
      }
    }
    // the stage's generic reads are ordered before the TMA writes that
    // refill the slot once it is freed
    tma::fence_proxy_async();
    __syncwarp();
    if (lane == 0) tma::bar_arrive(&empty[slot]);
  }
}

// Named barrier of the 256 consumer threads (the producer never waits on it).
constexpr int kConsumerBar = 2;

// The consumers' sums into red[c][n] (column c of the item, row n of x),
// every row of the N8, in float pairs (n, n + 1): warpgroup 1 stores its
// sums, then warpgroup 0 adds its own to them (the same order every run).
template <int NT>
__device__ __forceinline__ void store_sums(float* red, const Acc<NT>& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp >> 2, g = lane >> 2, t = lane & 3;
  constexpr int RR = red_row(8 * NT);
  for (int pass = 1; pass >= 0; --pass) {
    if (h == pass) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = 32 * (warp & 3) + 4 * g + 2 * j, n = 8 * nt + 2 * t;
          float2* lo = reinterpret_cast<float2*>(red + c * RR + n);
          float2* hi = reinterpret_cast<float2*>(red + (c + 1) * RR + n);
          float2 a = make_float2(acc[j][nt][0], acc[j][nt][1]);
          float2 b = make_float2(acc[j][nt][2], acc[j][nt][3]);
          if (pass == 0) {
            const float2 pa = *lo, pb = *hi;
            a = make_float2(a.x + pa.x, a.y + pa.y);
            b = make_float2(b.x + pb.x, b.y + pb.y);
          }
          *lo = a;
          *hi = b;
        }
    }
    named_sync(kConsumerBar, CONSUMERS);
  }
}

// After the cluster's barrier: this block's slice of the item's columns,
// summed over the cluster's blocks in rank order. For each (row n < B,
// column c of the slice, c the item's column) calls epi(n, c, v) where v
// holds rank q's sum in v[q], q < C (the epilogue adds them in order).
// Every consumer thread calls it; consecutive threads take consecutive
// columns (y's stores coalesce), and a thread loads SLICE_ELEMS elements'
// sums from every block before it adds any.
constexpr int SLICE_ELEMS = 4;

template <int NT, typename Epi>
__device__ __forceinline__ void slice_sums(const float* red, int batch, int c_size,
                                           int rank, Epi epi) {
  constexpr int RR = red_row(8 * NT);
  const int sl = BOX / c_size, c0 = rank * sl, total = batch * sl;
  const float* base[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) base[q] = cluster::map(red, q < c_size ? q : 0);
  for (int e0 = threadIdx.x; e0 < total; e0 += SLICE_ELEMS * CONSUMERS) {
    float v[SLICE_ELEMS][MAX_CLUSTER];
#pragma unroll
    for (int u = 0; u < SLICE_ELEMS; ++u) {
      const int e = e0 + u * CONSUMERS;
      const int off = (c0 + e % sl) * RR + e / sl;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        v[u][q] = e < total && q < c_size ? base[q][off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SLICE_ELEMS; ++u) {
      const int e = e0 + u * CONSUMERS;
      if (e < total) epi(e / sl, c0 + e % sl, v[u]);
    }
  }
}

// v[lo] + v[lo + 1] + ... + v[hi - 1], in that order (lo < hi <=
// MAX_CLUSTER; v indexed by constants only, so it stays in registers)
__device__ __forceinline__ float sum_in_order(const float (&v)[MAX_CLUSTER], int lo, int hi) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) {
    if (q == lo) s = v[q];
    else if (q > lo && q < hi) s += v[q];
  }
  return s;
}

// A launch of `kernel` over `grid` blocks of THREADS in clusters of
// `cluster` blocks, with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(Params...), int grid, int cluster,
                                    size_t smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace i8
}  // namespace fs
