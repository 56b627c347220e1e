// int4 group-wise weight-only matmul, y (B, O) = x (B, I) @ W (I, O).
//
// Replaces the Pallas TPU kernel fish_speech_tpu/ops/pallas_int4.py
// (_int4_mm_kernel / int4_matmul). W is stored packed two values per byte
// in the half-split layout: byte p[r, o] holds W[r, o] in its low nibble and
// W[r + I/2, o] in its high nibble, each biased by 8; gs[I/g, O] are fp32
// scales per group of g original rows, and no group straddles the half split
// ((I/2) % g == 0).
//
// What bounds it on the H100: the product does 2 * B * I * O operations and
// must move the packed weight (I/2 * O bytes), its scales (4 * (I/g) * O),
// x (2 * B * I) and y (2 * B * O). At B = 1 (decode) that is far below the
// ~295 operations per byte where the card stops being memory-bound, so its
// least time is those bytes over 3.35 TB/s; at s2-pro's shapes the bytes
// bound it below roughly B = 80. At B = 1024 (prefill) the operations bound
// it: 2 * 1024 * 2560 * 19456 = 102 GFLOP for the slow w13 is 0.103 ms at
// the 989 TFLOP/s of the bf16 tensor cores, which only `wgmma` reaches.
//
// Three routes, chosen by the wrapper (`ops/int4.py:_route`) on B and x's
// dtype (fp16 x takes the first two as "gemv_f16" and "wgmma_f16"); a route
// that does not take the call returns cudaErrorInvalidValue.
// * "gemv", B <= 8: split-K matrix-vector kernel, one launch a product.
//   A block owns 256 output columns and one run of whole groups of packed
//   rows (`ops/int4.py:gemv_split` picks the runs from the shape and the
//   SM count, so that the grid covers the card where the columns alone
//   would give 6-76 blocks). Its 16 row slices of 16 threads each read 16
//   packed bytes (32 W values: rows r and r + I/2 of 16 columns) per load,
//   8 rows in flight per thread, while the block stages x and the group's
//   scales in shared memory. bf16 (fp16) x dequantizes every nibble to the
//   bf16 (fp16) W of the other routes (below, in x2 arithmetic of the 16-bit
//   type; on the tensor cores, `int4_gemv_mma_kernel`, where the groups are
//   multiples of 128 rows and O of 16); fp32 x uses q * s in
//   fp32; the sums are fp32. The slices' sums meet by a shuffle and then
//   through shared memory in a fixed order. With one run the block writes
//   y; otherwise each block writes its fp32 partial to a workspace, fences
//   and bumps its column tile's counter, and the last block of the tile adds
//   the partials in split order (deterministic, no atomics on data),
//   writes y in x's dtype and puts the counter back to 0. The workspace and
//   counters are allocated once per device by the wrapper.
// * "wgmma", bf16 (fp16) x and B > 8 (every prefill): tensor-core product,
//   `int4_wgmma_kernel` below, whose note gives its design.
// * "fp32_tc", fp32 x and B > 8 (the fp32 models: JAX's tiny ones, the
//   in-context evaluation over an int4 checkpoint): `int4_tf32_kernel`
//   below, the products on the tensor cores as two TF32 terms of x times
//   the exact q, each group's sum scaled once (its note gives the design).
//   Its own C entry point, fs_int4_matmul_fp32, takes the tile shape.
//
// The W of each route: fp32 x (the "gemv" and "fp32_tc" routes) uses
// q * s in fp32 (the JAX package's `int4_matmul_reference`). bf16 x (the
// "gemv" and "wgmma" routes) uses rn_bf16(q * rn_bf16(s)), which is
// bitwise the W of the Pallas kernel: it casts the nibble and the scale to
// bf16 and multiplies them in bf16, and a product of a 4-bit and an 8-bit
// significand is exact in fp32, so it rounds once. So a bf16 decode step
// and its prefill run on one W; only the order of the fp32 sums differs
// from the TPU kernel.
//
// fp16 x (the `--half` serving path, routes "gemv_f16" and "wgmma_f16"):
// the matvec kernels and `int4_wgmma_kernel` are templated on the 16-bit
// type T (common.cuh `Elem`) and run on mma.sync / wgmma `.f16` operands
// with fp32 sums, y rounded once to fp16. W = rn_f16(q * rn_f16(s)): a
// nibble n is the fp16 1024 + n when OR-ed into 0x6400, minus 1032 it is q
// exactly, and one fp16 multiply (HMUL2) by the rounded scale rounds the
// exact product once. A checkpoint read under `--half` has fp16 scales
// (`utils/checkpoint.py:load_params`), and there W is bitwise the JAX
// package's `mm` off the TPU, rn_f16(q * s) (`fish_speech_tpu/ops/quant.py:
// _int4_effective_weight`). The Pallas kernel keeps its bf16 W under fp16
// x; ROADMAP §3 records the difference.
//
// The build compiles the launches of each dtype in a source of its own, all
// at once (`ops/_kernels.py`): int4_mm.cu (fp32 x, and the C entry point),
// int4_mm_bf16.cu and int4_mm_f16.cu, each instantiating this header's
// templates for its type (`run`), so that no one compile holds all three.

#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_VEC = 16;                      // packed bytes (columns) a thread loads per row
constexpr int GV_CT = 16;                       // column threads of a row slice
constexpr int GV_COLS = GV_CT * GV_VEC;         // output columns per block
constexpr int GV_SLICES = GV_THREADS / GV_CT;   // row slices per block
constexpr int GV_U = 8;                         // rows in flight per thread
constexpr int GV_CHUNK = GV_SLICES * GV_U;      // packed rows per block step
constexpr int GV_MAXB = 8;                      // rows of x the matvec kernel takes

template <typename P>
__device__ __forceinline__ P as_pair(uint32_t v) {
  return *reinterpret_cast<P*>(&v);
}
template <typename P>
__device__ __forceinline__ uint32_t pair_bits(P v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// W values of the low nibbles (bytes 0 and 2 of w) and of the high ones, as
// T pairs, from the T scale pairs s_lo and s_hi (rn_T(s)): bf16 (128 + n)
// by OR-ing n into 0x4300, minus 136; fp16 (1024 + n) by OR-ing n into
// 0x6400, minus 1032; q exact either way, then one rounding of q * s
template <typename T>
__device__ __forceinline__ void dequant_pair(uint32_t w, uint32_t s_lo, uint32_t s_hi,
                                             uint32_t& lo, uint32_t& hi) {
  if constexpr (fs::Elem<T>::kF16) {
    const __half2 bias = __floats2half2_rn(1032.f, 1032.f);  // 1024 + 8
    const __half2 ql = __hsub2(as_pair<__half2>((w & 0x000F000Fu) | 0x64006400u), bias);
    const __half2 qh =
        __hsub2(as_pair<__half2>(((w >> 4) & 0x000F000Fu) | 0x64006400u), bias);
    lo = pair_bits(__hmul2(ql, as_pair<__half2>(s_lo)));
    hi = pair_bits(__hmul2(qh, as_pair<__half2>(s_hi)));
  } else {
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);  // 128 + 8
    const __nv_bfloat162 ql =
        __hsub2(as_pair<__nv_bfloat162>((w & 0x000F000Fu) | 0x43004300u), bias);
    const __nv_bfloat162 qh =
        __hsub2(as_pair<__nv_bfloat162>(((w >> 4) & 0x000F000Fu) | 0x43004300u), bias);
    lo = pair_bits(__hmul2_rn(ql, as_pair<__nv_bfloat162>(s_lo)));
    hi = pair_bits(__hmul2_rn(qh, as_pair<__nv_bfloat162>(s_hi)));
  }
}

// the bits of a 16-bit value
template <typename T>
__device__ __forceinline__ uint32_t bits16(T v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// One 16-byte load: 16 columns of packed row r, i.e. W[r, c..c+16) in the
// low nibbles and W[r + I/2, c..c+16) in the high ones; col0 < O. The
// ragged edge (O not a multiple of 16, or p off the 16-byte grid) reads
// bytes one by one; columns past O read 0x88, q = 0.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int col0,
                                        int out_dim, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + col0));
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 4 * i + c;
      w[i] |= (uint32_t)(col < out_dim ? row[col] : 0x88) << (8 * c);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The n partial sums at p, p + stride, ..., added in split order; eight
// loads in flight at a time
__device__ __forceinline__ float sum_partials(const float* p, size_t stride, int n) {
  float y = 0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = k0 + u < n ? __ldcg(p + (k0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < n) y += v[u];
  }
  return y;
}

// y[b][c] += x_lo[b] * W[r, c] + x_hi[b] * W[r + I/2, c] over a thread's 16
// columns. 16-bit x (T): W = rn_T(q * rn_T(s)) (sb_lo/sb_hi hold rn_T(s)
// as T pairs, column 2i in the low half); fp32 x: W = q * s in fp32.
template <typename T, int NB>
__device__ __forceinline__ void gemv_row(uint4 w4, const float* s_lo,
                                         const float* s_hi,
                                         const uint32_t* sb_lo,
                                         const uint32_t* sb_hi,
                                         const float* x_lo, const float* x_hi,
                                         float (&acc)[NB][GV_VEC]) {
  const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo[4], hi[4];
    if constexpr (!std::is_same<T, float>::value) {
      using E = fs::Elem<T>;
      uint32_t lo01, hi01, lo23, hi23;  // T pairs, column c in the low half
      dequant_pair<T>(__byte_perm(words[i], 0, 0x4140), sb_lo[2 * i], sb_hi[2 * i],
                      lo01, hi01);
      dequant_pair<T>(__byte_perm(words[i], 0, 0x4342), sb_lo[2 * i + 1],
                      sb_hi[2 * i + 1], lo23, hi23);
      lo[0] = E::lo(lo01); lo[1] = E::hi(lo01); lo[2] = E::lo(lo23); lo[3] = E::hi(lo23);
      hi[0] = E::lo(hi01); hi[1] = E::hi(hi01); hi[2] = E::lo(hi23); hi[3] = E::hi(hi23);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t byte = (words[i] >> (8 * c)) & 0xFF;
        lo[c] = (float)((int)(byte & 0xF) - 8) * s_lo[4 * i + c];
        hi[c] = (float)((int)(byte >> 4) - 8) * s_hi[4 * i + c];
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[b][4 * i + c] = fmaf(x_hi[b], hi[c], fmaf(x_lo[b], lo[c], acc[b][4 * i + c]));
  }
}

// The 16 scales of a thread's columns in group `grp`: fp32 (fp32 x) and
// rn_T pairs (16-bit x of type T).
template <typename T>
__device__ __forceinline__ void gemv_scales(const float* gs, int grp, int col0,
                                            int out_dim, float* s,
                                            uint32_t* sb) {
#pragma unroll
  for (int c = 0; c < GV_VEC; ++c) {
    const int col = col0 + c;
    s[c] = col < out_dim ? gs[(size_t)grp * out_dim + col] : 0.f;
  }
  if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < GV_VEC / 2; ++i) sb[i] = fs::Elem<T>::pack(s[2 * i], s[2 * i + 1]);
  }
}

// grid (ceil(O / GV_COLS), n_split); split k owns packed rows
// [k * rows, (k + 1) * rows), rows = groups_per_split * g. Dynamic shared
// memory: x [NB][2][GV_CHUNK], scales [2][GV_COLS], partials
// [GV_THREADS / 32][NB][GV_COLS], all fp32.
template <typename T, int NB>
__global__ void __launch_bounds__(GV_THREADS, NB <= 4 ? 2 : 1)
    int4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ gs, T* __restrict__ out,
                     float* __restrict__ work, int* __restrict__ counters,
                     int in_dim, int out_dim, int group, int rows, bool pvec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [NB][2][GV_CHUNK]
  float* ss = xs + NB * 2 * GV_CHUNK;        // [2][GV_COLS]
  float* red = ss + 2 * GV_COLS;             // [warps][NB][GV_COLS]
  __shared__ int last_s;
  const int half = in_dim / 2;
  const int ks = blockIdx.y, n_split = gridDim.y;
  const int r0 = ks * rows, r1 = r0 + rows;
  const int ct = threadIdx.x % GV_CT, slice = threadIdx.x / GV_CT;
  const int tile0 = blockIdx.x * GV_COLS;
  const int col0 = tile0 + ct * GV_VEC;
  // every chunk lies in one group: its scales are staged once
  const bool one_group = group % GV_CHUNK == 0;

  float acc[NB][GV_VEC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < GV_VEC; ++c) acc[b][c] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += GV_CHUNK) {
    const int n = min(GV_CHUNK, r1 - c0);
    uint4 w[GV_U];  // the loads go out before the staging below
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int j = slice + u * GV_SLICES;
      // threads of the last tile whose columns start past O load nothing
      w[u] = j < n && col0 < out_dim
                 ? load16(p + (size_t)(c0 + j) * out_dim, col0, out_dim, pvec)
                 : make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
    }
    __syncthreads();  // the previous chunk is done with xs and ss
    for (int idx = threadIdx.x; idx < NB * 2 * GV_CHUNK; idx += GV_THREADS) {
      const int b = idx / (2 * GV_CHUNK), h = (idx / GV_CHUNK) & 1;
      const int j = idx % GV_CHUNK;
      xs[idx] = j < n ? fs::to_float(x[(size_t)b * in_dim + h * half + c0 + j]) : 0.f;
    }
    if (one_group) {
      const int grp = c0 / group;
      for (int idx = threadIdx.x; idx < 2 * GV_COLS; idx += GV_THREADS) {
        const int h = idx / GV_COLS, col = tile0 + idx % GV_COLS;
        ss[idx] = col < out_dim
                      ? gs[(size_t)(grp + h * (half / group)) * out_dim + col]
                      : 0.f;
      }
    }
    __syncthreads();
    float s_lo[GV_VEC], s_hi[GV_VEC];
    uint32_t sb_lo[GV_VEC / 2], sb_hi[GV_VEC / 2];
    if (one_group) {
#pragma unroll
      for (int c = 0; c < GV_VEC; ++c) {
        s_lo[c] = ss[ct * GV_VEC + c];
        s_hi[c] = ss[GV_COLS + ct * GV_VEC + c];
      }
      if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
        for (int i = 0; i < GV_VEC / 2; ++i) {
          sb_lo[i] = fs::Elem<T>::pack(s_lo[2 * i], s_lo[2 * i + 1]);
          sb_hi[i] = fs::Elem<T>::pack(s_hi[2 * i], s_hi[2 * i + 1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int j = slice + u * GV_SLICES;
      if (j >= n) break;
      if (!one_group) {  // small or odd groups: the row's own scales
        const int grp = (c0 + j) / group;
        gemv_scales<T>(gs, grp, col0, out_dim, s_lo, sb_lo);
        gemv_scales<T>(gs, grp + half / group, col0, out_dim, s_hi, sb_hi);
      }
      float x_lo[NB], x_hi[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        x_lo[b] = xs[(b * 2) * GV_CHUNK + j];
        x_hi[b] = xs[(b * 2 + 1) * GV_CHUNK + j];
      }
      gemv_row<T, NB>(w[u], s_lo, s_hi, sb_lo, sb_hi, x_lo, x_hi, acc);
    }
  }

  // the 16 row slices' sums: two per warp by a shuffle, then the warps' in
  // order through shared memory (fixed order, deterministic)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < GV_VEC; ++c)
      acc[b][c] += __shfl_xor_sync(fs::kFullMask, acc[b][c], 16);
  if (lane < 16)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < GV_VEC; c += 4)
        *reinterpret_cast<float4*>(red + (warp * NB + b) * GV_COLS + lane * GV_VEC + c) =
            make_float4(acc[b][c], acc[b][c + 1], acc[b][c + 2], acc[b][c + 3]);
  __syncthreads();
  constexpr int kWarps = GV_THREADS / 32;
  float* part = work + (size_t)ks * NB * out_dim;
  for (int idx = threadIdx.x; idx < NB * GV_COLS; idx += GV_THREADS) {
    const int b = idx / GV_COLS, col = tile0 + idx % GV_COLS;
    if (col >= out_dim) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += red[(w * NB + b) * GV_COLS + idx % GV_COLS];
    if (n_split == 1)
      fs::store(out + (size_t)b * out_dim + col, y);
    else
      part[(size_t)b * out_dim + col] = y;
  }
  if (n_split == 1) return;
  // the last split of this column tile to finish adds the partials, in
  // split order, and puts the tile's counter back to 0
  __syncthreads();  // the block's partial is stored: publish it
  if (threadIdx.x == 0)
    last_s = fs::atomic_add_acq_rel(counters + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  for (int idx = threadIdx.x; idx < NB * GV_COLS; idx += GV_THREADS) {
    const int b = idx / GV_COLS, col = tile0 + idx % GV_COLS;
    if (col >= out_dim) continue;
    fs::store(out + (size_t)b * out_dim + col,
              sum_partials(work + (size_t)b * out_dim + col,
                           (size_t)NB * out_dim, n_split));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// The "fp32_tc" route: y (B, O) fp32 = x (B, I) fp32 @ W, W = q * s, on the
// tensor cores (`int4_tf32_kernel`). It replaced a tiled kernel on the CUDA
// cores (`int4_gemm_kernel`: 128 x 128 tiles, two fp32 scales read from
// device memory for every W byte, two barriers a step and nothing
// overlapped; 26x cuBLAS's time at the slow w13, B = 1024, on an H100).
//
// What bounds it: 2 B I O operations, ops-bound from B ~ 80 at s2-pro's
// widths (fp32's 67 TFLOP/s on the CUDA cores; the tensor cores' TF32 rate
// is 495). The design:
// * The scale comes out of each group's sum: y = sum over groups G of
//   s[G, o] * (sum over the group's rows i of x[b, i] q[i, o]). q is an
//   integer in [-8, 7], exact in TF32, and x = big + small (tf32.cuh), so
//   the group's sum is two mma.sync m16n8k8 .tf32 per tile, fp32 sums in
//   the accumulators `acc`, and its epilogue adds s * acc into y in fp32:
//   the only rounding that differs from the JAX package's
//   `int4_matmul_reference` (x @ (q * s) in fp32) is the factored scale
//   and 2^-20 |x| of x's split.
// * Passes: packed row r holds logical rows r (low nibble) and r + I/2
//   (high nibble), which lie in two groups, so the K loop walks passes
//   (group G of the low half, then the same packed rows' high nibbles as
//   group G + I/2g): one `acc` set beside y, and the second pass reads its
//   bytes from L2. Every group size the quantizer writes works: a pass is
//   g packed rows cut into stages of KP, the last one zero-filled.
// * A ring of NBUF stages in shared memory, filled by cp.async a stage
//   ahead of the math, one barrier a stage: each stage holds the pass's x
//   columns (BM rows x KP, rows padded to 48 floats), its packed bytes (KP
//   rows x BN, 32 bytes more every fourth row) and, on the pass's last
//   stage, its scale row (BN floats): scales are read once per (group,
//   column) per block.
// * Warp tiles of MT m16 tiles x 32 columns. Inside a k16 step lane (g, t)
//   takes K 4t..4t+3 (one 16-byte load of x per row, two mma k8 steps of
//   K pairs), and n8 tile j's column n is column 4n + j of the warp's 32:
//   one 32-bit load of a packed row gives a lane its B values of all four
//   tiles, and its accumulators hold columns 8t..8t+7 of each row
//   (16-byte stores and scale loads). The paddings keep those loads free
//   of bank conflicts.
// * Tile shapes (`Tile`, picked by the wrapper's `ops/int4.py:fp32_tc_plan`
//   from the shape and the SM count): 64 x 64, 32 x 64 and 16 x 64 on
//   mma.sync, and 64 x 128 on wgmma (`int4_tf32_wgmma_kernel` below: the
//   fastest where x has 64 rows or more, measured 1.5x the rate of a
//   128 x 128 mma.sync tile, which the plan therefore never picked and
//   which is not built); where a shape's tiles still leave SMs idle
//   (s2-pro's wo and w2, O = 2560, at few rows) the groups are split into
//   runs (whole groups, any count) over the grid's z, each run's y partial
//   written to a workspace and the last run of a tile to finish (a
//   release/acquire counter) adding them in run order. One launch, a fixed
//   order of sums, replays in equal bits.
// ---------------------------------------------------------------------------
namespace tf {

constexpr int KP = 32;    // packed rows of a stage: two k16 steps
constexpr int NBUF = 4;   // stages of the ring
constexpr int XS = KP + 16;  // padded x row (floats): 16-byte loads conflict-free
constexpr int N_TILES = 4;   // tile shapes, `ops/int4.py:FP32_TC_TILES`

template <int MT_, int WM_, int WN_>
struct Tile {
  static constexpr int MT = MT_, WM = WM_, WN = WN_;  // m16 tiles a warp, warps
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;  // rows of x a block
  static constexpr int BN = 32 * WN;       // output columns a block
  static constexpr int X_TILE = BM * XS * 4;
  static constexpr int P_TILE = KP * BN + (KP / 4) * 32;
  static constexpr int STAGE = X_TILE + P_TILE + BN * 4;
  static constexpr int SMEM = NBUF * STAGE;
};

// byte offset of packed row r in a stage: 32 bytes more every fourth row,
// so that lanes t = 0..3 reading rows 4t + e land on distinct banks
template <int BN>
__device__ __forceinline__ int prow(int r) {
  return r * BN + (r >> 2) * 32;
}

struct Args {
  const float* x;
  const uint8_t* p;
  const float* gs;
  float* out;
  float* work;   // n_split > 1: n_split partials of (B, O)
  int* counters; // one per output tile, 0 on entry and exit
  int batch, in_dim, out_dim, group;
  int stages_per_pass, n_groups;  // groups of a half; run z: groups [z G / n, (z + 1) G / n)
  bool xvec, pvec, svec;  // 16-byte copies possible (else 4-byte or bytes)
};

// Stage `st` into buffer `sm`: pass st / SP (group j, half h), its stage
// st % SP of KP packed rows; rows past the pass are zero.
template <class L>
__device__ __forceinline__ void load_stage(uint8_t* sm, int st, int m0, int n0,
                                           const Args& a) {
  using namespace fs::wg;
  const int pass = st / a.stages_per_pass, sub = st % a.stages_per_pass;
  const int j = pass >> 1, h = pass & 1, half = a.in_dim / 2;
  const int r0 = j * a.group + sub * KP;
  const int n_rows = min(KP, a.group - sub * KP);
  const int t = threadIdx.x;
  float* xs = reinterpret_cast<float*>(sm);
  // x: BM rows x KP columns h * I/2 + r0 + kk
  if (a.xvec) {
    for (int idx = t; idx < L::BM * (KP / 4); idx += L::THREADS) {
      const int m = idx / (KP / 4), c = idx % (KP / 4);
      const bool ok = m0 + m < a.batch && 4 * c < n_rows;
      const float* src = a.x + (size_t)(m0 + m) * a.in_dim + h * half + r0 + 4 * c;
      cp_async16(xs + m * XS + 4 * c, ok ? src : a.x, ok);
    }
  } else {
    for (int idx = t; idx < L::BM * KP; idx += L::THREADS) {
      const int m = idx / KP, c = idx % KP;
      const bool ok = m0 + m < a.batch && c < n_rows;
      const float* src = a.x + (size_t)(m0 + m) * a.in_dim + h * half + r0 + c;
      cp_async4(xs + m * XS + c, ok ? src : a.x, ok);
    }
  }
  // packed bytes: KP rows x BN columns
  uint8_t* ps = sm + L::X_TILE;
  if (a.pvec) {
    for (int idx = t; idx < KP * (L::BN / 16); idx += L::THREADS) {
      const int r = idx / (L::BN / 16), c = idx % (L::BN / 16);
      const bool ok = r < n_rows && n0 + 16 * c < a.out_dim;
      const uint8_t* src = a.p + (size_t)(r0 + r) * a.out_dim + n0 + 16 * c;
      cp_async16(ps + prow<L::BN>(r) + 16 * c, ok ? src : a.p, ok);
    }
  } else {
    for (int idx = t; idx < KP * L::BN; idx += L::THREADS) {
      const int r = idx / L::BN, c = idx % L::BN;
      ps[prow<L::BN>(r) + c] =
          r < n_rows && n0 + c < a.out_dim ? a.p[(size_t)(r0 + r) * a.out_dim + n0 + c] : 0;
    }
  }
  // the pass's scale row, on its last stage
  if (sub != a.stages_per_pass - 1) return;
  float* ss = reinterpret_cast<float*>(sm + L::X_TILE + L::P_TILE);
  const float* srow = a.gs + (size_t)(h * (half / a.group) + j) * a.out_dim + n0;
  if (a.svec) {
    for (int c = t; c < L::BN / 4; c += L::THREADS) {
      const bool ok = n0 + 4 * c < a.out_dim;
      cp_async16(ss + 4 * c, ok ? srow + 4 * c : a.gs, ok);
    }
  } else {
    for (int c = t; c < L::BN; c += L::THREADS) {
      const bool ok = n0 + c < a.out_dim;
      cp_async4(ss + c, ok ? srow + c : a.gs, ok);
    }
  }
}

// The stages of this block's run of groups (the grid's z cuts the groups
// into runs of whole groups, their sizes differing by at most one): each
// group is two passes of stages_per_pass stages.
__device__ __forceinline__ void run_stages(const Args& a, int* st0, int* n_st) {
  const int g0 = blockIdx.z * a.n_groups / gridDim.z;
  const int g1 = (blockIdx.z + 1) * a.n_groups / gridDim.z;
  *st0 = 2 * g0 * a.stages_per_pass;
  *n_st = 2 * (g1 - g0) * a.stages_per_pass;
}

// After a split run's partial of output tile (m0, n0) is stored: the last
// run of the tile to finish adds the runs' partials in run order and puts
// the tile's counter back to 0 (a block of `threads`, all calling).
__device__ __forceinline__ void merge_runs(const Args& a, int m0, int n0, int bm, int bn,
                                           int threads, int* last_s) {
  const int n_split = gridDim.z;
  __syncthreads();  // the block's partial is stored: publish it
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    *last_s = fs::atomic_add_acq_rel(a.counters + tile_id, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  for (int idx = threadIdx.x; idx < bm * bn; idx += threads) {
    const int m = m0 + idx / bn, c = n0 + idx % bn;
    if (m >= a.batch || c >= a.out_dim) continue;
    const size_t at = (size_t)m * a.out_dim + c;
    a.out[at] = sum_partials(a.work + at, (size_t)a.batch * a.out_dim, n_split);
  }
  if (threadIdx.x == 0) a.counters[tile_id] = 0;
}

template <class L>
__global__ void __launch_bounds__(L::THREADS)
    int4_tf32_kernel(const __grid_constant__ Args a) {
  using namespace fs::wg;
  constexpr int MT = L::MT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int row0 = wm * 16 * MT + g;  // the lane's first row of x in the block
  const int col0 = wn * 32;           // its warp's first column in the block
  const int sp = a.stages_per_pass;
  int st0, n_st;
  run_stages(a, &st0, &n_st);
  __shared__ int last_s;

  float y[MT][4][4], acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[mi][jn][e] = acc[mi][jn][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NBUF - 1; ++s) {
    if (s < n_st) load_stage<L>(smem + s * L::STAGE, st0 + s, m0, n0, a);
    cp_async_commit();
  }
  for (int ls = 0; ls < n_st; ++ls) {
    const int st = st0 + ls;    // the stage of the whole walk
    fs::tf32::cp_async_wait<NBUF - 2>();  // stage st has landed
    __syncthreads();            // ... for every thread; stage st - 1 is read
    const int nxt = ls + NBUF - 1;
    if (nxt < n_st) load_stage<L>(smem + (nxt % NBUF) * L::STAGE, st0 + nxt, m0, n0, a);
    cp_async_commit();

    const uint8_t* sm = smem + (ls % NBUF) * L::STAGE;
    const float* xs = reinterpret_cast<const float*>(sm);
    const uint8_t* ps = sm + L::X_TILE;
    const bool high = (st / sp) & 1;  // the pass's nibble
#pragma unroll
    for (int kc = 0; kc < KP / 16; ++kc) {
      // B: packed rows kc*16 + 4t + e, the warp's columns 4g..4g+3; q of
      // tile j (column 4n + j) in byte j
      uint32_t bq[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t w = *reinterpret_cast<const uint32_t*>(
            ps + prow<L::BN>(kc * 16 + 4 * t + e) + col0 + 4 * g);
        w = (high ? w >> 4 : w) & 0x0F0F0F0Fu;
        bq[e][0] = fs::tf32::nibble_q<0>(w);
        bq[e][1] = fs::tf32::nibble_q<1>(w);
        bq[e][2] = fs::tf32::nibble_q<2>(w);
        bq[e][3] = fs::tf32::nibble_q<3>(w);
      }
      // x of every m tile first (k index t of step s is K 4t + 2s, t + 4 is
      // 4t + 2s + 1), then each step's and term's mmas over all MT x 4
      // tiles: an accumulator's next mma comes 4 MT mmas after its last
      float4 xr[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xr[mi][h] = *reinterpret_cast<const float4*>(
              xs + (row0 + 16 * mi + 8 * h) * XS + kc * 16 + 4 * t);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t big[MT][4], small[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float v[4] = {s ? xr[mi][0].z : xr[mi][0].x, s ? xr[mi][1].z : xr[mi][1].x,
                              s ? xr[mi][0].w : xr[mi][0].y, s ? xr[mi][1].w : xr[mi][1].y};
#pragma unroll
          for (int e = 0; e < 4; ++e) fs::tf32::split(v[e], big[mi][e], small[mi][e]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            fs::tf32::mma(acc[mi][jn], big[mi][0], big[mi][1], big[mi][2], big[mi][3],
                          bq[2 * s][jn], bq[2 * s + 1][jn]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            fs::tf32::mma(acc[mi][jn], small[mi][0], small[mi][1], small[mi][2],
                          small[mi][3], bq[2 * s][jn], bq[2 * s + 1][jn]);
      }
    }
    if (st % sp == sp - 1) {  // the pass's end: y += s * acc
      const float* ss = reinterpret_cast<const float*>(sm + L::X_TILE + L::P_TILE);
      const float4 s0 = *reinterpret_cast<const float4*>(ss + col0 + 8 * t);
      const float4 s1 = *reinterpret_cast<const float4*>(ss + col0 + 8 * t + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // accumulator e: column 8t + jn (e even) or 8t + 4 + jn (e odd)
            y[mi][jn][e] = fmaf(sc[jn + 4 * (e & 1)], acc[mi][jn][e], y[mi][jn][e]);
            acc[mi][jn][e] = 0.f;
          }
    }
  }
  fs::tf32::cp_async_wait<0>();

  // lane (g, t): rows row0 + 16 mi (+ 8), columns 8t .. 8t + 7 of its warp's
  // 32; with a split, into this run's partial
  const int n_split = gridDim.z;
  const int col = n0 + col0 + 8 * t;
  const bool vec = a.out_dim % 4 == 0 && col + 8 <= a.out_dim;
  float* yout = n_split == 1 ? a.out : a.work + (size_t)blockIdx.z * a.batch * a.out_dim;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + row0 + 16 * mi + 8 * hr;
      if (m >= a.batch) continue;
      float o[8];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        o[jn] = y[mi][jn][2 * hr];
        o[4 + jn] = y[mi][jn][2 * hr + 1];
      }
      float* dst = yout + (size_t)m * a.out_dim + col;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (col + c < a.out_dim) dst[c] = o[c];
      }
    }
  if (n_split == 1) return;
  merge_runs(a, m0, n0, L::BM, L::BN, L::THREADS, &last_s);
}

template <class L>
int launch(const Args& a, int n_split, cudaStream_t stream) {
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_tf32_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid((a.out_dim + L::BN - 1) / L::BN, (a.batch + L::BM - 1) / L::BM, n_split);
  int4_tf32_kernel<L><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the mma.sync tile shapes, as `ops/int4.py:FP32_TC_TILES` lists them (the
// fourth, 64 x 128, is `WTile` below)
using Tile0 = Tile<2, 2, 2>;  // 64 x 64, 128 threads
using Tile1 = Tile<1, 2, 2>;  // 32 x 64, 128 threads
using Tile2 = Tile<1, 1, 2>;  // 16 x 64, 64 threads

template <class L>
int occupancy(int* blocks) {
  const cudaError_t e = cudaFuncSetAttribute(
      int4_tf32_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, int4_tf32_kernel<L>,
                                                            L::THREADS, L::SMEM);
}


// ---------------------------------------------------------------------------
// Tile shape 3, the wgmma form of the same kernel (`int4_tf32_wgmma_kernel`):
// 64 rows of x x 128 output columns a block, two warpgroups of 64 columns.
// The product runs as y^T = W^T x^T: wgmma's M is O, its N the rows of x.
// q is the A operand, from registers (exact in TF32, four values a k8 step
// from two 16-bit loads of packed bytes: fragment rows g and g + 8 of a
// warp are its columns 2g and 2g + 1); x is the B operand, K-major in
// shared memory in the 128-byte swizzle, as two tiles (big and small,
// split in place by the thread that copied each 16-byte chunk). A stage is
// KP packed rows of one pass: 4 k8 steps x 2 terms = 8 wgmma.m64n64k8
// .tf32 a warpgroup, the pass's first starting its accumulators at 0, its
// last followed by y += s * acc; each stage's wgmmas are retired before the
// next (ptxas serializes wgmmas whose register operands are written while
// others are in flight), and two blocks an SM keep the tensor cores busy
// while one splits x and loads its fragments. The ring, passes and split
// of the groups are the mma.sync form's.

// d (64 x 64, fp32) = (scale_d ? d : 0) + a (64 x 8, tf32, registers) * b
// (8 x 64, tf32, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

struct WTile {
  static constexpr int BM = 64, BN = 128, THREADS = 256;
  static constexpr int NST = 3;                  // stages of the ring
  static constexpr int PSW = BN + 16;            // padded packed row (bytes)
  static constexpr int X_TILE = BM * 128;        // 64 rows x 32 floats, swizzled
  static constexpr int P_OFF = 2 * X_TILE;       // after the big and small tiles
  static constexpr int S_OFF = P_OFF + KP * PSW;
  static constexpr int STAGE = S_OFF + BN * 4;  // 21 KB: 1024-byte aligned
  static constexpr int SMEM = 1024 + NST * STAGE;    // + alignment slack
  static_assert(STAGE % 1024 == 0, "the swizzled tiles want 1024-byte stages");
};

// Stage `st` into `sm`: x chunk (r, c) of the stage (16 bytes: K 4c..4c+3 of
// row r) at its 128-byte-swizzled place, two chunks a thread (the thread
// that splits them), the packed bytes one chunk a thread, the scale row.
__device__ __forceinline__ void load_stage_w(uint8_t* sm, int st, int m0, int n0,
                                             const Args& a) {
  using namespace fs::wg;
  using L = WTile;
  const int pass = st / a.stages_per_pass, sub = st % a.stages_per_pass;
  const int j = pass >> 1, h = pass & 1, half = a.in_dim / 2;
  const int r0 = j * a.group + sub * KP;
  const int n_rows = min(KP, a.group - sub * KP);
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = t + L::THREADS * u, r = idx / 8, c = idx % 8;
    const float* src = a.x + (size_t)(m0 + r) * a.in_dim + h * half + r0 + 4 * c;
    uint8_t* dst = sm + sw128(r, c);
    if (a.xvec) {
      const bool ok = m0 + r < a.batch && 4 * c < n_rows;
      cp_async16(dst, ok ? src : a.x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = m0 + r < a.batch && 4 * c + e < n_rows;
        cp_async4(dst + 4 * e, ok ? src + e : a.x, ok);
      }
    }
  }
  {
    const int r = t / 8, c = t % 8;
    uint8_t* dst = sm + L::P_OFF + r * L::PSW + 16 * c;
    const uint8_t* src = a.p + (size_t)(r0 + r) * a.out_dim + n0 + 16 * c;
    if (a.pvec) {
      const bool ok = r < n_rows && n0 + 16 * c < a.out_dim;
      cp_async16(dst, ok ? src : a.p, ok);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = r < n_rows && n0 + 16 * c + e < a.out_dim ? src[e] : 0;
    }
  }
  if (sub != a.stages_per_pass - 1) return;
  float* ss = reinterpret_cast<float*>(sm + L::S_OFF);
  const float* srow = a.gs + (size_t)(h * (half / a.group) + j) * a.out_dim + n0;
  if (a.svec) {
    if (t < L::BN / 4) {
      const bool ok = n0 + 4 * t < a.out_dim;
      cp_async16(ss + 4 * t, ok ? srow + 4 * t : a.gs, ok);
    }
  } else if (t < L::BN) {
    const bool ok = n0 + t < a.out_dim;
    cp_async4(ss + t, ok ? srow + t : a.gs, ok);
  }
}

__global__ void __launch_bounds__(WTile::THREADS, 2)
    int4_tf32_wgmma_kernel(const __grid_constant__ Args a) {
  using namespace fs::wg;
  using L = WTile;
  extern __shared__ uint8_t smem_w[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_w) + 1023) & ~uintptr_t(1023));
  __shared__ int last_s;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int t = threadIdx.x, wg = t / 128, w = (t % 128) / 32;
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const int col = 64 * wg + 16 * w + 2 * g;  // the lane's two columns in the block
  const int sp = a.stages_per_pass;
  int st0, n_st;
  run_stages(a, &st0, &n_st);

  float acc[32], y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = y[i] = 0.f;

#pragma unroll
  for (int s = 0; s < L::NST - 1; ++s) {
    if (s < n_st) load_stage_w(smem + s * L::STAGE, st0 + s, m0, n0, a);
    cp_async_commit();
  }
  for (int ls = 0; ls < n_st; ++ls) {
    const int st = st0 + ls;
    fs::tf32::cp_async_wait<L::NST - 2>();  // stage st has landed
    __syncthreads();  // ... for every thread; stage st - 1's wgmmas are retired
    const int nxt = ls + L::NST - 1;
    if (nxt < n_st) load_stage_w(smem + (nxt % L::NST) * L::STAGE, st0 + nxt, m0, n0, a);
    cp_async_commit();
    uint8_t* sm = smem + (ls % L::NST) * L::STAGE;
    // this thread's two x chunks: big in place, small in the second tile
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = t + L::THREADS * u, off = sw128(idx / 8, idx % 8);
      const float4 v = *reinterpret_cast<const float4*>(sm + off);
      uint32_t b[4], s[4];
      fs::tf32::split(v.x, b[0], s[0]);
      fs::tf32::split(v.y, b[1], s[1]);
      fs::tf32::split(v.z, b[2], s[2]);
      fs::tf32::split(v.w, b[3], s[3]);
      *reinterpret_cast<uint4*>(sm + off) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(sm + L::X_TILE + off) = make_uint4(s[0], s[1], s[2], s[3]);
    }
    // A fragments of the 4 k8 steps: (row g, k t) is column 2g at packed
    // row 8f + t, (g + 8, t) column 2g + 1, (g, t + 4) and (g + 8, t + 4)
    // the same at packed row 8f + t + 4
    const bool high = (st / sp) & 1;
    uint32_t af[4][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t wd =
            *reinterpret_cast<const uint16_t*>(sm + L::P_OFF + (8 * f + tq + 4 * e) * L::PSW + col);
        wd = (high ? wd >> 4 : wd) & 0x0F0Fu;
        af[f][2 * e] = fs::tf32::nibble_q<0>(wd);
        af[f][2 * e + 1] = fs::tf32::nibble_q<1>(wd);
      }
    fs::tma::fence_proxy_async();  // the split tiles' writes before wgmma reads them
    __syncthreads();
    const uint32_t xb = smem_u32(sm);
    uint64_t db[4], ds[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      db[f] = sw128_desc(xb + 32 * f);
      ds[f] = sw128_desc(xb + L::X_TILE + 32 * f);
      asm volatile("" : "+l"(db[f]), "+l"(ds[f]));
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(af[f][r]));
    }
    const int keep = st % sp != 0;  // the pass's first stage starts acc at 0
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      wgmma_m64n64k8_tf32(acc, af[f], db[f], keep | (f > 0));
      wgmma_m64n64k8_tf32(acc, af[f], ds[f], 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (st % sp == sp - 1) {  // the pass's end: y += s * acc
      const float* ss = reinterpret_cast<const float*>(sm + L::S_OFF);
      const float s0 = ss[col], s1 = ss[col + 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = fmaf((i / 2) % 2 ? s1 : s0, acc[i], y[i]);
    }
  }
  fs::tf32::cp_async_wait<0>();

  // accumulator i: output column col + (i / 2) % 2, row 8 (i / 4) + 2 tq + i % 2
  const int n_split = gridDim.z;
  float* yout = n_split == 1 ? a.out : a.work + (size_t)blockIdx.z * a.batch * a.out_dim;
  const int c = n0 + col;
  const bool pair = a.out_dim % 2 == 0 && c + 2 <= a.out_dim;
#pragma unroll
  for (int i = 0; i < 32; i += 4)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * (i / 4) + 2 * tq + e;
      if (m >= a.batch) continue;
      float* dst = yout + (size_t)m * a.out_dim + c;
      if (pair) {
        *reinterpret_cast<float2*>(dst) = make_float2(y[i + e], y[i + 2 + e]);
      } else {
        if (c < a.out_dim) dst[0] = y[i + e];
        if (c + 1 < a.out_dim) dst[1] = y[i + 2 + e];
      }
    }
  if (n_split == 1) return;
  merge_runs(a, m0, n0, L::BM, L::BN, L::THREADS, &last_s);
}

int launch_wgmma(const Args& a, int n_split, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WTile::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid((a.out_dim + WTile::BN - 1) / WTile::BN, (a.batch + WTile::BM - 1) / WTile::BM,
            n_split);
  int4_tf32_wgmma_kernel<<<grid, WTile::THREADS, WTile::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

int occupancy_wgmma(int* blocks) {
  const cudaError_t e = cudaFuncSetAttribute(
      int4_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WTile::SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, int4_tf32_wgmma_kernel,
                                                            WTile::THREADS, WTile::SMEM);
}

}  // namespace tf

// ---------------------------------------------------------------------------
// The "wgmma" route: y (B, O) bf16 = x (B, I) bf16 @ W, W = rn_bf16(q *
// rn_bf16(s)), summed in fp32 on the tensor cores; "wgmma_f16" the same on
// fp16 x and y with W = rn_f16(q * rn_f16(s)) (T = __half, `.f16` wgmma).
//
// * It computes y^T = W^T x^T: the tensor cores' M is O and their N is B.
//   W^T is wgmma's A operand, which may come from registers: each thread
//   dequantizes its own A fragments straight from the packed bytes, so the
//   bf16 W is never written to or read from shared memory. x is the B
//   operand, read by wgmma from shared memory in its natural layout (rows
//   of B, K contiguous: "K-major", no transpose flag).
// * Two products share one byte stream: packed row r holds logical rows r
//   and r + I/2, so y = x[:, :I/2] @ W_lo + x[:, I/2:] @ W_hi, both into the
//   same accumulators; each packed byte is read once and gives one A value
//   of each product.
// * Tile: 128 output columns x 128 rows of x per block of 256 threads, two
//   warpgroups of 64 columns, each running
//   wgmma.mma_async.m64n128k16.f32.bf16.bf16 (A from registers) into 64
//   fp32 accumulators per thread. A stage is 64 packed rows: 64 logical K
//   of the low half and 64 of the high half, 8 k16 steps per warpgroup.
//   Grid ceil(O/128) x ceil(B/128).
// * A fragments: thread (warp w, lane 4g + t) holds fragment rows 16w + g
//   and 16w + g + 8 at K 2t, 2t+1, 2t+8, 2t+9 of each k16 step. Fragment
//   row 16w + g + 8e is mapped to output column 16w + 2g + e of the
//   warpgroup, so one 16-bit load gives a thread both of its columns for
//   one packed row: 4 loads per k16 step feed 8 A values of each half.
//   A nibble v becomes bf16 (128 + v) by OR-ing it into 0x4300, then
//   q = (128 + v) - 136 exactly and W = q * s in bf16x2 arithmetic (round
//   to nearest, as the Pallas kernel's bf16 product); in fp16 (1024 + v)
//   from 0x6400, minus 1032, and W = q * rn_f16(s) in fp16x2.
// * Shared memory: x tiles in the 128-byte swizzle (row m's 16-byte chunk
//   c at chunk c ^ (m % 8), tiles 1024-byte aligned) for the wgmma
//   descriptor; packed bytes in rows padded to 144 bytes, so the 16-bit
//   loads of a warp hit distinct banks; the stage's <= ceil(64/g) + 1 fp32
//   scale rows per half, rounded to bf16 where used (a group under 11 rows,
//   which would need more than S_MAX rows, reads them from global memory).
//   All arrive by 16-byte cp.async, zero-filled beyond B, I/2 and O.
// * Overlap: two blocks per SM (99 KB of shared memory and 128 registers a
//   thread each), so one block's dequantization runs on the CUDA cores
//   while the other's wgmmas run on the tensor cores. Within a block, each
//   stage is dequantized, its 8 wgmmas issued and then retired: ptxas
//   serializes wgmmas (C7513) when the registers of a later wgmma are
//   written while an earlier one is in flight, so a second register set
//   would not overlap. The copies of stage s + 2 are issued as stage s
//   retires and land while stage s + 1 runs; one barrier per stage.
//
// Measured on the H100 (chip_smoke.py phase 2, PERF.md): the slow w13 at
// B = 1024 in about 0.33 ms, ~310 TFLOP/s, 3.2x its bound and 2.2x cuBLAS
// on a bf16 weight. The designs this replaced, kept in PERF.md: a bf16 W
// tile written to shared memory and read by wgmma as operand B took
// 0.49-0.74 ms (shared-memory traffic and serial phases).
//
// Left for later: TMA loads with mbarriers, a producer warp beside
// ping-pong consumer warpgroups, a persistent grid, split-K or a narrower
// tile where the grid has fewer blocks than two per SM (O = 2560 gives
// 20 x ceil(B/128)), and more output columns per block (x is re-read
// once per 128 columns).
namespace tc {

constexpr int BN = 128;      // rows of x per block (the tensor cores' N)
constexpr int BO = 128;      // output columns per block (2 warpgroups x 64)
constexpr int KP = 64;       // packed rows per stage
constexpr int THREADS = 256;
constexpr int NBUF = 2;      // stages of x, packed bytes and scales in flight
constexpr int S_MAX = 8;     // scale rows per half kept in shared memory
constexpr int PS = BO + 16;  // padded row of the packed tile (bytes)
constexpr int X_TILE = BN * KP * 2;   // one half of a stage's x tile: 16 KB
constexpr int P_TILE = KP * PS;       // a stage's packed bytes
constexpr int S_TILE = S_MAX * BO * 4;  // one half's fp32 scale rows: 4 KB
constexpr int X_OFF = 0;                          // [stage][half] x tiles
constexpr int P_OFF = X_OFF + NBUF * 2 * X_TILE;  // [stage] packed bytes
constexpr int S_OFF = P_OFF + NBUF * P_TILE;      // [stage][half] scales
constexpr int R_OFF = S_OFF + NBUF * 2 * S_TILE;  // [stage][KP] scale row of each K
constexpr int SMEM = 1024 + R_OFF + NBUF * KP;    // + alignment slack

// scale rows per half that a stage of KP packed rows can touch
inline int scale_rows(int group) { return std::min(KP, (KP - 1) / group + 2); }

using namespace fs::wg;

template <typename T>
struct Args {
  const T* x;
  const uint8_t* p;
  const float* gs;
  T* out;
  int batch, in_dim, out_dim, group, srows;
  bool xvec, pvec, svec;  // 16-byte copies possible (else element by element)
  bool sglobal;           // scales read from global memory (srows > S_MAX)
};

// Stage `st` into buffer `buf`. Thread t copies 8 chunks of x (rows
// t/8 + 32j of the tile, j = 0..3, in both halves, 16-byte chunk t % 8) and
// 2 of packed bytes (rows t/8 + 32j, j = 0..1, chunk t % 8).
template <typename T>
__device__ void load_stage(uint8_t* sm, int buf, int st, int m0, int n0,
                           const Args<T>& a) {
  const int half = a.in_dim / 2, r0 = st * KP, t = threadIdx.x, c = t % 8;
  uint8_t* xs = sm + X_OFF + buf * 2 * X_TILE + sw128(t / 8, c);
  const bool k_ok = r0 + 8 * c < half;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* dst = xs + h * X_TILE + j * 32 * 128;
      const int row = m0 + t / 8 + 32 * j;
      const T* src = a.x + (size_t)row * a.in_dim + h * half + r0 + 8 * c;
      if (a.xvec) {
        const bool valid = row < a.batch && k_ok;
        cp_async16(dst, valid ? src : a.x, valid);
      } else {
        uint4 v;
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = (row < a.batch && r0 + 8 * c + i < half) ? src[i]
                                                          : fs::Elem<T>::from_float(0.f);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
  uint8_t* ps = sm + P_OFF + buf * P_TILE;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kp = t / 8 + 32 * j, r = r0 + kp, col = n0 + 16 * c;
    uint8_t* dst = ps + kp * PS + 16 * c;
    const uint8_t* src = a.p + (size_t)r * a.out_dim + col;
    if (a.pvec) {
      const bool valid = r < half && col < a.out_dim;
      cp_async16(dst, valid ? src : a.p, valid);
    } else {
      uint4 v;
      uint8_t* e = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        e[i] = (r < half && col + i < a.out_dim) ? src[i] : 0;
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  // the scale row of each of the stage's K, counted from the stage's first
  // (r0 / g), so the dequantization divides by nothing
  const int groups_half = half / a.group, j0 = r0 / a.group;
  if (t < KP) sm[R_OFF + buf * KP + t] = (uint8_t)((r0 + t) / a.group - j0);
  if (a.sglobal) return;
  // rows [j0, j0 + srows) of each half's scales, 4 floats a chunk; zero
  // past the half and past O, so padded rows and columns dequantize to 0
  float* ss = reinterpret_cast<float*>(sm + S_OFF + buf * 2 * S_TILE);
  for (int idx = t; idx < 2 * a.srows * (BO / 4); idx += THREADS) {
    const int h = idx / (a.srows * (BO / 4)), j = (idx / (BO / 4)) % a.srows;
    const int c4 = idx % (BO / 4);
    const int grow = j0 + j, col = n0 + 4 * c4;
    float* dst = ss + h * (S_TILE / 4) + j * BO + 4 * c4;
    const float* src = a.gs + (size_t)(h * groups_half + grow) * a.out_dim + col;
    if (a.svec) {
      const bool valid = grow < groups_half && col < a.out_dim;
      cp_async16(dst, valid ? src : a.gs, valid);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = (grow < groups_half && col + i < a.out_dim) ? src[i] : 0.f;
    }
  }
}

// the fp32 scales of half h at scale row `rel` of the stage (row j0 + rel
// of the half's groups), for tile columns c and c + 1
template <typename T>
__device__ __forceinline__ float2 scales_at(const float* ss, int h, int rel,
                                            int c, int j0, int n0, const Args<T>& a) {
  float2 v;
  if (a.sglobal) {
    const int groups_half = a.in_dim / 2 / a.group, grow = j0 + rel;
    const float* row = a.gs + (size_t)(h * groups_half + grow) * a.out_dim + n0;
    const bool ok = grow < groups_half;
    v.x = ok && n0 + c < a.out_dim ? __ldg(row + c) : 0.f;
    v.y = ok && n0 + c + 1 < a.out_dim ? __ldg(row + c + 1) : 0.f;
  } else {
    v = *reinterpret_cast<const float2*>(ss + h * (S_TILE / 4) + rel * BO + c);
  }
  return v;
}

// A fragments of stage `st` (buffer `buf`) for this thread: frag[kk] for
// the low half's k16 step kk, frag[4 + kk] for the high half's.
template <typename T>
__device__ __forceinline__ void dequant_stage(const uint8_t* sm, int buf, int st,
                                              int n0, const Args<T>& a,
                                              uint32_t (&frag)[8][4]) {
  using E = fs::Elem<T>;
  const uint8_t* ps = sm + P_OFF + buf * P_TILE;
  const float* ss = reinterpret_cast<const float*>(sm + S_OFF + buf * 2 * S_TILE);
  const uint8_t* srow = sm + R_OFF + buf * KP;
  const int j0 = st * KP / a.group;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c = (threadIdx.x / 128) * 64 + ((threadIdx.x % 128) / 32) * 16 + 2 * g;
  const bool uniform = a.group % 16 == 0;  // a k16 step lies in one group
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k0 = kk * 16 + 2 * t;  // K rows k0, k0+1, k0+8, k0+9
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      u[e] = *reinterpret_cast<const uint16_t*>(ps + (k0 + (e & 1) + 8 * (e >> 1)) * PS + c);
    // scales: [half][fragment register], each a T pair of rn_T(s) over its
    // two K
    uint32_t sp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (uniform) {
        const float2 v = scales_at<T>(ss, h, srow[kk * 16], c, j0, n0, a);
        sp[h][0] = sp[h][2] = E::pack(v.x, v.x);
        sp[h][1] = sp[h][3] = E::pack(v.y, v.y);
      } else {
        float2 s[4];  // K row k0, k0+1, k0+8, k0+9; (column c, c + 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = scales_at<T>(ss, h, srow[k0 + (e & 1) + 8 * (e >> 1)], c, j0, n0, a);
        sp[h][0] = E::pack(s[0].x, s[1].x);
        sp[h][1] = E::pack(s[0].y, s[1].y);
        sp[h][2] = E::pack(s[2].x, s[3].x);
        sp[h][3] = E::pack(s[2].y, s[3].y);
      }
    }
    // register 0: column c at K k0, k0+1; 1: column c+1 at K k0, k0+1;
    // 2 and 3: the same at K k0+8, k0+9
    const uint32_t w[4] = {__byte_perm(u[0], u[1], 0x0400), __byte_perm(u[0], u[1], 0x0501),
                           __byte_perm(u[2], u[3], 0x0400), __byte_perm(u[2], u[3], 0x0501)};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      dequant_pair<T>(w[r], sp[0][r], sp[1][r], frag[kk][r], frag[4 + kk][r]);
  }
}

template <typename T>
__device__ __forceinline__ void issue_wgmmas(float (&acc)[64],
                                             uint32_t (&frag)[8][4],
                                             const uint8_t* sm, int buf) {
  const uint32_t xa = smem_u32(sm + X_OFF + buf * 2 * X_TILE);
  // every input of the stage's wgmmas is computed before wgmma.fence:
  // a register defined after it would make ptxas serialize the wgmmas
  uint64_t desc[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    desc[f] = sw128_desc(xa + (f / 4) * X_TILE + (f % 4) * 32);
    asm volatile("" : "+l"(desc[f]));
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(frag[f][r]));
  }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int f = 0; f < 8; ++f) wgmma_m64n128k16_rs<T>(acc, frag[f], desc[f]);
  wgmma_commit();
  fence_regs(acc);
}

// One stage: dequantize it, run its wgmmas, wait for the next stage's
// copies, one barrier, then the copies of stage st + NBUF into its buffer.
template <typename T>
__device__ __forceinline__ void run_stage(float (&acc)[64], uint32_t (&frag)[8][4],
                                          uint8_t* sm, int st, int n_stages,
                                          int m0, int n0, const Args<T>& a) {
  dequant_stage<T>(sm, st % NBUF, st, n0, a, frag);
  issue_wgmmas<T>(acc, frag, sm, st % NBUF);
  // ptxas serializes wgmmas whose register inputs are written while an
  // earlier group is in flight, so the stage's group is retired here; the
  // other block on the SM fills the tensor cores meanwhile
  wgmma_wait<0>();
  fence_regs(acc);
  // stage st+1's copies have landed (NBUF - 2 later stages may be in flight)
  cp_async_wait<NBUF - 2>();
  // stage st+1 is visible to every thread, and every warpgroup is done with
  // buffer st, which stage st+NBUF now takes
  __syncthreads();
  const int next = st + NBUF;
  if (next < n_stages) load_stage(sm, next % NBUF, next, m0, n0, a);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) int4_wgmma_kernel(const Args<T> a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.y * BN, n0 = blockIdx.x * BO;
  const int t = threadIdx.x;
  const int n_stages = (a.in_dim / 2 + KP - 1) / KP;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int st = 0; st < NBUF; ++st) {
    if (st < n_stages) load_stage(sm, st, st, m0, n0, a);
    cp_async_commit();
  }
  cp_async_wait<NBUF - 1>();
  __syncthreads();

  uint32_t frag[8][4];
  for (int st = 0; st < n_stages; ++st)
    run_stage(acc, frag, sm, st, n_stages, m0, n0, a);

  // accumulator i of a thread: fragment row 16 * warp + g + 8 * ((i / 2) % 2),
  // which is output column 16 * warp + 2 * g + (i / 2) % 2 of its warpgroup;
  // x row 8 * (i / 4) + 2 * t + i % 2 of the tile
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const int col = n0 + (t / 128) * 64 + ((t % 128) / 32) * 16 + 2 * g;
  const bool pairs = a.out_dim % 2 == 0;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * (i / 4) + 2 * tq + e;
      if (row >= a.batch || col >= a.out_dim) continue;
      T* dst = a.out + (size_t)row * a.out_dim + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = fs::Elem<T>::pack(acc[i + e], acc[i + 2 + e]);
      } else {
        dst[0] = fs::Elem<T>::from_float(acc[i + e]);
        if (col + 1 < a.out_dim) dst[1] = fs::Elem<T>::from_float(acc[i + 2 + e]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const uint8_t* p, const float* gs, void* out,
           int batch, int in_dim, int out_dim, int group, cudaStream_t stream) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.p = p;
  a.gs = gs;
  a.out = static_cast<T*>(out);
  a.batch = batch;
  a.in_dim = in_dim;
  a.out_dim = out_dim;
  a.group = group;
  a.srows = scale_rows(group);
  a.sglobal = a.srows > S_MAX;
  a.xvec = in_dim % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.pvec = out_dim % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.svec = out_dim % 4 == 0 && reinterpret_cast<uintptr_t>(gs) % 16 == 0;
  const cudaError_t e = cudaFuncSetAttribute(
      int4_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((out_dim + BO - 1) / BO, (batch + BN - 1) / BN);
  int4_wgmma_kernel<T><<<grid, THREADS, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// "gemv" route, bf16 (or fp16, "gemv_f16") x with g % 128 == 0 and O % 16 ==
// 0: the products on the tensor cores (mma.sync m16n8k16, 16-bit in, fp32
// sums), y^T = W^T x^T.
// A block owns 256 columns and a run of whole groups of packed rows; its
// W streams through shared memory in stages of 64 packed rows, each stage
// two TMA boxes of 64 rows x 128 bytes (the 128-byte swizzle; columns past
// O read as 0), MMA_STAGES in flight per block (one measured faster than
// two to four: the SM's other blocks keep loads in flight). Warp (wc, wr)
// takes columns [128 wc, 128 wc + 128) of the block (box wc) and every
// fourth tile of 8 packed rows. In an mma, lane
// (g = lane / 4, q = lane % 4) holds the A values of columns c = 16 g + 2 j
// and c + 1 (m = g and g + 8) at packed rows q and q + 4, each register
// one byte: its two nibbles are rows r and r + I/2 (the k pair 2q, 2q + 1),
// dequantized to the 16-bit W in x2 arithmetic. B holds x at the same
// rows, batch row g in column n = g.
// ---------------------------------------------------------------------------

constexpr int MMA_COLS = 256;          // output columns per block
constexpr int MMA_STAGE_ROWS = 64;     // packed rows per stage
constexpr int MMA_STAGES = 1;         // stages in flight (measured: 1 beat 2, 3 and 4)
constexpr int MMA_MAX_RUN = 1024;      // packed rows of a run (ops/int4.py)
constexpr int MMA_BOX = MMA_STAGE_ROWS * 128;        // one TMA box, bytes
constexpr int MMA_STAGE_BYTES = 2 * MMA_BOX;

// d += a b, m16n8k16 with fp32 sums, the operands in T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (fs::Elem<T>::kF16) {
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

// smem: ring [MMA_STAGES][2 boxes][64][128] bytes | x pairs [NB][run]
// uint32 (row r and r + I/2, T) | scale pairs [groups of the run][2][128]
// uint32 (columns c, c + 1, rn_T(s); low groups then high) | sums
// [4][NB][256] fp32. T is bf16 ("gemv") or fp16 ("gemv_f16").
template <int NB, typename T>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv_mma_kernel(const __grid_constant__ CUtensorMap pmap,
                         const T* __restrict__ x,
                         const float* __restrict__ gs,
                         T* __restrict__ out,
                         float* __restrict__ work, int* __restrict__ counters,
                         int in_dim, int out_dim, int group, int rows) {
  constexpr int n_stages = MMA_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[n_stages];
  __shared__ int last_s;
  // the swizzled boxes want 1024-byte aligned stages (1 KB of slack)
  uint8_t* ring = smem_raw + ((1024 - fs::wg::smem_u32(smem_raw) % 1024) % 1024);
  uint32_t* xs = reinterpret_cast<uint32_t*>(ring + n_stages * MMA_STAGE_BYTES);
  uint32_t* ss = xs + NB * rows;
  const int n_grp = rows / group;
  float* red = reinterpret_cast<float*>(ss + n_grp * MMA_COLS);
  const int half = in_dim / 2;
  const int ks = blockIdx.y, n_split = gridDim.y;
  const int r0 = ks * rows;
  const int tile0 = blockIdx.x * MMA_COLS;
  const int n_sub = rows / MMA_STAGE_ROWS;

  auto load_stage = [&](int slot, int sub) {  // thread 0
    fs::tma::bar_expect(&full[slot], MMA_STAGE_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fs::tma::load_2d(ring + slot * MMA_STAGE_BYTES + h * MMA_BOX, &pmap,
                       &full[slot], tile0 + 128 * h, r0 + sub * MMA_STAGE_ROWS);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < n_stages; ++st) fs::tma::bar_init(&full[st]);
    fs::tma::bar_init_fence();
    for (int st = 0; st < n_stages; ++st) load_stage(st, st);
  }

  // x of the run's rows as T pairs (row r, row r + I/2); the scales of
  // its groups as T pairs of neighbouring columns, rn_T(s)
  for (int idx = threadIdx.x; idx < NB * rows; idx += GV_THREADS) {
    const int b = idx / rows, r = r0 + idx % rows;
    const T* xb = x + (size_t)b * in_dim;
    xs[idx] = bits16(xb[r]) | (bits16(xb[half + r]) << 16);
  }
  for (int idx = threadIdx.x; idx < n_grp * MMA_COLS; idx += GV_THREADS) {
    const int gi = idx / MMA_COLS, h = (idx / (MMA_COLS / 2)) & 1;
    const int col = tile0 + 2 * (idx % (MMA_COLS / 2));
    const float* srow = gs + (size_t)(r0 / group + gi + h * (half / group)) * out_dim;
    ss[idx] = fs::Elem<T>::pack(col < out_dim ? srow[col] : 0.f,
                                col + 1 < out_dim ? srow[col + 1] : 0.f);
  }
  __syncthreads();  // x, the scales and the barriers' init are visible

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp & 1, wr = warp >> 1;
  const int g = lane >> 2, q = lane & 3;
  const int cw = wc * 128 + 16 * g;  // the lane's first column in the block
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int sub = 0; sub < n_sub; ++sub) {
    const int slot = sub % n_stages;
    fs::tma::bar_wait(&full[slot], (sub / n_stages) & 1);
    const uint8_t* box = ring + slot * MMA_STAGE_BYTES + wc * MMA_BOX;
    // a stage lies in one group (g % 128 == 0): its 16 scale pairs
    const int gi = sub * MMA_STAGE_ROWS / group;
    uint32_t s_lo[8], s_hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_lo[j] = ss[gi * MMA_COLS + cw / 2 + j];
      s_hi[j] = ss[gi * MMA_COLS + MMA_COLS / 2 + cw / 2 + j];
    }
#pragma unroll
    for (int t = 0; t < MMA_STAGE_ROWS / 8 / 4; ++t) {
      const int tr = (t * 4 + wr) * 8;  // the tile's first row in the stage
      // row R's 16-byte chunk g of the box lies at chunk g ^ (R % 8)
      const uint4 w0 = *reinterpret_cast<const uint4*>(
          box + (tr + q) * 128 + ((g ^ ((tr + q) & 7)) << 4));
      const uint4 w1 = *reinterpret_cast<const uint4*>(
          box + (tr + q + 4) * 128 + ((g ^ ((tr + q + 4) & 7)) << 4));
      const int xr = sub * MMA_STAGE_ROWS + tr + q;
      const uint32_t b0 = g < NB ? xs[g * rows + xr] : 0u;
      const uint32_t b1 = g < NB ? xs[g * rows + xr + 4] : 0u;
      const uint32_t words0[4] = {w0.x, w0.y, w0.z, w0.w};
      const uint32_t words1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // columns 4i .. 4i + 3 of the lane's 16
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column pair j = 2i + h
          const int j = 2 * i + h;
          const uint32_t sel = h ? 0x4342u : 0x4140u;
          uint32_t lo0, hi0, lo1, hi1;  // (W[r, c], W[r, c+1]), (W[r+I/2, ...])
          dequant_pair<T>(__byte_perm(words0[i], 0, sel), s_lo[j], s_hi[j], lo0, hi0);
          dequant_pair<T>(__byte_perm(words1[i], 0, sel), s_lo[j], s_hi[j], lo1, hi1);
          // A: (m = g, k pair q): column c at row q; (g + 8, q): column c + 1;
          // (g, q + 4) and (g + 8, q + 4): row q + 4
          const uint32_t a[4] = {__byte_perm(lo0, hi0, 0x5410),
                                 __byte_perm(lo0, hi0, 0x7632),
                                 __byte_perm(lo1, hi1, 0x5410),
                                 __byte_perm(lo1, hi1, 0x7632)};
          mma16<T>(acc[j], a, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0 && sub + n_stages < n_sub) load_stage(slot, sub + n_stages);
  }

  // acc[j]: y[batch 2q][c], y[2q + 1][c], y[2q][c + 1], y[2q + 1][c + 1],
  // c = cw + 2j. The four row warps meet in shared memory, in order.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 2 * q + (e & 1), c = cw + 2 * j + (e >> 1);
      if (b < NB) red[(wr * NB + b) * MMA_COLS + c] = acc[j][e];
    }
  __syncthreads();
  float* part = work + (size_t)ks * NB * out_dim;
  for (int idx = threadIdx.x; idx < NB * MMA_COLS; idx += GV_THREADS) {
    const int b = idx / MMA_COLS, col = tile0 + idx % MMA_COLS;
    if (col >= out_dim) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) y += red[(w * NB + b) * MMA_COLS + idx % MMA_COLS];
    if (n_split == 1)
      fs::store(out + (size_t)b * out_dim + col, y);
    else
      part[(size_t)b * out_dim + col] = y;
  }
  if (n_split == 1) return;
  __syncthreads();  // the block's partial is stored: publish it
  if (threadIdx.x == 0)
    last_s = fs::atomic_add_acq_rel(counters + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  for (int idx = threadIdx.x; idx < NB * MMA_COLS; idx += GV_THREADS) {
    const int b = idx / MMA_COLS, col = tile0 + idx % MMA_COLS;
    if (col >= out_dim) continue;
    fs::store(out + (size_t)b * out_dim + col,
              sum_partials(work + (size_t)b * out_dim + col, (size_t)NB * out_dim, n_split));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <int NB, typename T>
int launch_gemv_mma(const void* x, const uint8_t* p, const float* gs, void* out,
                    float* work, int* counters, int in_dim, int out_dim,
                    int group, int n_split, cudaStream_t stream) {
  const int rows = in_dim / 2 / n_split;
  const size_t smem = 1024 + (size_t)MMA_STAGES * MMA_STAGE_BYTES + 4 * NB * rows +
                      4 * (rows / group) * MMA_COLS + 16 * NB * MMA_COLS;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const int most = 1024 + MMA_STAGES * MMA_STAGE_BYTES + 4 * NB * MMA_MAX_RUN +
                     4 * (MMA_MAX_RUN / 128) * MMA_COLS + 16 * NB * MMA_COLS;
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv_mma_kernel<NB, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // p as out_dim-byte rows read in boxes of 64 rows x 128 bytes
  CUtensorMap pmap;
  const int rc = fs::tma::encode_2d(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p,
                                    out_dim, in_dim / 2, out_dim, 128,
                                    MMA_STAGE_ROWS);
  if (rc != 0) return rc;
  dim3 grid((out_dim + MMA_COLS - 1) / MMA_COLS, n_split);
  int4_gemv_mma_kernel<NB, T><<<grid, GV_THREADS, smem, stream>>>(
      pmap, static_cast<const T*>(x), gs, static_cast<T*>(out), work, counters,
      in_dim, out_dim, group, rows);
  return (int)cudaGetLastError();
}

// the tensor-core matvec takes the call: 16-bit x, whole 128-row groups,
// runs of at most MMA_MAX_RUN rows, 16-byte rows of p
bool gemv_mma_takes(int in_dim, int out_dim, int group, int n_split,
                    const void* p) {
  const int rows = in_dim / 2 / n_split;
  return group % 128 == 0 && rows <= MMA_MAX_RUN && out_dim % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int NB>
int launch_gemv(const void* x, const uint8_t* p, const float* gs, void* out,
                float* work, int* counters, int in_dim, int out_dim, int group,
                int n_split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (NB * 2 * GV_CHUNK + 2 * GV_COLS +
                                       (GV_THREADS / 32) * NB * GV_COLS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool pvec = out_dim % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  dim3 grid((out_dim + GV_COLS - 1) / GV_COLS, n_split);
  int4_gemv_kernel<T, NB><<<grid, GV_THREADS, smem, stream>>>(
      static_cast<const T*>(x), p, gs, static_cast<T*>(out), work, counters,
      in_dim, out_dim, group, in_dim / 2 / n_split, pvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemv_rows(int batch, const void* x, const uint8_t* p,
                     const float* gs, void* out, float* work, int* counters,
                     int in_dim, int out_dim, int group, int n_split,
                     cudaStream_t stream) {
  // 16-bit x on the tensor cores where the groups and rows allow it
  const bool mma = !std::is_same<T, float>::value &&
                   gemv_mma_takes(in_dim, out_dim, group, n_split, p);
  switch (batch) {
#define FS_GV(NB)                                                                \
  case NB:                                                                       \
    if constexpr (!std::is_same<T, float>::value)                                \
      if (mma)                                                                   \
        return launch_gemv_mma<NB, T>(x, p, gs, out, work, counters, in_dim,     \
                                      out_dim, group, n_split, stream);          \
    return launch_gemv<T, NB>(x, p, gs, out, work, counters, in_dim, out_dim,    \
                              group, n_split, stream)
    FS_GV(1); FS_GV(2); FS_GV(3); FS_GV(4); FS_GV(5); FS_GV(6); FS_GV(7); FS_GV(8);
#undef FS_GV
  }
  return (int)cudaErrorInvalidValue;
}

// route codes, as `ops/int4.py:ROUTES`
constexpr int kRouteGemv = 0, kRouteWgmma = 1;


// The launch of a 16-bit x's route (fs_int4_matmul's contract, its checks
// made): "gemv" (B <= GV_MAXB, with the workspace where n_split > 1) or
// "wgmma"; any other call is refused.
template <typename T>
int run16(int batch, const void* x, const uint8_t* p, const float* gs, void* out,
          float* work, int* counters, int in_dim, int out_dim, int group, int route,
          int n_split, cudaStream_t s) {
  if (route == kRouteGemv && batch <= GV_MAXB &&
      (n_split == 1 || (work != nullptr && counters != nullptr)))
    return launch_gemv_rows<T>(batch, x, p, gs, out, work, counters, in_dim, out_dim,
                               group, n_split, s);
  if (n_split != 1 || route != kRouteWgmma) return (int)cudaErrorInvalidValue;
  return tc::launch<T>(x, p, gs, out, batch, in_dim, out_dim, group, s);
}

}  // namespace

namespace fs {
namespace i4 {

// run16<T> for bf16 x (int4_mm_bf16.cu) and fp16 x (int4_mm_f16.cu)
int run_bf16(int batch, const void* x, const uint8_t* p, const float* gs, void* out,
             float* work, int* counters, int in_dim, int out_dim, int group, int route,
             int n_split, cudaStream_t s);
int run_f16(int batch, const void* x, const uint8_t* p, const float* gs, void* out,
            float* work, int* counters, int in_dim, int out_dim, int group, int route,
            int n_split, cudaStream_t s);

}  // namespace i4
}  // namespace fs
