// The int8 weight-only products on fp32 x share their pieces here: the
// matvec's "gemv" route (int8_mm.cu `int8_gemv_fp32_kernel`) and the fused
// FFN's "cuda_cores" route (int8_ffn.cu `int8_ffn_fp32_kernel`), both on
// the CUDA cores in fp32, for the tiny fp32 models (JAX's `--tiny`, with
// `--int8`) and the parity tool.
//
// An item is a tile of 128 output columns of a row-major int8 W (I, O) over
// a run of its rows, for NB rows of x (NB in {1, 8, 16, 32}, the template
// parameter: B = 1 does one FMA per weight; B of 2-8 pads to 8, 9-16 to
// 16, 17-32 to 32, the padding rows of x zero). Lane l of a warp owns the
// tile's columns 4 l .. 4 l + 3 and reads them as one 32-bit word, so a
// warp reads 128 contiguous bytes of a row of W; the warps of a group take
// the run's rows in turn (warp w rows w, w + n_w, ...). W streams through
// a ring of STAGES stages of 64-row TMA boxes in shared memory, asked for
// by one thread against an mbarrier each (`stream_item`: 32 KB in flight a
// box), where W's rows lie 16 bytes apart and O fills a box; other layouts
// read W straight from device memory, 8 or 16 rows in flight a warp
// (`dot_rows`). The run's x sits once in shared memory, row i's NB values
// side by side (`xstride`), read as float4 broadcasts. The group's warps
// then add their sums through shared memory in a fixed tree
// (`reduce_warps`), so every run gives the same bits.
//
// What bounds them on the H100: the weight's bytes at B = 1 (2 B operations
// a byte, far below the CUDA cores' 67 TFLOP/s over 3.35 TB/s = 20); at
// B = 32 the fp32 operations (64 a byte). The wrappers' split plans
// (`ops/int8.py:fp32_split`) cut I into runs so that the items cover the
// SMs where O's tiles alone do not.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace fs {
namespace i8f {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;       // an item's columns: 32 lanes x 4
// rows of W a warp has in flight (direct loads): 16 at one row of x, where
// a tiny product's rows are then one round trip a warp; 8 where the sums
// of more rows need the registers
template <int NB>
__host__ __device__ constexpr int unroll() {
  return NB == 1 ? 16 : 8;
}
constexpr int RUN_ALIGN = 64;   // runs are whole multiples of this (ops/int8.py)
constexpr int SR = 64;          // rows of W a stage of the ring holds: one TMA box
constexpr int STAGES = 4;       // stages of the ring in flight
constexpr int BOX_BYTES = SR * COLS;  // a box: SR rows x 128 bytes, 128-byte swizzle
static_assert(RUN_ALIGN % SR == 0, "a run is whole stages");

// x's row stride in shared memory: NB values, 4 words of padding past one
// (float4-aligned rows; a staging store conflicts 4 ways, not NB ways)
template <int NB>
__host__ __device__ constexpr int xstride() {
  return NB == 1 ? 1 : NB + 4;
}

// the longest run of rows an item takes at NB rows of x (ops/int8.py:
// FP32_MAX_RUN): its x fits 16 KB at NB = 1, under 48 KB otherwise
template <int NB>
__host__ __device__ constexpr int max_run() {
  return NB == 1 ? 4096 : NB == 8 ? 1024 : NB == 16 ? 512 : 256;
}

// floats of dynamic shared memory an item takes over `run` rows: x of the
// run, where after the products the warps' sums take their place (half the
// block's warps, NB x COLS floats each, for the tree's first round)
template <int NB>
__host__ __device__ constexpr int smem_floats(int run) {
  return run * xstride<NB>() > (WARPS / 2) * NB * COLS ? run * xstride<NB>()
                                                        : (WARPS / 2) * NB * COLS;
}

// xs[i * xstride + b] = x[b, r0 + i] for i < len, b < NB (0 for b >=
// batch). x's rows are ldx apart; `cg` reads through L2 only (x written by
// other blocks of this launch).
template <int NB, bool cg>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x, int ldx,
                                        int batch, int r0, int len) {
  constexpr int XS = xstride<NB>();
  for (int idx = threadIdx.x; idx < NB * len; idx += blockDim.x) {
    const int b = idx / len, i = idx % len;  // i fastest: x's reads coalesce
    float v = 0.f;
    if (b < batch) {
      const float* p = x + (size_t)b * ldx + r0 + i;
      v = cg ? __ldcg(p) : *p;
    }
    xs[i * XS + b] = v;
  }
}

// four int8 weights of a row from column c on: one 32-bit load where the
// word lies inside the row's first n columns and `vec` says rows and base
// are 4-byte aligned, else byte by byte (0 past n); returned XOR 0x80808080,
// as `i8_to_f32` takes it
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ p, int rem, bool vec) {
  if (vec && rem >= 4) return __ldg(reinterpret_cast<const uint32_t*>(p)) ^ 0x80808080u;
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < rem) w |= (uint32_t)(uint8_t)__ldg(p + e) << (8 * e);
  return w ^ 0x80808080u;
}

// acc[b][e] += x[b] (xr: NB values) * w[e], w the four weights of a word
// (XOR 0x80808080)
template <int NB>
__device__ __forceinline__ void fma_word(uint32_t wx, const float* xr, float (&acc)[NB][4]) {
  const float wf[4] = {i8_to_f32<0>(wx), i8_to_f32<1>(wx), i8_to_f32<2>(wx),
                       i8_to_f32<3>(wx)};
  if constexpr (NB == 1) {
    const float xv = *xr;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][e] = fmaf(xv, wf[e], acc[0][e]);
  } else {
#pragma unroll
    for (int b4 = 0; b4 < NB / 4; ++b4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * b4);
      const float xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * b4 + j][e] = fmaf(xb[j], wf[e], acc[4 * b4 + j][e]);
    }
  }
}

// acc[b][e] += sum over this warp's rows i of [0, len) (w, w + n_w, ...) of
// x[b][i] (xs) * q[i][c + e], c = the lane's first column; q points at the
// run's first row, rows ldq apart; n is O (columns past it read as 0). The
// loads go straight to device memory: the layouts a TMA box cannot take.
template <int NB>
__device__ __forceinline__ void dot_rows(const int8_t* __restrict__ q, int ldq, int n,
                                         int c, bool vec, const float* xs, int len,
                                         int w, int n_w, float (&acc)[NB][4]) {
  constexpr int XS = xstride<NB>();
  const int rem = n - c;  // the lane's columns inside O: none if <= 0
  if (rem <= 0) return;
  constexpr int UNROLL = unroll<NB>();
  const int8_t* col = q + c;
  for (int i0 = w; i0 < len; i0 += n_w * UNROLL) {
    uint32_t wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * n_w;
      wv[u] = i < len ? load4(col + (size_t)i * ldq, rem, vec) : 0x80808080u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * n_w;
      if (i >= len) break;
      fma_word<NB>(wv[u], xs + i * XS, acc);
    }
  }
}

// The ring: STAGES stages of NBOX boxes (SR rows x 128 bytes each, 128-byte
// swizzle, the stage 1024-byte aligned), thread 0 asking the TMA for each
// stage against the stage's mbarrier (`full`), every warp waiting on it.
// A block walks its items' stages in one sequence (`seq`: stages it has
// consumed; slot seq % STAGES, phase seq / STAGES).
//
// acc += this warp's share of rows [r0, r0 + len) of box `box` of the
// item: box 0 is map0's 128 columns from c0, box 1 map1's from c1 (NBOX =
// 2); the warp takes rows w, w + n_w, ... of each stage, x of the run's
// rows from xs. Columns past O and rows past I read as the TMA's zeros;
// rows of a stage past the run are not summed. Every thread of the block
// calls it (it holds block barriers).
template <int NB, int NBOX>
__device__ __forceinline__ void stream_item(const CUtensorMap* map0, int c0,
                                            const CUtensorMap* map1, int c1, int r0,
                                            int len, uint8_t* ring, uint64_t* full,
                                            uint32_t& seq, const float* xs, int box,
                                            int w, int n_w, float (&acc)[NB][4]) {
  constexpr int XS = xstride<NB>();
  constexpr int UNROLL = 8;  // rows a warp reads from the stage at once
  const int lane = threadIdx.x & 31;
  const int n_stage = (len + SR - 1) / SR;
  // the lane's word of a box row r: 16-byte chunk lane / 4 of the row, at
  // chunk ^ (r % 8) under the swizzle
  const int chunk = lane >> 2, in_chunk = (lane & 3) << 2;
  auto load = [&](int st) {
    const int slot = (seq + st) % STAGES;
    uint8_t* dst = ring + slot * NBOX * BOX_BYTES;
    fs::tma::bar_expect(&full[slot], NBOX * BOX_BYTES);
    fs::tma::load_2d(dst, map0, &full[slot], c0, r0 + st * SR);
    if constexpr (NBOX == 2)
      fs::tma::load_2d(dst + BOX_BYTES, map1, &full[slot], c1, r0 + st * SR);
  };
  if (threadIdx.x == 0) {
    fs::tma::fence_proxy_async();  // the slots' earlier generic reads come first
    for (int st = 0; st < n_stage && st < STAGES; ++st) load(st);
  }
  for (int st = 0; st < n_stage; ++st) {
    const uint32_t at = seq + st;
    const int slot = at % STAGES;
    fs::tma::bar_wait_or_trap(&full[slot], (at / STAGES) & 1);
    const uint8_t* bx = ring + (slot * NBOX + box) * BOX_BYTES;
    const int n = min(SR, len - st * SR);  // rows of the stage inside the run
    const float* xst = xs + st * SR * XS;
    for (int i0 = w; i0 < n; i0 += n_w * UNROLL) {
      uint32_t wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = i0 + u * n_w;
        wv[u] = r < n ? *reinterpret_cast<const uint32_t*>(
                            bx + r * COLS + ((chunk ^ (r & 7)) << 4) + in_chunk) ^
                            0x80808080u
                      : 0x80808080u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = i0 + u * n_w;
        if (r >= n) break;
        fma_word<NB>(wv[u], xst + r * XS, acc);
      }
    }
    __syncthreads();  // the stage is read: refill its slot
    if (threadIdx.x == 0 && st + STAGES < n_stage) {
      fs::tma::fence_proxy_async();
      load(st + STAGES);
    }
  }
  seq += n_stage;
}

// dynamic shared memory of a kernel with an NBOX ring (kTma) over runs of
// up to `run` rows: 1 KB of alignment slack, the ring, then x of the run
// (and, after the products, the warps' sums); without the ring, x alone
template <int NB, int NBOX, bool kTma>
__host__ __device__ constexpr int smem_bytes(int run) {
  return (kTma ? 1024 + STAGES * NBOX * BOX_BYTES : 0) + 4 * smem_floats<NB>(run);
}

// the ring (1024-byte aligned) and x's region of the dynamic shared memory
__device__ __forceinline__ uint8_t* ring_base(unsigned char* raw) {
  return raw + ((1024 - fs::wg::smem_u32(raw) % 1024) % 1024);
}

// one thread initialises the ring's barriers; every thread then sees them
__device__ __forceinline__ void init_ring(uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) fs::tma::bar_init(&full[st], 1);
    fs::tma::bar_init_fence();
  }
  __syncthreads();
}

// The n_w warps (a power of two) of a group, warp w of them, have their
// sums of the same columns in acc; afterwards warp 0 of the group holds
// their total, added in a fixed tree: w + n_w / 2 into w, and so on. `red`
// holds n_w / 2 slots of NB x COLS floats; every warp of the block calls
// this the same number of times (it holds block barriers).
template <int NB>
__device__ __forceinline__ void reduce_warps(float (&acc)[NB][4], float* red, int w,
                                             int n_w) {
  const int lane = threadIdx.x & 31;
  for (int half = n_w / 2; half >= 1; half /= 2) {
    if (w >= half && w < 2 * half) {
      float* slot = red + (size_t)(w - half) * NB * COLS + 4 * lane;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        *reinterpret_cast<float4*>(slot + b * COLS) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
    __syncthreads();
    if (w < half) {
      const float* slot = red + (size_t)w * NB * COLS + 4 * lane;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(slot + b * COLS);
        acc[b][0] += v.x; acc[b][1] += v.y; acc[b][2] += v.z; acc[b][3] += v.w;
      }
    }
    __syncthreads();
  }
}

// NB, the rows of x a kernel instantiation takes, for B rows
__host__ __device__ constexpr int rows_of(int batch) {
  return batch <= 1 ? 1 : batch <= 8 ? 8 : batch <= 16 ? 16 : 32;
}

}  // namespace i8f
}  // namespace fs
