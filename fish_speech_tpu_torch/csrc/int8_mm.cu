// int8 weight-only matmul for up to 32 rows of x:
//   y (B, O) = rn(sum_i x (B, I) * q (I, O) * s (O)), B <= 32,
// with q int8, s fp32 per output column, the sum in fp32, the scale applied
// in fp32 to the sum and y rounded once to x's dtype.
//
// Replaces the Pallas TPU kernels scripts/microbench/matvec_pallas.py
// (_kernel / pallas_matvec) and scripts/microbench/ffn_per_op_pallas.py
// (_kernel / pl_mv), which compute this same function: the int8 tile cast
// to bf16 (exact), jnp.dot with fp32 accumulation, the fp32 scale on the
// accumulator, one rounding. On the port's serving paths it is every int8
// product of up to 32 rows (`ops/quant.py:mm`): the decode steps' layer
// products and heads at B = 1 (the `mixed` session) and B = 32 (the int8
// pool), and the prefill's full LM head at one row per prompt.
//
// What bounds it on the H100: bytes. The product reads I * O int8 bytes
// once and does 2 * B * I * O operations, at most 64 per byte (B = 32), far
// below the ~295 where the bf16 tensor cores become the limit; so its least
// time is the weight's bytes over 3.35 TB/s (slow w13, 49.8 MB: 14.9 us;
// the full LM head, 397 MB: 118.5 us).
//
// Three kernels, chosen by the wrapper (`ops/int8.py:_route`) on x's dtype
// and rows (the two tensor-core kernels are templated on x's 16-bit type:
// bf16, or fp16 on the `--half` serving path, routes "gemv_cluster_f16" and
// "gemv_mma_f16", where each int8 becomes fp16 exactly, `Elem<T>::i8x2`,
// and the products run on mma.sync's `.f16` operands; the fp32 sums, the
// fp32 scale and the one rounding of y to x's dtype are the same):
// * "gemv_cluster", bf16 x of 17-32 rows (the 32-row pool): the skeleton of
//   int8_mma.cuh. A column tile of 128 outputs is one thread block cluster
//   of C blocks (C in {1, 2, 4, 8}, `ops/int8.py:int8_gemv_plan`), block r
//   taking rows [r run, (r + 1) run) of I (run a multiple of 64 rows; a
//   rank past I takes none). A producer warp streams the run's W boxes and
//   x boxes by TMA, two consumer warpgroups turn each int8 into bf16 in
//   registers and run the products on mma.sync, keep their fp32 sums of
//   the tile in shared memory, and after the cluster's barrier block r
//   adds slice r of the tile's columns over the cluster's blocks in run
//   order (distributed shared memory), scales, rounds and writes y. With
//   C = 1 (the full LM head: 1212 tiles fill the card) the block adds
//   nothing but its own sums. No global workspace, no atomics.
// * "gemv_mma", bf16 x of 1-16 rows: the products on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 sums) as y^T = W^T x^T: W^T's
//   columns on M, x's rows on N (1-2 n8 tiles). At these rows it is
//   faster than the cluster kernel (by 1-25%, PERF.md), so it
//   stays. A block owns 128 output columns and a
//   run of whole 128-row stages of I (`ops/int8.py:int8_gemv_split` picks
//   the runs from a model of the bytes each split moves). W streams by TMA
//   from its row-major (I, O) layout, without repacking: one 128 x 128-byte
//   box a stage (the 128-byte swizzle; rows past I and columns past O read
//   as 0), STAGES in flight; the stage's 128 elements of every row of x
//   arrive beside it by cp.async, counted on the same mbarrier, zero past
//   the run. Warp w takes columns [64 h, 64 h + 64), h = w % 2, of the
//   stage's k16 steps w / 2 and w / 2 + 4. In an mma, lane (g = lane / 4,
//   t = lane % 4) loads 8 bytes, columns 64 h + 8 g .. + 7, of rows 2t,
//   2t + 1, 2t + 8 and 2t + 9 (a half warp's sixteen 8-byte loads fall on
//   32 distinct banks through the swizzle); its bytes 2j and 2j + 1 are
//   columns c = 64 h + 8 g + 2 j (m = g of M tile j) and c + 1 (m = g + 8).
//   Each int8 value becomes bf16 exactly in registers (`Elem<T>::i8x2`). The
//   four warps of a column half meet in shared memory in a fixed tree,
//   in the fragments' own order (no bank conflicts).
// * "gemv", fp32 x (the small fp32 models: JAX's `--tiny --int8`, the
//   parity tool): `int8_gemv_fp32_kernel<NB, kTma>`, the products on the
//   CUDA cores in fp32 (int8_fp32.cuh gives its design: NB rows of x a
//   template parameter, four columns a lane from one 32-bit word, W
//   through a TMA ring of 64-row boxes where its rows lie 16 bytes apart,
//   x of the run in shared memory once, the warps' sums in a fixed tree).
//   Its runs are its
//   own plan's (`ops/int8.py:fp32_split`: runs of whole 64 rows, enough to
//   cover the SMs where O's 128-column tiles do not).
// "gemv_mma" and "gemv" merge their runs the same way: with one run a
// block scales its sums
// and writes y; otherwise each block writes its fp32 partial sums to a
// workspace, publishes them with a release/acquire counter per column tile
// (`fs::atomic_add_acq_rel`, as the int4 matvec) and the last block of the
// tile adds the partials in run order, applies the scale, writes y in x's
// dtype and puts the counter back to 0: one launch a product, no atomics on
// data, the same bits on every run. The workspace and counters come from
// `ops/_kernels.py:scratch`, made once per device.
//
// q needs unit column stride; its row stride `ldq` may exceed O (the
// semantic head is a view of a buffer whose rows are padded to 16 bytes,
// `models/dual_ar.py:precompute_semantic_head`). TMA needs 16-byte rows
// and a 16-byte aligned base, and the cp.async of x 16-byte rows of 8
// elements; any other q or x (and a q narrower than one box) takes the
// same kernel with each stage copied by the block's threads.

#include "common.cuh"
#include "int8_fp32.cuh"
#include "int8_mma.cuh"
#include "tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 32;                         // rows of x (ops/int8.py)
constexpr int MMA_COLS = 128;                        // output columns per block
constexpr int STAGE_ROWS = 128;                      // rows of q per stage (ops/int8.py)
constexpr int STAGES = 4;                            // stages in flight
constexpr int STAGE_BYTES = STAGE_ROWS * MMA_COLS;   // one TMA box
// the W ring, which after the main loop holds the warps' sums (4 warps'
// worth: 16 * 4 fragments of 32 lanes, fp32, at 4 n8 tiles)
constexpr int RING_BYTES = STAGES * STAGE_BYTES > 4 * 64 * 32 * 4
                               ? STAGES * STAGE_BYTES : 4 * 64 * 32 * 4;
constexpr int XROW = STAGE_ROWS + 8;  // a stage's row of x, bf16: 68 words, 4 mod 32
static_assert(STAGE_ROWS == 16 * WARPS, "a stage is two k16 steps per warp pair");
static_assert(THREADS == fs::i8f::THREADS, "the fp32 kernel's block is this file's");

using fs::i8::cp_async_arrive;
using fs::i8::i8_fragment;
using fs::i8::mma16;

// After a block's sums are stored as its partial (fp32 [B][O] per run):
// the last block of the column tile to arrive adds every run's partial in
// run order, scales, rounds and writes y, and resets the counter. `cols`
// columns from tile0; every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void finish_split(const float* __restrict__ work,
                                             int* __restrict__ counters,
                                             const float* __restrict__ s,
                                             T* __restrict__ out, int batch,
                                             int out_dim, int tile0, int cols,
                                             int n_split, int* last_s) {
  __syncthreads();  // the block's partial is stored: publish it
  if (threadIdx.x == 0)
    *last_s = fs::atomic_add_acq_rel(counters + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  // MERGE_OUT outputs of a thread at a time, MERGE_RUNS runs of each: 32
  // loads in flight, each output's runs added in run order
  constexpr int MERGE_OUT = 4, MERGE_RUNS = 8;
  const size_t stride = (size_t)batch * out_dim;
  for (int base = threadIdx.x; base < batch * cols; base += MERGE_OUT * THREADS) {
    float acc[MERGE_OUT];
    int at[MERGE_OUT], col[MERGE_OUT];  // y's offset, -1 past the tile
#pragma unroll
    for (int u = 0; u < MERGE_OUT; ++u) {
      const int idx = base + u * THREADS;
      col[u] = tile0 + idx % cols;
      at[u] = idx < batch * cols && col[u] < out_dim ? idx / cols * out_dim + col[u] : -1;
      acc[u] = 0.f;
    }
    for (int k0 = 0; k0 < n_split; k0 += MERGE_RUNS) {
      float v[MERGE_OUT][MERGE_RUNS];
#pragma unroll
      for (int u = 0; u < MERGE_OUT; ++u)
#pragma unroll
        for (int r = 0; r < MERGE_RUNS; ++r)
          v[u][r] = at[u] >= 0 && k0 + r < n_split
                        ? __ldcg(work + at[u] + (k0 + r) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < MERGE_OUT; ++u)
#pragma unroll
        for (int r = 0; r < MERGE_RUNS; ++r)
          if (k0 + r < n_split) acc[u] += v[u][r];
    }
#pragma unroll
    for (int u = 0; u < MERGE_OUT; ++u)
      if (at[u] >= 0) fs::store(out + at[u], acc[u] * s[col[u]]);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// grid (ceil(O / MMA_COLS), n_split); run r covers rows [r * run, min(I,
// (r + 1) * run)), run a multiple of STAGE_ROWS. Dynamic shared memory:
// 1 KB of alignment slack | the W ring [STAGES][STAGE_ROWS][128] bytes, at
// least RING_BYTES (after the main loop: the warps' sums) | the x ring
// [STAGES][B][XROW] T (x's type). kTma: W by TMA and x by cp.async, STAGES
// in flight, both counted on the stage's barrier; else the block's threads
// copy each stage into slot 0 before it is used.
template <int NT, bool kTma, typename T>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 3 : 2)
    int8_gemv_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const int8_t* __restrict__ q,
                         const T* __restrict__ x,
                         const float* __restrict__ s,
                         T* __restrict__ out,
                         float* __restrict__ work, int* __restrict__ counters,
                         int batch, int in_dim, int out_dim, int ldq, int run) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int last_s;
  // the swizzled boxes want 1024-byte aligned stages
  uint8_t* ring = smem_raw + ((1024 - fs::wg::smem_u32(smem_raw) % 1024) % 1024);
  T* xring = reinterpret_cast<T*>(ring + RING_BYTES);
  const int tile0 = blockIdx.x * MMA_COLS;
  const int ks = blockIdx.y, n_split = gridDim.y;
  const int r0 = ks * run, len = min(in_dim, r0 + run) - r0;
  const int n_stage = (len + STAGE_ROWS - 1) / STAGE_ROWS;

  // stage st into slot: the W box, and rows [128 st, 128 st + 128) of the
  // run of every row of x (0 past the run: they meet W rows of the next run
  // or past I); every thread calls it
  auto load_stage = [&](int slot, int st) {
    const int k0 = st * STAGE_ROWS;
    T* xd = xring + slot * batch * XROW;
    if (kTma) {
      if (threadIdx.x == 0) {
        fs::tma::bar_expect(&full[slot], STAGE_BYTES);
        fs::tma::load_2d(ring + slot * STAGE_BYTES, &qmap, &full[slot], tile0, r0 + k0);
      }
      for (int idx = threadIdx.x; idx < batch * (STAGE_ROWS / 8); idx += THREADS) {
        const int b = idx / (STAGE_ROWS / 8), k = 8 * (idx % (STAGE_ROWS / 8));
        const bool in = k0 + k < len;
        fs::wg::cp_async16(xd + b * XROW + k,
                           in ? x + (size_t)b * in_dim + r0 + k0 + k : x, in);
      }
      cp_async_arrive(&full[slot]);
      return;
    }
    // 16-byte chunk c of row R of the box at chunk c ^ (R % 8), as TMA lays
    // it; past I or O, 0
    for (int idx = threadIdx.x; idx < STAGE_ROWS * (MMA_COLS / 16); idx += THREADS) {
      const int row = idx / (MMA_COLS / 16), ch = idx % (MMA_COLS / 16);
      const int gr = r0 + k0 + row, c0 = tile0 + 16 * ch;
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if (gr < in_dim) {
        const int8_t* src = q + (size_t)gr * ldq + c0;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (c0 + i < out_dim) wd[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(ring + row * 128 + ((ch ^ (row & 7)) << 4)) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    for (int idx = threadIdx.x; idx < batch * STAGE_ROWS; idx += THREADS) {
      const int b = idx / STAGE_ROWS, k = idx % STAGE_ROWS;
      xd[b * XROW + k] = k0 + k < len ? x[(size_t)b * in_dim + r0 + k0 + k]
                                      : fs::Elem<T>::from_float(0.f);
    }
  };
  if (kTma) {
    if (threadIdx.x == 0) {
      // each phase: thread 0's arrival with the box's bytes, and every
      // thread's once its copies of x have landed
      for (int st = 0; st < STAGES; ++st) fs::tma::bar_init(&full[st], THREADS + 1);
      fs::tma::bar_init_fence();
    }
    __syncthreads();  // the barriers' init is visible
    for (int st = 0; st < min(STAGES, n_stage); ++st) load_stage(st, st);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = warp & 1;  // the warp's column half
  // the lane's 8 bytes of a box row R: columns 64 h + 8 g .. + 7, in 16-byte
  // chunk 4 h + g / 2 (at chunk ^ (R % 8)), half g % 2
  const int chunk = 4 * h + (g >> 1), half8 = 8 * (g & 1);
  float acc[4][NT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int st = 0; st < n_stage; ++st) {
    const int slot = kTma ? st % STAGES : 0;
    if (kTma) {
      fs::tma::bar_wait(&full[slot], (st / STAGES) & 1);
    } else {
      load_stage(0, st);
      __syncthreads();
    }
    const uint8_t* box = ring + slot * STAGE_BYTES;
    const T* xs = xring + slot * batch * XROW;
#pragma unroll
    for (int kstep = 0; kstep < 2; ++kstep) {
      const int kr = 16 * ((warp >> 1) + 4 * kstep);  // rows kr .. kr + 15
      uint2 w[4];  // rows kr + 2t, + 1, + 8, + 9
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = kr + 2 * t + (e & 1) + 8 * (e >> 1);
        w[e] = *reinterpret_cast<const uint2*>(box + row * 128 +
                                               ((chunk ^ (row & 7)) << 4) + half8);
      }
      uint32_t b0[NT], b1[NT];  // x rows 8n + g at k 2t, 2t + 1 and 2t + 8, 2t + 9
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int b = 8 * n + g;
        const T* xr = xs + (b < batch ? b : 0) * XROW + kr + 2 * t;
        b0[n] = b < batch ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        b1[n] = b < batch ? *reinterpret_cast<const uint32_t*>(xr + 8) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // M tile j: columns c = 64h + 8g + 2j, c + 1
        const uint32_t v0 = j < 2 ? w[0].x : w[0].y, v1 = j < 2 ? w[1].x : w[1].y;
        const uint32_t v2 = j < 2 ? w[2].x : w[2].y, v3 = j < 2 ? w[3].x : w[3].y;
        uint32_t a[4];
        if (j & 1) {
          i8_fragment<T, 2>(a, v0, v1, v2, v3);
        } else {
          i8_fragment<T, 0>(a, v0, v1, v2, v3);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma16<T>(acc[j][n], a, b0[n], b1[n]);
      }
    }
    __syncthreads();  // the stage is read: refill its slot
    if (kTma && st + STAGES < n_stage) load_stage(slot, st + STAGES);
  }

  // The four warps of a column half (h, h + 2, h + 4, h + 6) meet in the
  // ring (every stage is consumed) in a fixed tree, (w + (w + 4)) +
  // ((w + 2) + (w + 6)). They hold the same (row, column) at the same
  // (fragment, lane), so the sums travel in fragment order: fragment
  // f = (j * NT + n) * 4 + e of lane l at f * 32 + l, 32 lanes on 32 banks.
  constexpr int NF = 16 * NT;  // fragments of a lane
  float* red = reinterpret_cast<float*>(ring);
  for (int half = WARPS / 2; half >= 2; half /= 2) {
    float* buf = red + (warp % half) * NF * 32 + lane;
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) buf[((j * NT + n) * 4 + e) * 32] = acc[j][n][e];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][n][e] += buf[((j * NT + n) * 4 + e) * 32];
    }
    __syncthreads();
  }
  // warps 0 and 1 hold the two halves: y[b][c] at red[b * RED_ROW + c] (an
  // odd row: a warp's stores fall on 16 banks, a row's reads on 32), then
  // written out a row at a time
  constexpr int RED_ROW = MMA_COLS + 1;
  if (warp < 2) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 8 * n + 2 * t + (e & 1), c = 64 * h + 8 * g + 2 * j + (e >> 1);
          if (b < batch) red[b * RED_ROW + c] = acc[j][n][e];
        }
  }
  __syncthreads();
  float* part = work + (size_t)ks * batch * out_dim;
  for (int idx = threadIdx.x; idx < batch * MMA_COLS; idx += THREADS) {
    const int b = idx / MMA_COLS, c = idx % MMA_COLS, col = tile0 + c;
    if (col >= out_dim) continue;
    if (n_split == 1)
      fs::store(out + (size_t)b * out_dim + col, red[b * RED_ROW + c] * s[col]);
    else
      part[(size_t)b * out_dim + col] = red[b * RED_ROW + c];
  }
  if (n_split > 1)
    finish_split(work, counters, s, out, batch, out_dim, tile0, MMA_COLS, n_split,
                 &last_s);
}

// grid (ceil(O / 128), n_split): block (t, k) takes column tile t (lane l
// of each warp columns 128 t + 4 l .. + 3) over run k of I, its eight warps
// the run's rows in turn (int8_fp32.cuh), x of the run staged once; W
// streams through the TMA ring (kTma) or straight from device memory (the
// layouts a box cannot take: rows not 16 bytes apart, O under a box). The
// warps' sums meet in a fixed tree, and warp 0 writes y (one run) or the
// block's partial, the tile's last block adding the runs in order.
template <int NB, bool kTma>
__global__ void __launch_bounds__(THREADS)
    int8_gemv_fp32_kernel(const __grid_constant__ CUtensorMap qmap,
                          const float* __restrict__ x, const int8_t* __restrict__ q,
                          const float* __restrict__ s, float* __restrict__ out,
                          float* __restrict__ work, int* __restrict__ counters,
                          int batch, int in_dim, int out_dim, int ldq, int run,
                          int vec) {
  namespace f = fs::i8f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[f::STAGES];
  __shared__ int last_s;
  uint8_t* ring = f::ring_base(smem_raw);
  // x of the run, then the sums
  float* xs = reinterpret_cast<float*>(kTma ? ring + f::STAGES * f::BOX_BYTES : smem_raw);
  if (kTma) f::init_ring(full);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * f::COLS, ks = blockIdx.y, n_split = gridDim.y;
  const int r0 = ks * run, len = min(in_dim, r0 + run) - r0;
  f::stage_x<NB, false>(xs, x, in_dim, batch, r0, len);
  __syncthreads();
  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
  if constexpr (kTma) {
    uint32_t seq = 0;
    f::stream_item<NB, 1>(&qmap, tile0, nullptr, 0, r0, len, ring, full, seq, xs, 0,
                          warp, WARPS, acc);
  } else {
    f::dot_rows<NB>(q + (size_t)r0 * ldq, ldq, out_dim, tile0 + 4 * lane, vec != 0, xs,
                    len, warp, WARPS, acc);
  }
  __syncthreads();  // x is read: the sums take its place
  f::reduce_warps<NB>(acc, xs, warp, WARPS);
  if (warp == 0) {
    float* part = work + (size_t)ks * batch * out_dim;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= batch) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tile0 + 4 * lane + e;
        if (col >= out_dim) break;
        if (n_split == 1)
          out[(size_t)b * out_dim + col] = acc[b][e] * s[col];
        else
          part[(size_t)b * out_dim + col] = acc[b][e];
      }
    }
  }
  if (n_split > 1)
    finish_split(work, counters, s, out, batch, out_dim, tile0, f::COLS, n_split,
                 &last_s);
}

template <int NB, bool kTma>
int launch_gemv_fp32(const CUtensorMap& qmap, const float* x, const int8_t* q,
                     const float* s, float* out, float* work, int* counters, int batch,
                     int in_dim, int out_dim, int ldq, int n_split, int run,
                     cudaStream_t stream) {
  namespace f = fs::i8f;
  if (run > f::max_run<NB>()) return (int)cudaErrorInvalidValue;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_gemv_fp32_kernel<NB, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f::smem_bytes<NB, 1, kTma>(f::max_run<NB>()));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // direct loads: 32-bit words where every row starts on a 4-byte boundary
  const int vec = ldq % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const dim3 grid((out_dim + f::COLS - 1) / f::COLS, n_split);
  int8_gemv_fp32_kernel<NB, kTma><<<grid, THREADS, f::smem_bytes<NB, 1, kTma>(run), stream>>>(
      qmap, x, q, s, out, work, counters, batch, in_dim, out_dim, ldq, run, vec);
  return (int)cudaGetLastError();
}

// the fp32 kernel at B rows: NB's instantiation, by TMA where W's layout
// takes 128-byte boxes of 64 rows
int gemv_fp32(const float* x, const int8_t* q, const float* s, float* out, float* work,
              int* counters, int batch, int in_dim, int out_dim, int ldq, int n_split,
              int run, cudaStream_t stream) {
  namespace f = fs::i8f;
  CUtensorMap map;
  const bool tma = ldq % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   out_dim >= f::COLS;
  if (tma) {
    const int rc = fs::tma::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, out_dim,
                                      in_dim, ldq, f::COLS, f::SR);
    if (rc != 0) return rc;
  } else {
    std::memset(&map, 0, sizeof(map));
  }
  switch (f::rows_of(batch)) {
#define FS_GEMV(NB)                                                                    \
  case NB:                                                                             \
    return tma ? launch_gemv_fp32<NB, true>(map, x, q, s, out, work, counters, batch, \
                                            in_dim, out_dim, ldq, n_split, run, stream) \
               : launch_gemv_fp32<NB, false>(map, x, q, s, out, work, counters, batch, \
                                             in_dim, out_dim, ldq, n_split, run, stream)
    FS_GEMV(1); FS_GEMV(8); FS_GEMV(16); FS_GEMV(32);
#undef FS_GEMV
  }
  return (int)cudaErrorInvalidValue;
}

template <int NT, bool kTma, typename T>
int launch_mma(const CUtensorMap& map, const int8_t* q, const void* x,
               const float* s, void* out, float* work, int* counters, int batch,
               int in_dim, int out_dim, int ldq, int n_split, int run,
               cudaStream_t stream) {
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_gemv_mma_kernel<NT, kTma, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        1024 + RING_BYTES + STAGES * 2 * 8 * NT * XROW);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const size_t smem = 1024 + RING_BYTES + (size_t)STAGES * 2 * batch * XROW;
  dim3 grid((out_dim + MMA_COLS - 1) / MMA_COLS, n_split);
  int8_gemv_mma_kernel<NT, kTma, T><<<grid, THREADS, smem, stream>>>(
      map, q, static_cast<const T*>(x), s, static_cast<T*>(out), work, counters,
      batch, in_dim, out_dim, ldq, run);
  return (int)cudaGetLastError();
}

template <bool kTma, typename T>
int launch_mma_rows(const CUtensorMap& map, const int8_t* q, const void* x,
                    const float* s, void* out, float* work, int* counters,
                    int batch, int in_dim, int out_dim, int ldq, int n_split,
                    int run, cudaStream_t stream) {
  switch ((batch + 7) / 8) {
#define FS_MMA(NT)                                                              \
  case NT:                                                                      \
    return launch_mma<NT, kTma, T>(map, q, x, s, out, work, counters, batch,    \
                                   in_dim, out_dim, ldq, n_split, run, stream)
    FS_MMA(1); FS_MMA(2); FS_MMA(3); FS_MMA(4);
#undef FS_MMA
  }
  return (int)cudaErrorInvalidValue;
}

// route codes, as `ops/int8.py:ROUTES`
constexpr int kRouteGemvMma = 0, kRouteGemv = 1;

}  // namespace

// The cluster kernel (route "gemv_cluster"), on int8_mma.cuh's skeleton
// (internal linkage, as above: each library built from this file keeps its
// own `sized` flags, however many of them one process loads).
namespace {
namespace cl {

using fs::i8::BOX;
using fs::i8::MAX_CLUSTER;
using fs::i8::Ring;
using fs::i8::STAGE_ROWS;
using fs::i8::STAGES;
using fs::i8::THREADS;
using fs::i8::W_STAGE;

// The producer warp's copy of a stage in place of TMA: W rows [k0, k0 + 64)
// of columns [col0, col0 + 128) and the same rows of every row of x, in
// the layouts TMA gives (128-byte swizzle; 0 past I, O and B), then the
// stage's arrival.
template <typename T>
__device__ __forceinline__ void copy_stage(const Ring& r, uint64_t* full, int slot,
                                           const int8_t* __restrict__ q,
                                           const T* __restrict__ x,
                                           int batch, int n8, int in_dim, int out_dim,
                                           int ldq, int col0, int k0) {
  const int lane = threadIdx.x & 31;
  uint8_t* wd = r.w + slot * W_STAGE;
  for (int idx = lane; idx < STAGE_ROWS * (BOX / 16); idx += 32) {
    const int row = idx / (BOX / 16), ch = idx % (BOX / 16);
    const int gr = k0 + row, c0 = col0 + 16 * ch;
    uint32_t wv[4] = {0u, 0u, 0u, 0u};
    if (gr < in_dim) {
      const int8_t* src = q + (size_t)gr * ldq + c0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c0 + i < out_dim) wv[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(wd + row * BOX + ((ch ^ (row & 7)) << 4)) =
        make_uint4(wv[0], wv[1], wv[2], wv[3]);
  }
  uint8_t* xd = r.x + slot * r.xb;
  for (int idx = lane; idx < n8 * 64; idx += 32) {
    const int n = idx / 64, k = idx % 64, gk = k0 + k;
    const T v = n < batch && gk < in_dim ? x[(size_t)n * in_dim + gk]
                                         : fs::Elem<T>::from_float(0.f);
    *reinterpret_cast<T*>(xd + n * 128 + (((k >> 3) ^ (n & 7)) << 4) + 2 * (k & 7)) = v;
  }
  __syncwarp();
  if (lane == 0) fs::tma::bar_arrive(&full[slot]);
}

// grid: ceil(O / 128) clusters of C blocks; cluster k is column tile k,
// its block of rank r the run of rows [r run, min(I, (r + 1) run)). kTma:
// W and x by TMA (maps qmap, xmap); else copied by the producer warp. T is
// x's type (bf16 or fp16).
template <int NT, bool kTma, typename T>
__global__ void __launch_bounds__(THREADS, 2)
    int8_gemv_cluster_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap xmap,
                             const int8_t* __restrict__ q,
                             const T* __restrict__ x,
                             const float* __restrict__ s,
                             T* __restrict__ out, int batch, int in_dim,
                             int out_dim, int ldq, int run) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const Ring r(smem_raw, 8 * NT);
  const int c_size = fs::cluster::size(), rank = fs::cluster::rank();
  const int tile0 = blockIdx.x / c_size * BOX;
  const int r0 = rank * run, len = min(in_dim, r0 + run) - r0;
  const int n_stage = len > 0 ? (len + STAGE_ROWS - 1) / STAGE_ROWS : 0;
  if (kTma && threadIdx.x == THREADS - 32) {
    fs::tma::prefetch_map(&qmap);
    fs::tma::prefetch_map(&xmap);
  }
  fs::i8::init_barriers(full, empty);

  if (threadIdx.x / 32 == fs::i8::PRODUCER_WARP) {
    for (int st = 0; st < n_stage; ++st) {
      const int slot = fs::i8::acquire_slot(empty, st), k0 = r0 + st * STAGE_ROWS;
      if (!kTma) {
        copy_stage(r, full, slot, q, x, batch, 8 * NT, in_dim, out_dim, ldq, tile0, k0);
      } else if (threadIdx.x % 32 == 0) {
        fs::i8::load_w(r, full, slot, &qmap, tile0, k0);
        fs::i8::load_x(r, full, slot, &xmap, k0);
      }
    }
    fs::cluster::sync();  // the cluster's sums are stored
    fs::cluster::sync();  // no block leaves while another reads its sums
    return;
  }

  fs::i8::Acc<NT> acc;
  fs::i8::mainloop<NT, T>(r, full, empty, 0, n_stage, acc);
  fs::i8::store_sums<NT>(r.red, acc);
  fs::cluster::sync();
  fs::i8::slice_sums<NT>(r.red, batch, c_size, rank,
                         [&](int n, int c, const float (&v)[MAX_CLUSTER]) {
                           const int col = tile0 + c;
                           if (col < out_dim)
                             fs::store(out + (size_t)n * out_dim + col,
                                       fs::i8::sum_in_order(v, 0, c_size) * s[col]);
                         });
  fs::cluster::sync();
}

template <int NT, bool kTma, typename T>
int launch(const CUtensorMap& qmap, const CUtensorMap& xmap, const int8_t* q,
           const void* x, const float* s, void* out, int batch, int in_dim,
           int out_dim, int ldq, int cluster, int run, cudaStream_t stream) {
  constexpr size_t smem = fs::i8::smem_bytes(8 * NT);
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_gemv_cluster_kernel<NT, kTma, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int tiles = (out_dim + BOX - 1) / BOX;
  return (int)fs::i8::launch_clustered(
      int8_gemv_cluster_kernel<NT, kTma, T>, tiles * cluster, cluster, smem, stream,
      qmap, xmap, q, static_cast<const T*>(x), s, static_cast<T*>(out), batch,
      in_dim, out_dim, ldq, run);
}

template <bool kTma, typename T>
int launch_rows(const CUtensorMap& qmap, const CUtensorMap& xmap, const int8_t* q,
                const void* x, const float* s, void* out, int batch, int in_dim,
                int out_dim, int ldq, int cluster, int run, cudaStream_t stream) {
  switch ((batch + 7) / 8) {
#define FS_CLUSTER(NT)                                                           \
  case NT:                                                                       \
    return launch<NT, kTma, T>(qmap, xmap, q, x, s, out, batch, in_dim, out_dim,  \
                               ldq, cluster, run, stream)
    FS_CLUSTER(1); FS_CLUSTER(2); FS_CLUSTER(3); FS_CLUSTER(4);
#undef FS_CLUSTER
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the cluster kernel on x of type T (fs_int8_matmul_cluster's contract)
template <typename T>
int matmul(const void* x, const void* q, const void* s, void* out, int batch,
           int in_dim, int out_dim, int ldq, int cluster, int run, void* stream) {
  if (batch < 1 || batch > MAX_ROWS || in_dim < 1 || out_dim < 1 || ldq < out_dim ||
      !fs::i8::cluster_ok(cluster) || run < STAGE_ROWS || run % STAGE_ROWS ||
      (size_t)cluster * run < (size_t)in_dim)
    return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap qmap, xmap;
  if (ldq % 16 == 0 && aligned16(q) && out_dim >= BOX && in_dim >= STAGE_ROWS &&
      in_dim % 8 == 0 && aligned16(x)) {
    // q as I rows of O bytes, ldq apart, in boxes of 64 rows x 128 bytes;
    // x as B rows of I elements of T in boxes of 8 ceil(B / 8) rows x 64
    // (rows past B and columns past I read as 0)
    int rc = fs::tma::encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, out_dim, in_dim,
                                ldq, BOX, STAGE_ROWS);
    if (rc == 0)
      rc = fs::tma::encode_2d(&xmap,
                              fs::Elem<T>::kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              x, in_dim, batch, (uint64_t)in_dim * 2, 64,
                              8 * ((batch + 7) / 8));
    if (rc != 0) return rc;
    return launch_rows<true, T>(qmap, xmap, qp, x, sp, out, batch, in_dim, out_dim,
                                ldq, cluster, run, st);
  }
  std::memset(&qmap, 0, sizeof(qmap));
  std::memset(&xmap, 0, sizeof(xmap));
  return launch_rows<false, T>(qmap, xmap, qp, x, sp, out, batch, in_dim, out_dim, ldq,
                               cluster, run, st);
}

}  // namespace cl
}  // namespace

// x (B, I) in `dtype`, contiguous; q (I, O) int8, rows ldq >= O bytes
// apart; s (O,) fp32; out (B, O) in `dtype`. Route "gemv_mma" takes bf16 or
// fp16 x (`ops/int8.py` counts the fp16 launches as "gemv_mma_f16"), "gemv"
// fp32 x. I is cut into n_split runs of `run` rows (a multiple of
// STAGE_ROWS, `ops/int8.py:int8_gemv_split`, for "gemv_mma"; of 64 rows,
// at most `fs::i8f::max_run`, `ops/int8.py:fp32_split`, for "gemv"), the
// last one shorter; with n_split > 1 the kernels need work, n_split * B * O
// fp32 partials, and counters, one int32 per 128-column tile, all 0 on
// entry (the kernels leave them 0).
extern "C" int fs_int8_matmul(const void* x, const void* q, const void* s,
                              void* out, void* work, void* counters, int batch,
                              int in_dim, int out_dim, int ldq, int dtype,
                              int route, int n_split, int run, void* stream) {
  const int align = route == kRouteGemv ? fs::i8f::RUN_ALIGN : STAGE_ROWS;
  if (batch < 1 || batch > MAX_ROWS || in_dim < 1 || out_dim < 1 || ldq < out_dim ||
      run < 1 || run % align || n_split < 1 ||
      (size_t)(n_split - 1) * run >= (size_t)in_dim ||
      (size_t)n_split * run < (size_t)in_dim ||
      (n_split > 1 && (work == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  float* wk = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteGemv && dtype == fs::kFloat32)
    return gemv_fp32(static_cast<const float*>(x), qp, sp, static_cast<float*>(out), wk,
                     cnt, batch, in_dim, out_dim, ldq, n_split, run, st);
  if (route != kRouteGemvMma || (dtype != fs::kBFloat16 && dtype != fs::kFloat16))
    return (int)cudaErrorInvalidValue;
  const bool f16 = dtype == fs::kFloat16;
  CUtensorMap map;
  if (ldq % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
      out_dim >= MMA_COLS && in_dim >= STAGE_ROWS && in_dim % 8 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    // q as I rows of O bytes, ldq apart, read in boxes of 128 rows x 128 bytes
    const int rc = fs::tma::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q,
                                      out_dim, in_dim, ldq, MMA_COLS, STAGE_ROWS);
    if (rc != 0) return rc;
    return f16 ? launch_mma_rows<true, __half>(map, qp, x, sp, out, wk, cnt, batch,
                                               in_dim, out_dim, ldq, n_split, run, st)
               : launch_mma_rows<true, __nv_bfloat16>(map, qp, x, sp, out, wk, cnt,
                                                      batch, in_dim, out_dim, ldq,
                                                      n_split, run, st);
  }
  std::memset(&map, 0, sizeof(map));
  return f16 ? launch_mma_rows<false, __half>(map, qp, x, sp, out, wk, cnt, batch,
                                              in_dim, out_dim, ldq, n_split, run, st)
             : launch_mma_rows<false, __nv_bfloat16>(map, qp, x, sp, out, wk, cnt,
                                                     batch, in_dim, out_dim, ldq,
                                                     n_split, run, st);
}

// x (B, I) bf16, contiguous, B <= 32; q (I, O) int8, rows ldq >= O bytes
// apart; s (O,) fp32; out (B, O) bf16: route "gemv_cluster". Each column
// tile's I is cut into `cluster` runs of `run` rows (cluster in {1, 2, 4,
// 8}, run a multiple of 64, cluster * run >= I; `ops/int8.py:
// int8_gemv_plan`), one block of a cluster each.
extern "C" int fs_int8_matmul_cluster(const void* x, const void* q, const void* s,
                                      void* out, int batch, int in_dim, int out_dim,
                                      int ldq, int cluster, int run, void* stream) {
  return cl::matmul<__nv_bfloat16>(x, q, s, out, batch, in_dim, out_dim, ldq, cluster,
                                   run, stream);
}

// fs_int8_matmul_cluster with fp16 x and out: route "gemv_cluster_f16"
extern "C" int fs_int8_matmul_cluster_f16(const void* x, const void* q, const void* s,
                                          void* out, int batch, int in_dim,
                                          int out_dim, int ldq, int cluster, int run,
                                          void* stream) {
  return cl::matmul<__half>(x, q, s, out, batch, in_dim, out_dim, ldq, cluster, run,
                            stream);
}
