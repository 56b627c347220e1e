// Fused int8 SwiGLU FFN for up to 32 rows of x, one launch:
//   u1 = (x @ q1) * s1,  u3 = (x @ q3) * s3     fp32 sums, not rounded
//   g  = rn(u1 * sigmoid(u1) * u3)              rounded once to x's dtype
//   y  = rn((g @ q2) * s2)                      fp32 sum, one rounding
// x (B, D), B <= 32; q1, q3 (D, I) int8 with fp32 column scales s1, s3 (I);
// q2 (I, D) int8 with fp32 column scales s2 (D). q1 and q3 are the two
// halves of the session's fused w13 (D, 2I) as it holds it (q3 = q1 + I,
// rows 2I bytes apart) or the split w1 and w3.
//
// Replaces the Pallas TPU kernel scripts/microbench/ffn_fused_packed.py
// (_ffn_kernel, wrapper ffn_fused), which computes this function: int8
// tiles cast to bf16 (exact), jnp.dot with fp32 sums, the fp32 scales on
// the sums, g rounded once, the down product summed in fp32 and rounded
// once. On the port's serving paths it is every int8 FFN of up to 32 rows
// without LoRA (`models/dual_ar.py:_ffn`): the decode steps' slow stack in
// the `mixed` session (B = 1) and both stacks of the int8 pool (B = 32).
//
// What bounds it on the H100: bytes. It reads 3 D I int8 bytes once and
// does 6 B D I operations, at most 64 per byte, far below the ~295 where
// the bf16 tensor cores become the limit: slow (D 2560, I 9728) 74.7 MB,
// 22.3 us at 3.35 TB/s; fast (1536, 6144) 28.3 MB, 8.5 us.
//
// Design. The TPU kernel walks chunks of I down one sequential grid axis,
// carrying y's sum in VMEM, over weights packed chunk by chunk for its DMA.
// Here blocks run in parallel, and the function has two dependencies across
// the grid: the gate needs all of D summed for its column of u1 and u3, and
// the down product needs every column of g. So one launch runs two phases
// split by grid barriers, each a split matvec in the manner of int8_mm.cu's
// "gemv_mma" kernel, over the weights as the session holds them, row-major
// (no packed copy):
// * phase A: items (128 columns of I, a run of D's rows). A stage is two
//   TMA boxes of STAGE_ROWS rows x 128 bytes (128-byte swizzle), the tile's
//   columns of q1 and of q3, and the stage's elements of every row of x by
//   cp.async, all counted on the stage's mbarrier, STAGES in flight. Each
//   item writes its fp32 partial sums of u1 and u3; after a grid barrier
//   (common.cuh `grid_arrive_wait`) every block adds the runs of its share
//   of them in run order and forms g (B x I, x's dtype) in the workspace.
// * a grid barrier.
// * phase B: items (256 columns of D, a run of I's rows): two boxes of q2
//   side by side, with g as x; each item writes its fp32 partial, and after
//   a grid barrier every block adds the runs of its share of y into `out`.
// In a stage, warp w takes box (w % 4) / 2, column half w % 2 (64 columns)
// and every other k16 step from w / 4; the products run on the
// tensor cores (mma.sync m16n8k16, W^T on M, x's rows on N in 1-4 n8
// tiles, int8 -> bf16 exactly in registers: int8_mma.cuh), lanes reading
// the swizzled box as int8_mm.cu's kernel does. The two warps of a column
// quarter add their sums in a fixed order through shared memory (the ring,
// idle once an item's stages are read; a proxy fence orders those writes
// before the next item's TMA). Two blocks share an SM, so one streams while
// the other sums. The runs are merged by every block rather than by the
// last of a column tile to arrive: at 32 rows that one block would read
// back up to 1 MB of partials alone while the others wait.
// `ops/int8_ffn.py:int8_ffn_plan` picks the runs from a model of the bytes
// the busiest block moves. The grid is persistent, every block walking the
// phases' items grid-stride, and at most as large as the card holds at once
// (the occupancy calculator; a larger launch is refused, never left to wait
// at a barrier forever; a wait that outlasts common.cuh's kStuckNs traps).
// No atomics on data: the same bits on every run. The workspace and the
// barrier's word come from `ops/_kernels.py:scratch`; the word needs no
// reset, so a captured graph replays.
//
// fp16 x (the `--half` serving path, route "mma_f16"): the same kernel
// instantiated for __half (x, g and y in fp16, each int8 -> fp16 exactly,
// mma.sync's `.f16` operands): g = rn_f16(silu(u1) u3) and y = rn_f16((g @
// q2) s2), the sums in fp32 as in bf16.
//
// fp32 x (the small fp32 models: JAX's `--tiny --int8`, the parity tool),
// route "cuda_cores": `int8_ffn_fp32_kernel<NB, kTma>`, the same phases and
// items (two 128-column boxes) on the CUDA cores in fp32, in the design of
// int8_fp32.cuh (NB rows of x a template parameter, four columns a lane
// from one 32-bit word, W through a TMA ring where its layout takes the
// boxes, x of the run in shared memory once), split as the wrapper's plan
// says (`ops/int8_ffn.py:int8_ffn_plan`: runs of I and of D so that the
// items cover the SMs where the column tiles alone do not), the grid sized
// to the items. With one run of D a block gates its own u1 and u3 and the
// launch holds one grid barrier (the tiny FFNs: one block, no partials).

#include "common.cuh"
#include "int8_fp32.cuh"
#include "int8_mma.cuh"
#include "tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;                  // blocks an SM holds: at most 128 registers a thread
constexpr int MAX_ROWS = 32;                   // rows of x (ops/int8_ffn.py)
constexpr int STAGE_ROWS = 64;                 // weight rows a stage, runs whole stages (ops/int8_ffn.py)
constexpr int KSTEPS = STAGE_ROWS / 32;        // k16 steps of a warp per stage
constexpr int BOX = 128;                       // columns (bytes) of a TMA box
constexpr int BOX_BYTES = STAGE_ROWS * BOX;
constexpr int STAGE_BYTES = 2 * BOX_BYTES;     // two boxes a stage
constexpr int STAGES = 4;                      // stages in flight
constexpr int ITEM_COLS = 2 * BOX;             // an item's sums: its two boxes' columns
constexpr int XROW = STAGE_ROWS + 8;           // a stage's row of x, 16-bit: 4 words mod 32
constexpr int RED_ROW = ITEM_COLS + 1;         // a row of the item's sums, fp32
constexpr int RED_FLOATS = MAX_ROWS * RED_ROW;
static_assert(RED_FLOATS >= 4 * 64 * 32, "the warps' fragments fit the sums' region");
static_assert(STAGE_ROWS % 32 == 0, "whole k16 steps per warp");
// the W ring, which after an item's main loop holds its sums
constexpr int RING_BYTES = STAGES * STAGE_BYTES > RED_FLOATS * 4 ? STAGES * STAGE_BYTES
                                                                 : RED_FLOATS * 4;
constexpr int MAX_SPLIT = 64;                  // most runs a phase's rows are cut into
static_assert(THREADS == fs::i8f::THREADS && STAGE_ROWS == fs::i8f::SR &&
                  BOX == fs::i8f::COLS,
              "the fp32 kernel's block and boxes are this file's");

struct Ffn {
  const void* x;                 // (B, D), x's dtype
  const int8_t *q1, *q3, *q2;    // the fp32 kernel's weights (the mma one's by TMA)
  const float *s1, *s3, *s2;
  void* out;                     // (B, D), x's dtype
  void* g;                       // (B, I), x's dtype, in the workspace
  float *part_a, *part_b;        // phase A (n_a, B, 2I), phase B (n_b, B, D) partials
  unsigned* bar;                 // the grid barrier's word
  int batch, d, i, ld13, ld2;
  int tiles_a, n_a, run_a, tiles_b, n_b, run_b;
};

__device__ __forceinline__ float gate(float u1, float u3) {
  const float sig = 1.f / (1.f + expf(-u1));
  return u1 * sig * u3;
}

// Every block of the (co-resident) grid: the stores before it are seen by
// the loads after it in every block.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) fs::grid_arrive_wait(bar);
  __syncthreads();
}

constexpr size_t mma_smem(int batch) {
  return 1024 + (size_t)RING_BYTES + (size_t)STAGES * batch * XROW * 2;
}

// Dynamic shared memory: 1 KB of alignment slack | the W ring [STAGES][2
// boxes][STAGE_ROWS rows][128 bytes], at least RING_BYTES, which after an
// item's main loop holds the item's sums | the x ring [STAGES][B][XROW]
// T (x's type, bf16 or fp16).
template <int NT, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    int8_ffn_mma_kernel(const __grid_constant__ CUtensorMap m1,
                        const __grid_constant__ CUtensorMap m3,
                        const __grid_constant__ CUtensorMap m2, const Ffn a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  // the swizzled boxes want 1024-byte aligned stages
  uint8_t* ring = smem_raw + ((1024 - fs::wg::smem_u32(smem_raw) % 1024) % 1024);
  T* xring = reinterpret_cast<T*>(ring + RING_BYTES);
  float* red = reinterpret_cast<float*>(ring);  // the sums, once every stage is read
  const int batch = a.batch;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int quarter = warp & 3, box = quarter >> 1, h = quarter & 1, kg = warp >> 2;
  // the lane's 8 bytes of a box row R: columns 64 h + 8 g .. + 7, in 16-byte
  // chunk 4 h + g / 2 (at chunk ^ (R % 8)), half g % 2
  const int chunk = 4 * h + (g >> 1), half8 = 8 * (g & 1);

  if (threadIdx.x == 0) {
    // each phase of a slot: thread 0's arrival with the boxes' bytes, and
    // every thread's once its copies of x have landed
    for (int st = 0; st < STAGES; ++st) fs::tma::bar_init(&full[st], THREADS + 1);
    fs::tma::bar_init_fence();
  }
  __syncthreads();  // the barriers' init is visible
  uint32_t seq = 0;  // stages this block has consumed: slot seq % STAGES, phase seq / STAGES

  // red[b * RED_ROW + c] = the item's sum of column c (box c / 128) for row b
  // of x: rows [r0, r0 + len) of box 0 (map ma at column c0) and box 1 (mb
  // at c1) against the same elements of every row of xs (rows ldx apart)
  auto item = [&](const CUtensorMap* ma, int c0, const CUtensorMap* mb, int c1,
                  const T* xs, int ldx, int r0, int len) {
    const int n_stage = (len + STAGE_ROWS - 1) / STAGE_ROWS;
    // stage st into its slot: both boxes, and the stage's elements of
    // every row of xs (0 past the run: they meet the next run's rows or
    // TMA's zeros past the weight)
    auto load = [&](int st) {
      const int slot = (seq + st) % STAGES, k0 = st * STAGE_ROWS;
      uint8_t* dst = ring + slot * STAGE_BYTES;
      if (threadIdx.x == 0) {
        fs::tma::bar_expect(&full[slot], STAGE_BYTES);
        fs::tma::load_2d(dst, ma, &full[slot], c0, r0 + k0);
        fs::tma::load_2d(dst + BOX_BYTES, mb, &full[slot], c1, r0 + k0);
      }
      T* xd = xring + slot * batch * XROW;
      for (int idx = threadIdx.x; idx < batch * (STAGE_ROWS / 8); idx += THREADS) {
        const int b = idx / (STAGE_ROWS / 8), k = 8 * (idx % (STAGE_ROWS / 8));
        const bool in = k0 + k < len;
        fs::wg::cp_async16(xd + b * XROW + k,
                           in ? xs + (size_t)b * ldx + r0 + k0 + k : xs, in);
      }
      fs::i8::cp_async_arrive(&full[slot]);
    };
    for (int st = 0; st < min(STAGES, n_stage); ++st) load(st);

    float acc[4][NT][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
    for (int st = 0; st < n_stage; ++st) {
      const uint32_t at = seq + st;
      const int slot = at % STAGES;
      fs::tma::bar_wait_or_trap(&full[slot], (at / STAGES) & 1);
      const uint8_t* bx = ring + slot * STAGE_BYTES + box * BOX_BYTES;
      const T* xst = xring + slot * batch * XROW;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int kr = 16 * (kg + 2 * s);  // rows kr .. kr + 15
        uint2 w[4];  // rows kr + 2t, + 1, + 8, + 9
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = kr + 2 * t + (e & 1) + 8 * (e >> 1);
          w[e] = *reinterpret_cast<const uint2*>(bx + row * BOX +
                                                 ((chunk ^ (row & 7)) << 4) + half8);
        }
        uint32_t b0[NT], b1[NT];  // x rows 8n + g at k 2t, 2t + 1 and 2t + 8, 2t + 9
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int b = 8 * n + g;
          const T* xr = xst + (b < batch ? b : 0) * XROW + kr + 2 * t;
          b0[n] = b < batch ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
          b1[n] = b < batch ? *reinterpret_cast<const uint32_t*>(xr + 8) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // M tile j: columns c = 64h + 8g + 2j, c + 1
          const uint32_t v0 = j < 2 ? w[0].x : w[0].y, v1 = j < 2 ? w[1].x : w[1].y;
          const uint32_t v2 = j < 2 ? w[2].x : w[2].y, v3 = j < 2 ? w[3].x : w[3].y;
          uint32_t af[4];
          if (j & 1) {
            fs::i8::i8_fragment<T, 2>(af, v0, v1, v2, v3);
          } else {
            fs::i8::i8_fragment<T, 0>(af, v0, v1, v2, v3);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) fs::i8::mma16<T>(acc[j][n], af, b0[n], b1[n]);
        }
      }
      __syncthreads();  // the stage is read: refill its slot
      if (st + STAGES < n_stage) load(st + STAGES);
    }
    seq += n_stage;

    // warps 4-7 hand their sums to warps 0-3 (the same column quarter) in
    // fragment order: fragment f = (j * NT + n) * 4 + e of lane l at
    // f * 32 + l, 32 lanes on 32 banks; then warps 0-3 write red
    constexpr int NF = 16 * NT;
    float* buf = red + quarter * NF * 32 + lane;
    if (kg == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) buf[((j * NT + n) * 4 + e) * 32] = acc[j][n][e];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][n][e] += buf[((j * NT + n) * 4 + e) * 32];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = 8 * n + 2 * t + (e & 1);
            const int c = BOX * box + 64 * h + 8 * g + 2 * j + (e >> 1);
            if (b < batch) red[b * RED_ROW + c] = acc[j][n][e];
          }
    }
    __syncthreads();
  };

  // phase A: item k is column tile k % tiles_a of I, run k / tiles_a of D;
  // red's column c < 128 is u1's column 128 tile + c, c >= 128 u3's
  const T* x = static_cast<const T*>(a.x);
  T* gw = static_cast<T*>(a.g);
  const size_t stride_a = (size_t)batch * 2 * a.i;
  for (int k = blockIdx.x; k < a.tiles_a * a.n_a; k += gridDim.x) {
    const int tile = k % a.tiles_a, run = k / a.tiles_a;
    const int r0 = run * a.run_a, len = min(a.d, r0 + a.run_a) - r0;
    item(&m1, tile * BOX, &m3, tile * BOX, x, a.d, r0, len);
    float* part = a.part_a + run * stride_a;
    for (int idx = threadIdx.x; idx < batch * BOX; idx += THREADS) {
      const int b = idx / BOX, c = idx % BOX, col = tile * BOX + c;
      if (col >= a.i) continue;
      part[(size_t)b * 2 * a.i + col] = red[b * RED_ROW + c];
      part[(size_t)b * 2 * a.i + a.i + col] = red[b * RED_ROW + BOX + c];
    }
    // red (the ring) is read, and its generic writes are ordered before the
    // next item's TMA writes into the ring
    fs::tma::fence_proxy_async();
    __syncthreads();
  }

  // every run's partial is stored: every block adds the runs of its share
  // of u1 | u3 in run order and forms g
  grid_sync(a.bar);
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < batch * a.i;
       e += gridDim.x * THREADS) {
    const int b = e / a.i, col = e % a.i;
    const float* p = a.part_a + (size_t)b * 2 * a.i + col;
    float u1 = 0.f, u3 = 0.f;
#pragma unroll 8
    for (int r = 0; r < a.n_a; ++r) {
      u1 += __ldcg(p + r * stride_a);
      u3 += __ldcg(p + r * stride_a + a.i);
    }
    fs::store(gw + e, gate(u1 * a.s1[col], u3 * a.s3[col]));
  }
  grid_sync(a.bar);  // every block's g is seen (cp.async.cg reads it from L2)

  // phase B: item k is column tile k % tiles_b of D (256 columns: q2's
  // boxes at 256 tile and 256 tile + 128), run k / tiles_b of I
  T* out = static_cast<T*>(a.out);
  const size_t stride_b = (size_t)batch * a.d;
  for (int k = blockIdx.x; k < a.tiles_b * a.n_b; k += gridDim.x) {
    const int tile = k % a.tiles_b, run = k / a.tiles_b;
    const int r0 = run * a.run_b, len = min(a.i, r0 + a.run_b) - r0;
    item(&m2, tile * ITEM_COLS, &m2, tile * ITEM_COLS + BOX, gw, a.i, r0, len);
    float* part = a.part_b + run * stride_b;
    for (int idx = threadIdx.x; idx < batch * ITEM_COLS; idx += THREADS) {
      const int b = idx / ITEM_COLS, c = idx % ITEM_COLS, col = tile * ITEM_COLS + c;
      if (col < a.d) part[(size_t)b * a.d + col] = red[b * RED_ROW + c];
    }
    // red (the ring) is read, and its generic writes are ordered before the
    // next item's TMA writes into the ring
    fs::tma::fence_proxy_async();
    __syncthreads();
  }
  // every block adds the runs of its share of y in run order
  grid_sync(a.bar);
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < batch * a.d;
       e += gridDim.x * THREADS) {
    const float* p = a.part_b + e;
    float y = 0.f;
#pragma unroll 8
    for (int r = 0; r < a.n_b; ++r) y += __ldcg(p + r * stride_b);
    fs::store(out + e, y * a.s2[e % a.d]);
  }
}

// fp32 x: the same phases on the CUDA cores, in the items of int8_fp32.cuh.
// An item is two 128-column boxes over a run of rows, each box taken by a
// group of four warps (warps 0-3 box 0, 4-7 box 1) over the run's rows in
// turn, their sums met in a fixed tree: phase A's item (column tile t of
// I, run k of D) is box t of q1 and box t of q3; phase B's (256 columns of
// D from 256 t, run k of I) two boxes of q2. W streams through the TMA
// ring (kTma) or straight from device memory (layouts a box cannot take).
// With one run of D (n_a = 1) the block applies the gate to its u1 and u3
// at once and writes g, else it writes both partials and, after a grid
// barrier, every block adds the runs of its share in run order and forms
// g. After the barrier that publishes g, phase B takes g as x (an item
// whose second box lies past D gives all eight warps to its first); one
// run writes y, else the partials meet as in the mma kernel. Dynamic shared
// memory: `fs::i8f::smem_bytes<NB, 2, kTma>` of the longest run.
// `vec13` / `vec2`: the rows of q1 and q3 / of q2 start on 4-byte
// boundaries (the direct path's 32-bit loads), else byte loads.
template <int NB, bool kTma>
__global__ void __launch_bounds__(THREADS)
    int8_ffn_fp32_kernel(const __grid_constant__ CUtensorMap m1,
                         const __grid_constant__ CUtensorMap m3,
                         const __grid_constant__ CUtensorMap m2, const Ffn a, int vec13,
                         int vec2) {
  namespace f = fs::i8f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[f::STAGES];
  uint8_t* ring = f::ring_base(smem_raw);
  // x (or g) of a run, then the sums
  float* xs = reinterpret_cast<float*>(kTma ? ring + f::STAGES * 2 * f::BOX_BYTES
                                            : smem_raw);
  if (kTma) f::init_ring(full);
  uint32_t seq = 0;
  const int batch = a.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2, wg = warp & 3;  // the warp's box, and its place in the group
  float* red = xs + grp * 2 * NB * f::COLS;   // the group's tree: two slots
  const float* x = static_cast<const float*>(a.x);
  float* gw = static_cast<float*>(a.g);
  const size_t stride_a = (size_t)batch * 2 * a.i;
  for (int k = blockIdx.x; k < a.tiles_a * a.n_a; k += gridDim.x) {
    const int tile = k % a.tiles_a, run = k / a.tiles_a;
    const int r0 = run * a.run_a, len = min(a.d, r0 + a.run_a) - r0;
    const int c = tile * f::COLS + 4 * lane;
    __syncthreads();  // the previous item is done with x and the sums
    f::stage_x<NB, false>(xs, x, a.d, batch, r0, len);
    __syncthreads();
    float acc[NB][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
    if constexpr (kTma)
      f::stream_item<NB, 2>(&m1, tile * f::COLS, &m3, tile * f::COLS, r0, len, ring,
                            full, seq, xs, grp, wg, 4, acc);
    else
      f::dot_rows<NB>((grp ? a.q3 : a.q1) + (size_t)r0 * a.ld13, a.ld13, a.i, c,
                      vec13 != 0, xs, len, wg, 4, acc);
    __syncthreads();  // x is read: the sums take its place
    f::reduce_warps<NB>(acc, red, wg, 4);
    if (a.n_a == 1) {  // u1 (warp 0) and u3 (warp 4) are whole: the gate
      if (warp == 4)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          *reinterpret_cast<float4*>(xs + b * f::COLS + 4 * lane) =
              make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      __syncthreads();
      if (warp == 0)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b >= batch) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < a.i)
              gw[(size_t)b * a.i + c + e] =
                  gate(acc[b][e] * a.s1[c + e], xs[b * f::COLS + 4 * lane + e] * a.s3[c + e]);
        }
    } else if (wg == 0) {  // warps 0 and 4: the run's partial of u1 or u3
      float* part = a.part_a + run * stride_a + grp * a.i;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= batch) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < a.i) part[(size_t)b * 2 * a.i + c + e] = acc[b][e];
      }
    }
  }
  if (a.n_a > 1) {  // every block adds the runs of its share of u1 | u3
    grid_sync(a.bar);
    for (int e = blockIdx.x * THREADS + threadIdx.x; e < batch * a.i;
         e += gridDim.x * THREADS) {
      const int b = e / a.i, col = e % a.i;
      const float* p = a.part_a + (size_t)b * 2 * a.i + col;
      float u1 = 0.f, u3 = 0.f;
      for (int r = 0; r < a.n_a; ++r) {
        u1 += __ldcg(p + r * stride_a);
        u3 += __ldcg(p + r * stride_a + a.i);
      }
      gw[e] = gate(u1 * a.s1[col], u3 * a.s3[col]);
    }
  }
  grid_sync(a.bar);  // every block's g is stored and seen

  float* out = static_cast<float*>(a.out);
  const size_t stride_b = (size_t)batch * a.d;
  for (int k = blockIdx.x; k < a.tiles_b * a.n_b; k += gridDim.x) {
    const int tile = k % a.tiles_b, run = k / a.tiles_b;
    const int r0 = run * a.run_b, len = min(a.i, r0 + a.run_b) - r0;
    // an item whose second box lies past D (D under 128 columns, or its
    // last tile) gives all eight warps to the first
    const bool one = tile * ITEM_COLS + f::COLS >= a.d;
    const int box = one ? 0 : grp, w = one ? warp : wg, n_w = one ? 8 : 4;
    const int c = tile * ITEM_COLS + box * f::COLS + 4 * lane;
    __syncthreads();
    f::stage_x<NB, true>(xs, gw, a.i, batch, r0, len);  // other blocks' g
    __syncthreads();
    float acc[NB][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
    if constexpr (kTma)
      f::stream_item<NB, 2>(&m2, tile * ITEM_COLS, &m2, tile * ITEM_COLS + f::COLS, r0,
                            len, ring, full, seq, xs, box, w, n_w, acc);
    else
      f::dot_rows<NB>(a.q2 + (size_t)r0 * a.ld2, a.ld2, a.d, c, vec2 != 0, xs, len, w,
                      n_w, acc);
    __syncthreads();
    f::reduce_warps<NB>(acc, one ? xs : red, w, n_w);
    if (w == 0) {  // y (one run) or the run's partial, of the warp's box
      float* part = a.part_b + run * stride_b;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= batch) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e >= a.d) break;
          if (a.n_b == 1)
            out[(size_t)b * a.d + c + e] = acc[b][e] * a.s2[c + e];
          else
            part[(size_t)b * a.d + c + e] = acc[b][e];
        }
      }
    }
  }
  if (a.n_b > 1) {  // every block adds the runs of its share of y in run order
    grid_sync(a.bar);
    for (int e = blockIdx.x * THREADS + threadIdx.x; e < batch * a.d;
         e += gridDim.x * THREADS) {
      const float* p = a.part_b + e;
      float y = 0.f;
      for (int r = 0; r < a.n_b; ++r) y += __ldcg(p + r * stride_b);
      out[e] = y * a.s2[e % a.d];
    }
  }
}

// the fp32 kernel's largest dynamic shared memory at NB rows (runs of up
// to `fs::i8f::max_run<NB>()` rows, the ring's layout): the occupancy and
// both forms' attribute are taken at it
template <int NB>
constexpr int fp32_smem_max() {
  return fs::i8f::smem_bytes<NB, 2, true>(fs::i8f::max_run<NB>());
}

template <int NB>
cudaError_t fp32_per_sm(int* per_sm) {
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    for (auto kernel : {int8_ffn_fp32_kernel<NB, true>, int8_ffn_fp32_kernel<NB, false>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fp32_smem_max<NB>());
      if (e != cudaSuccess) return e;
    }
    sized = true;
  }
  // the least of the two forms: `fs_int8_ffn` sizes the grid before it
  // knows which form the layout takes, and the grid barrier needs every
  // block resident
  int most = 0;
  for (auto kernel : {int8_ffn_fp32_kernel<NB, true>, int8_ffn_fp32_kernel<NB, false>}) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, THREADS, fp32_smem_max<NB>());
    if (e != cudaSuccess) return e;
    most = most == 0 ? n : (n < most ? n : most);
  }
  *per_sm = most;
  return cudaSuccess;
}

cudaError_t fp32_rows_per_sm(int batch, int* per_sm) {
  switch (fs::i8f::rows_of(batch)) {
    case 1: return fp32_per_sm<1>(per_sm);
    case 8: return fp32_per_sm<8>(per_sm);
    case 16: return fp32_per_sm<16>(per_sm);
    case 32: return fp32_per_sm<32>(per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// route codes, as `ops/int8_ffn.py:ROUTES`: "mma" takes bf16 x, "mma_f16"
// fp16 x (the same kernel for __half), "cuda_cores" fp32 x
constexpr int kRouteMma = 0, kRouteCudaCores = 1, kRouteMmaF16 = 2;

template <int NT, typename T>
cudaError_t mma_per_sm(int batch, int* per_sm) {
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(int8_ffn_mma_kernel<NT, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)mma_smem(8 * NT));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, int8_ffn_mma_kernel<NT, T>,
                                                       THREADS, mma_smem(batch));
}

template <typename T>
cudaError_t mma_rows_per_sm(int batch, int* per_sm) {
  switch ((batch + 7) / 8) {
    case 1: return mma_per_sm<1, T>(batch, per_sm);
    case 2: return mma_per_sm<2, T>(batch, per_sm);
    case 3: return mma_per_sm<3, T>(batch, per_sm);
    case 4: return mma_per_sm<4, T>(batch, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// the blocks of `route` the card holds at once at this batch (the grid
// barrier needs the whole grid resident)
int resident_blocks(int route, int batch, int* blocks) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (route == kRouteCudaCores)
    e = fp32_rows_per_sm(batch, &per_sm);
  else if (route == kRouteMmaF16)
    e = mma_rows_per_sm<__half>(batch, &per_sm);
  else
    e = mma_rows_per_sm<__nv_bfloat16>(batch, &per_sm);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * n_sm;
  return 0;
}

bool runs_ok(int n, int run, int rows) {
  return n >= 1 && n <= MAX_SPLIT && run >= 1 && run % STAGE_ROWS == 0 &&
         (size_t)(n - 1) * run < (size_t)rows && (size_t)n * run >= (size_t)rows;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the fp32 route's runs: whole 64 rows, at most `fs::i8f::max_run` at B rows
bool fp32_runs_ok(int n, int run, int rows, int batch) {
  const int nb = fs::i8f::rows_of(batch);
  const int most = nb == 1 ? fs::i8f::max_run<1>() : nb == 8 ? fs::i8f::max_run<8>()
                   : nb == 16 ? fs::i8f::max_run<16>() : fs::i8f::max_run<32>();
  return n >= 1 && n <= MAX_SPLIT && run >= 1 && run % fs::i8f::RUN_ALIGN == 0 &&
         run <= most && (size_t)(n - 1) * run < (size_t)rows &&
         (size_t)n * run >= (size_t)rows;
}

}  // namespace

// The blocks the kernel of `route` can run at once on the current device at
// `batch` rows of x: the largest grid `fs_int8_ffn` takes.
extern "C" int fs_int8_ffn_blocks(int route, int batch, int* blocks) {
  if (batch < 1 || batch > MAX_ROWS ||
      (route != kRouteMma && route != kRouteCudaCores && route != kRouteMmaF16))
    return (int)cudaErrorInvalidValue;
  return resident_blocks(route, batch, blocks);
}

// x (B, D) in `dtype`, contiguous; q1, q3 (D, I) int8, rows ld13 >= I bytes
// apart; s1, s3 (I,), s2 (D,) fp32; q2 (I, D) int8, rows ld2 >= D apart;
// out (B, D) in `dtype`. Route "mma" takes bf16 x, "mma_f16" fp16 x,
// "cuda_cores" fp32 x.
// Phase A cuts D into n_a runs of run_a rows, phase B I into n_b runs of
// run_b (multiples of STAGE_ROWS on the mma routes; on "cuda_cores" of 64
// rows, at most `fs::i8f::max_run` at B rows; the last run shorter). work: g (B x I in `dtype`, rounded up to 16
// bytes), then phase A's partials (n_a B 2I fp32), then phase B's (n_b B
// D); bar: the grid barrier's word, 0 before the
// first launch (each launch leaves its low 31 bits as it found them). grid:
// at most `fs_int8_ffn_blocks`.
extern "C" int fs_int8_ffn(const void* x, const void* q1, const void* q3, int ld13,
                           const void* s1, const void* s3, const void* q2, int ld2,
                           const void* s2, void* out, void* work, void* bar,
                           int batch, int d, int i, int dtype, int route, int n_a,
                           int run_a, int n_b, int run_b, int grid, void* stream) {
  if (batch < 1 || batch > MAX_ROWS || d < 1 || i < 1 || ld13 < i || ld2 < d ||
      grid < 1 || work == nullptr || bar == nullptr || !aligned16(work))
    return (int)cudaErrorInvalidValue;
  const bool f16 = route == kRouteMmaF16 && dtype == fs::kFloat16;
  const bool mma = (route == kRouteMma && dtype == fs::kBFloat16) || f16;
  if (mma) {
    if (d % 16 || i % 16 || d < BOX || i < BOX || ld13 % 16 || ld2 % 16 ||
        !aligned16(x) || !aligned16(q1) || !aligned16(q3) || !aligned16(q2) ||
        !runs_ok(n_a, run_a, d) || !runs_ok(n_b, run_b, i))
      return (int)cudaErrorInvalidValue;
  } else if (route != kRouteCudaCores || dtype != fs::kFloat32 ||
             !fp32_runs_ok(n_a, run_a, d, batch) || !fp32_runs_ok(n_b, run_b, i, batch)) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int rc = resident_blocks(route, batch, &blocks);
  if (rc != 0) return rc;
  if (grid > blocks) return (int)cudaErrorCooperativeLaunchTooLarge;

  const size_t esize = mma ? 2 : 4;
  float* wk = static_cast<float*>(work);
  Ffn a;
  a.x = x;
  a.q1 = static_cast<const int8_t*>(q1);
  a.q3 = static_cast<const int8_t*>(q3);
  a.q2 = static_cast<const int8_t*>(q2);
  a.s1 = static_cast<const float*>(s1);
  a.s3 = static_cast<const float*>(s3);
  a.s2 = static_cast<const float*>(s2);
  a.out = out;
  a.g = wk;
  a.part_a = wk + ((size_t)batch * i * esize + 15) / 16 * 4;
  a.part_b = a.part_a + (size_t)n_a * batch * 2 * i;
  a.bar = static_cast<unsigned*>(bar);
  a.batch = batch;
  a.d = d;
  a.i = i;
  a.ld13 = ld13;
  a.ld2 = ld2;
  a.tiles_a = (i + BOX - 1) / BOX;              // 128 columns of I
  a.tiles_b = (d + ITEM_COLS - 1) / ITEM_COLS;  // 256 columns of D
  a.n_a = n_a;
  a.run_a = run_a;
  a.n_b = n_b;
  a.run_b = run_b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // q1 / q3 as D rows of I bytes, q2 as I rows of D bytes, in boxes of 64
  // rows x 128 bytes (past I or D: TMA's zeros); the fp32 route streams
  // them too where their layout takes the boxes
  const bool tma = mma || (d % 16 == 0 && i % 16 == 0 && d >= BOX && i >= BOX &&
                           ld13 % 16 == 0 && ld2 % 16 == 0 && aligned16(q1) &&
                           aligned16(q3) && aligned16(q2));
  CUtensorMap m1, m3, m2;
  if (tma) {
    int e = fs::tma::encode_2d(&m1, CU_TENSOR_MAP_DATA_TYPE_UINT8, q1, i, d, ld13, BOX,
                               STAGE_ROWS);
    if (e == 0)
      e = fs::tma::encode_2d(&m3, CU_TENSOR_MAP_DATA_TYPE_UINT8, q3, i, d, ld13, BOX,
                             STAGE_ROWS);
    if (e == 0)
      e = fs::tma::encode_2d(&m2, CU_TENSOR_MAP_DATA_TYPE_UINT8, q2, d, i, ld2, BOX,
                             STAGE_ROWS);
    if (e != 0) return e;
  } else {
    std::memset(&m1, 0, sizeof(m1));
    std::memset(&m3, 0, sizeof(m3));
    std::memset(&m2, 0, sizeof(m2));
  }
  if (!mma) {
    const int vec13 = ld13 % 4 == 0 && reinterpret_cast<uintptr_t>(q1) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(q3) % 4 == 0;
    const int vec2 = ld2 % 4 == 0 && reinterpret_cast<uintptr_t>(q2) % 4 == 0;
    const int run = run_a > run_b ? run_a : run_b;
    switch (fs::i8f::rows_of(batch)) {
#define FS_FP32(NB)                                                                     \
  case NB:                                                                              \
    if (tma)                                                                            \
      int8_ffn_fp32_kernel<NB, true>                                                    \
          <<<grid, THREADS, fs::i8f::smem_bytes<NB, 2, true>(run), st>>>(m1, m3, m2, a, \
                                                                         vec13, vec2); \
    else                                                                                \
      int8_ffn_fp32_kernel<NB, false>                                                   \
          <<<grid, THREADS, fs::i8f::smem_bytes<NB, 2, false>(run), st>>>(m1, m3, m2, a, \
                                                                          vec13, vec2); \
    break
      FS_FP32(1); FS_FP32(8); FS_FP32(16); FS_FP32(32);
#undef FS_FP32
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = mma_smem(batch);
  switch ((batch + 7) / 8) {
#define FS_LAUNCH(NT)                                                          \
  case NT:                                                                     \
    if (f16)                                                                   \
      int8_ffn_mma_kernel<NT, __half><<<grid, THREADS, smem, st>>>(m1, m3, m2, a); \
    else                                                                       \
      int8_ffn_mma_kernel<NT, __nv_bfloat16><<<grid, THREADS, smem, st>>>(m1, m3, m2, a); \
    break
    FS_LAUNCH(1); FS_LAUNCH(2); FS_LAUNCH(3); FS_LAUNCH(4);
#undef FS_LAUNCH
  }
  return (int)cudaGetLastError();
}
