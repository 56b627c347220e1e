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
// dtype; a route that does not take the call returns cudaErrorInvalidValue.
// * "gemv", B <= 8: split-K matrix-vector kernel. A block owns 256 output columns
//   (64 column threads x 4 columns, one 4-byte coalesced load per packed
//   row) and one group of g packed rows, so both nibbles of every byte it
//   reads belong to one group each (rows r and r + I/2). For fp32 x the
//   block sums x * nibble for the two groups in fp32 and applies the two
//   scales once; for bf16 x it dequantizes every nibble to the bf16 W of
//   the other routes (below, four columns at a time in bf16x2 arithmetic)
//   and sums x * W in fp32.
//   Four row slices share the rows and are summed through shared memory.
//   The grid is (O/256) x (I/2g) blocks (e.g. 12 x 10 for 2560 -> 6144 at
//   g = 128), so most of the 132 SMs get work where a column split alone
//   would give 6-76 blocks. Each block writes its fp32 partial sums; a
//   second kernel adds the I/2g partials per output in a fixed order
//   (deterministic, no atomics) and writes x's dtype.
// * "wgmma", bf16 x and B > 8 (every prefill): tensor-core product,
//   `int4_wgmma_kernel` below, whose note gives its design.
// * "fp32_tiled", fp32 x and B > 8 (the small fp32 reference models):
//   tiled product on the CUDA cores. A block computes a 128 x 128 output
//   tile; per step it stages 8 packed rows (16 logical rows) of W, unpacked
//   and dequantized in fp32 with their group scales, and the matching 16
//   columns of x in shared memory; each thread accumulates an 8 x 8
//   sub-tile in fp32 registers.
//
// The W of each route: fp32 x (the "gemv" and "fp32_tiled" routes) uses
// q * s in fp32 (the JAX package's `int4_matmul_reference`). bf16 x (the
// "gemv" and "wgmma" routes) uses rn_bf16(q * rn_bf16(s)), which is
// bitwise the W of the Pallas kernel: it casts the nibble and the scale to
// bf16 and multiplies them in bf16, and a product of a 4-bit and an 8-bit
// significand is exact in fp32, so it rounds once. So a bf16 decode step
// and its prefill run on one W; only the order of the fp32 sums differs
// from the TPU kernel.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_COLS = 256;   // output columns per block (64 threads x 4)
constexpr int GV_SLICES = 4;   // row slices per block
constexpr int GV_MAXB = 8;     // rows of x the matvec kernel takes

__device__ __forceinline__ void load4(const uint8_t* row, int col0, int out_dim,
                                      bool vec, uint8_t w[4]) {
  if (vec) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(row + col0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = col0 + c < out_dim ? row[col0 + c] : 0x88;
  }
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// W values of the low nibbles (bytes 0 and 2 of w) and of the high ones
__device__ __forceinline__ void dequant_pair(uint32_t w, __nv_bfloat162 s_lo,
                                             __nv_bfloat162 s_hi, uint32_t& lo,
                                             uint32_t& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);  // 128 + 8
  const __nv_bfloat162 ql = __hsub2(bits_bf2((w & 0x000F000Fu) | 0x43004300u), bias);
  const __nv_bfloat162 qh =
      __hsub2(bits_bf2(((w >> 4) & 0x000F000Fu) | 0x43004300u), bias);
  lo = bf2_bits(__hmul2_rn(ql, s_lo));
  hi = bf2_bits(__hmul2_rn(qh, s_hi));
}

template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ gs, float* __restrict__ part,
                     int batch, int in_dim, int out_dim, int group) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [batch][2 * group]
  float* red = smem + batch * 2 * group;         // [SLICES-1][batch][COLS]
  const int half = in_dim / 2;
  const int k = blockIdx.y;  // packed rows [k*g, (k+1)*g): groups k and k + half/g
  const int r0 = k * group;
  const int ct = threadIdx.x % (GV_COLS / 4);
  const int slice = threadIdx.x / (GV_COLS / 4);
  const int col0 = blockIdx.x * GV_COLS + ct * 4;

  for (int idx = threadIdx.x; idx < batch * 2 * group; idx += GV_THREADS) {
    const int b = idx / (2 * group), j = idx % (2 * group);
    const int row = j < group ? r0 + j : half + r0 + (j - group);
    xs[idx] = fs::to_float(x[(size_t)b * in_dim + row]);
  }
  __syncthreads();

  float lo_acc[GV_MAXB][4], hi_acc[GV_MAXB][4];
#pragma unroll
  for (int b = 0; b < GV_MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) lo_acc[b][c] = hi_acc[b][c] = 0.f;

  // the block's two groups: k (rows r) and g_hi (rows r + I/2)
  float s_lo[4], s_hi[4];
  const int g_hi = k + half / group;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = col0 + c;
    s_lo[c] = col < out_dim ? gs[(size_t)k * out_dim + col] : 0.f;
    s_hi[c] = col < out_dim ? gs[(size_t)g_hi * out_dim + col] : 0.f;
  }
  // bf16 x: each W element is rn_bf16(q * rn_bf16(s)) before it is
  // multiplied (the scale cannot be factored out: q * s_bf16 has up to 11
  // significant bits and rounds); fp32 x: W = q * s, the scale applied once
  constexpr bool kBf16W = std::is_same<T, __nv_bfloat16>::value;
  const __nv_bfloat162 sl01 = __floats2bfloat162_rn(s_lo[0], s_lo[1]);
  const __nv_bfloat162 sl23 = __floats2bfloat162_rn(s_lo[2], s_lo[3]);
  const __nv_bfloat162 sh01 = __floats2bfloat162_rn(s_hi[0], s_hi[1]);
  const __nv_bfloat162 sh23 = __floats2bfloat162_rn(s_hi[2], s_hi[3]);

  const bool vec = (out_dim % 4 == 0) && (col0 + 4 <= out_dim);
  if (col0 < out_dim) {
    for (int j = slice; j < group; j += GV_SLICES) {
      uint8_t w[4];
      load4(p + (size_t)(r0 + j) * out_dim, col0, out_dim, vec, w);
      float lo[4], hi[4];
      if constexpr (kBf16W) {
        const uint32_t v = w[0] | (w[1] << 8) | (w[2] << 16) | ((uint32_t)w[3] << 24);
        uint32_t lo01, hi01, lo23, hi23;  // bf16 pairs, column c in the low half
        dequant_pair(__byte_perm(v, 0, 0x4140), sl01, sh01, lo01, hi01);
        dequant_pair(__byte_perm(v, 0, 0x4342), sl23, sh23, lo23, hi23);
        lo[0] = __uint_as_float(lo01 << 16); lo[1] = __uint_as_float(lo01 & 0xFFFF0000u);
        lo[2] = __uint_as_float(lo23 << 16); lo[3] = __uint_as_float(lo23 & 0xFFFF0000u);
        hi[0] = __uint_as_float(hi01 << 16); hi[1] = __uint_as_float(hi01 & 0xFFFF0000u);
        hi[2] = __uint_as_float(hi23 << 16); hi[3] = __uint_as_float(hi23 & 0xFFFF0000u);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (float)((int)(w[c] & 0xF) - 8);
          hi[c] = (float)((int)(w[c] >> 4) - 8);
        }
      }
#pragma unroll
      for (int b = 0; b < GV_MAXB; ++b) {
        if (b >= batch) break;
        const float xl = xs[b * 2 * group + j];
        const float xh = xs[b * 2 * group + group + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo_acc[b][c] = fmaf(xl, lo[c], lo_acc[b][c]);
          hi_acc[b][c] = fmaf(xh, hi[c], hi_acc[b][c]);
        }
      }
    }
  }
  if constexpr (kBf16W) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s_lo[c] = s_hi[c] = 1.f;  // already in W
  }

  // y = s_lo * sum(x * lo) + s_hi * sum(x * hi), per output column
  if (slice > 0) {
#pragma unroll
    for (int b = 0; b < GV_MAXB; ++b) {
      if (b >= batch) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((slice - 1) * batch + b) * GV_COLS + ct * 4 + c] =
            s_lo[c] * lo_acc[b][c] + s_hi[c] * hi_acc[b][c];
    }
  }
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int b = 0; b < GV_MAXB; ++b) {
      if (b >= batch) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + c;
        if (col >= out_dim) continue;
        float y = s_lo[c] * lo_acc[b][c] + s_hi[c] * hi_acc[b][c];
#pragma unroll
        for (int s = 0; s < GV_SLICES - 1; ++s)
          y += red[(s * batch + b) * GV_COLS + ct * 4 + c];
        part[((size_t)k * batch + b) * out_dim + col] = y;
      }
    }
  }
}

template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   T* __restrict__ out, int n_split, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float y = 0.f;
  for (int k = 0; k < n_split; ++k) y += part[(size_t)k * n + idx];
  fs::store(out + idx, y);
}

constexpr int BM = 128, BN = 128, KP = 8;  // tile rows, tile columns, packed rows per step
constexpr int KL = 2 * KP;                 // logical rows per step
constexpr int APAD = 4;                    // padding of the x tile against bank conflicts

template <typename T>
__global__ void __launch_bounds__(256)
    int4_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ gs, T* __restrict__ out,
                     int batch, int in_dim, int out_dim, int group) {
  __shared__ float As[KL][BM + APAD];  // x tile, k-major
  __shared__ float Bs[KL][BN];         // dequantized W tile
  const int half = in_dim / 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int bj = threadIdx.x / 32;        // packed row of the W tile this thread loads
  const int bc = (threadIdx.x % 32) * 4;  // its 4 columns
  const bool bvec = (out_dim % 4 == 0) && (n0 + bc + 4 <= out_dim);

  for (int r0 = 0; r0 < half; r0 += KP) {
    for (int idx = threadIdx.x; idx < KL * BM; idx += 256) {
      const int m = idx / KL, kk = idx % KL;
      const int r = r0 + (kk % KP);
      const int row = kk < KP ? r : half + r;
      As[kk][m] = (m0 + m < batch && r < half)
                      ? fs::to_float(x[(size_t)(m0 + m) * in_dim + row])
                      : 0.f;
    }
    {
      const int r = r0 + bj;
      uint8_t w[4] = {0x88, 0x88, 0x88, 0x88};
      if (r < half) load4(p + (size_t)r * out_dim, n0 + bc, out_dim, bvec, w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + bc + c;
        float slo = 0.f, shi = 0.f;
        if (r < half && col < out_dim) {
          slo = gs[(size_t)(r / group) * out_dim + col];
          shi = gs[(size_t)((r + half) / group) * out_dim + col];
        }
        Bs[bj][bc + c] = (float)((int)(w[c] & 0xF) - 8) * slo;
        Bs[KP + bj][bc + c] = (float)((int)(w[c] >> 4) - 8) * shi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= batch) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < out_dim) fs::store(out + (size_t)m * out_dim + n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The "wgmma" route: y (B, O) bf16 = x (B, I) bf16 @ W, W = rn_bf16(q *
// rn_bf16(s)), summed in fp32 on the tensor cores.
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
//   to nearest, as the Pallas kernel's bf16 product).
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

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* p;
  const float* gs;
  __nv_bfloat16* out;
  int batch, in_dim, out_dim, group, srows;
  bool xvec, pvec, svec;  // 16-byte copies possible (else element by element)
  bool sglobal;           // scales read from global memory (srows > S_MAX)
};

// Stage `st` into buffer `buf`. Thread t copies 8 chunks of x (rows
// t/8 + 32j of the tile, j = 0..3, in both halves, 16-byte chunk t % 8) and
// 2 of packed bytes (rows t/8 + 32j, j = 0..1, chunk t % 8).
__device__ void load_stage(uint8_t* sm, int buf, int st, int m0, int n0,
                           const Args& a) {
  const int half = a.in_dim / 2, r0 = st * KP, t = threadIdx.x, c = t % 8;
  uint8_t* xs = sm + X_OFF + buf * 2 * X_TILE + sw128(t / 8, c);
  const bool k_ok = r0 + 8 * c < half;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* dst = xs + h * X_TILE + j * 32 * 128;
      const int row = m0 + t / 8 + 32 * j;
      const __nv_bfloat16* src = a.x + (size_t)row * a.in_dim + h * half + r0 + 8 * c;
      if (a.xvec) {
        const bool valid = row < a.batch && k_ok;
        cp_async16(dst, valid ? src : a.x, valid);
      } else {
        uint4 v;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = (row < a.batch && r0 + 8 * c + i < half) ? src[i]
                                                          : __float2bfloat16(0.f);
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

// the bf16 scales of half h at scale row `rel` of the stage (row j0 + rel
// of the half's groups), for tile columns c and c + 1
__device__ __forceinline__ void scales_at(const float* ss, int h, int rel,
                                          int c, int j0, int n0, const Args& a,
                                          __nv_bfloat16& s0, __nv_bfloat16& s1) {
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
  s0 = __float2bfloat16_rn(v.x);
  s1 = __float2bfloat16_rn(v.y);
}

// A fragments of stage `st` (buffer `buf`) for this thread: frag[kk] for
// the low half's k16 step kk, frag[4 + kk] for the high half's.
__device__ __forceinline__ void dequant_stage(const uint8_t* sm, int buf, int st,
                                              int n0, const Args& a,
                                              uint32_t (&frag)[8][4]) {
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
    // scales: [half][fragment register], each a bf16 pair over its two K
    __nv_bfloat162 sp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (uniform) {
        __nv_bfloat16 s0, s1;
        scales_at(ss, h, srow[kk * 16], c, j0, n0, a, s0, s1);
        sp[h][0] = sp[h][2] = __halves2bfloat162(s0, s0);
        sp[h][1] = sp[h][3] = __halves2bfloat162(s1, s1);
      } else {
        __nv_bfloat16 s[4][2];  // [K row k0, k0+1, k0+8, k0+9][column]
#pragma unroll
        for (int e = 0; e < 4; ++e)
          scales_at(ss, h, srow[k0 + (e & 1) + 8 * (e >> 1)], c, j0, n0, a,
                    s[e][0], s[e][1]);
        sp[h][0] = __halves2bfloat162(s[0][0], s[1][0]);
        sp[h][1] = __halves2bfloat162(s[0][1], s[1][1]);
        sp[h][2] = __halves2bfloat162(s[2][0], s[3][0]);
        sp[h][3] = __halves2bfloat162(s[2][1], s[3][1]);
      }
    }
    // register 0: column c at K k0, k0+1; 1: column c+1 at K k0, k0+1;
    // 2 and 3: the same at K k0+8, k0+9
    const uint32_t w[4] = {__byte_perm(u[0], u[1], 0x0400), __byte_perm(u[0], u[1], 0x0501),
                           __byte_perm(u[2], u[3], 0x0400), __byte_perm(u[2], u[3], 0x0501)};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      dequant_pair(w[r], sp[0][r], sp[1][r], frag[kk][r], frag[4 + kk][r]);
  }
}

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
  for (int f = 0; f < 8; ++f) wgmma_m64n128k16_rs(acc, frag[f], desc[f]);
  wgmma_commit();
  fence_regs(acc);
}

// One stage: dequantize it, run its wgmmas, wait for the next stage's
// copies, one barrier, then the copies of stage st + NBUF into its buffer.
__device__ __forceinline__ void run_stage(float (&acc)[64], uint32_t (&frag)[8][4],
                                          uint8_t* sm, int st, int n_stages,
                                          int m0, int n0, const Args& a) {
  dequant_stage(sm, st % NBUF, st, n0, a, frag);
  issue_wgmmas(acc, frag, sm, st % NBUF);
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

__global__ void __launch_bounds__(THREADS, 2) int4_wgmma_kernel(const Args a) {
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
      __nv_bfloat16* dst = a.out + (size_t)row * a.out_dim + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i + e], acc[i + 2 + e]);
      } else {
        dst[0] = __float2bfloat16_rn(acc[i + e]);
        if (col + 1 < a.out_dim) dst[1] = __float2bfloat16_rn(acc[i + 2 + e]);
      }
    }
  }
}

int launch(const void* x, const uint8_t* p, const float* gs, void* out,
           int batch, int in_dim, int out_dim, int group, cudaStream_t stream) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.p = p;
  a.gs = gs;
  a.out = static_cast<__nv_bfloat16*>(out);
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
      int4_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((out_dim + BO - 1) / BO, (batch + BN - 1) / BN);
  int4_wgmma_kernel<<<grid, THREADS, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int launch_gemv(const void* x, const uint8_t* p, const float* gs, void* out,
                float* part, int batch, int in_dim, int out_dim, int group,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int n_split = (in_dim / 2) / group;
  const size_t smem =
      sizeof(float) * ((size_t)batch * 2 * group + (GV_SLICES - 1) * batch * GV_COLS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((out_dim + GV_COLS - 1) / GV_COLS, n_split);
  int4_gemv_kernel<T><<<grid, GV_THREADS, smem, stream>>>(
      xt, p, gs, part, batch, in_dim, out_dim, group);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = batch * out_dim;
  int4_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(part, ot, n_split, n);
  return (int)cudaGetLastError();
}

// route codes, as `ops/int4.py:ROUTES`
constexpr int kRouteGemv = 0, kRouteWgmma = 1, kRouteFp32Tiled = 2;

}  // namespace

// x (B, I) in `dtype`; p (I/2, O) uint8; gs (I/g, O) fp32; out (B, O) in
// `dtype`; part: (I/2g, B, O) fp32 for the "gemv" route, unused otherwise.
extern "C" int fs_int4_matmul(const void* x, const void* p, const void* gs,
                              void* out, void* part, int batch, int in_dim,
                              int out_dim, int group, int dtype, int route,
                              void* stream) {
  if (batch < 1 || in_dim < 2 || in_dim % 2 || out_dim < 1 || group < 1 ||
      (in_dim / 2) % group)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pp = static_cast<const uint8_t*>(p);
  const float* gp = static_cast<const float*>(gs);
  float* sp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteGemv && batch <= GV_MAXB) {
    if (dtype == fs::kBFloat16)
      return launch_gemv<__nv_bfloat16>(x, pp, gp, out, sp, batch, in_dim,
                                        out_dim, group, s);
    if (dtype == fs::kFloat32)
      return launch_gemv<float>(x, pp, gp, out, sp, batch, in_dim, out_dim,
                                group, s);
  }
  if (route == kRouteWgmma && dtype == fs::kBFloat16)
    return tc::launch(x, pp, gp, out, batch, in_dim, out_dim, group, s);
  if (route == kRouteFp32Tiled && dtype == fs::kFloat32) {
    dim3 grid((out_dim + BN - 1) / BN, (batch + BM - 1) / BM);
    int4_gemm_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), pp, gp, static_cast<float*>(out), batch,
        in_dim, out_dim, group);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
