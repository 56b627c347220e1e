// Training self-attention, forward and backward: causal GQA with a
// key-valid mask.
//
// Replaces the Pallas TPU kernels fish_speech_tpu/ops/pallas_attention_train.py
// (_fwd_kernel and _bwd_kernel behind flash_train_attention). Key j is
// visible to query i iff j <= i and kvalid[b, j] != 0. Masked scores are the
// finite -1e30 in the forward; the backward gives masked pairs probability
// exactly 0. A query row with no visible key arises only at left padding
// (the collator pads on the right): its output is finite and its cotangent
// is zero in training, as the TPU kernel's contract states. The forward
// writes O and the fp32 row logsumexp lse; the backward recomputes
// P = exp(S - lse) and takes delta = rowsum(dO * O) from the wrapper (a
// plain reduction, as the JAX package computes it outside its kernel).
//
// What bounds it on the H100: each direction is B*H*T^2/2 visible pairs
// times 4 D (forward) or 10 D (backward: S, dP, dV, dK, dQ) operations,
// against the tensors' bytes, read once. Every K/V (and Q/dO) tile is
// reused by 64 rows, so at the flagship's fine-tune shapes (B=2, T=1024,
// H=32, Hkv=8, D=128) it is compute-bound; at JAX's tiny training batch
// (B=2 T=200 H=2 D=32) the launch and the walk's latency are. The TPU
// kernels kept a head's whole K/V in VMEM (~2 MB at T=4096); a Hopper block
// has at most 227 KB of shared memory, so these kernels stream tiles
// through shared memory and never store a T x T tensor in device memory.
//
// Three routes, picked by dtype and head dim (`ops/flash_train.py:_route`,
// an explicit dispatch: a head dim no route takes is refused before any
// launch; fs_flash_train_fwd / fs_flash_train_bwd dispatch alike):
//  * "wgmma", bf16 at D in {64, 128}: the forward `train_fwd_wgmma_kernel`
//    (the mainloop of attn_wgmma.cuh, with the key-valid mask), the
//    backward `train_bwd_dkdv_wgmma_kernel` + `train_bwd_dq_wgmma_kernel`
//    (attn_bwd_wgmma.cuh); their notes give their design. P and dS are
//    rounded to bf16 as the products' operands, as the TPU kernel does.
//  * "fp32_tc", fp32 at D in {32, 64, 128} (the fp32 reference models, the
//    parity tool, the fp32 multi-device trainer), and
//  * "bf16_tf32", bf16 at JAX's tiny D = 32 (`train.cli --tiny`'s default
//    precision), where the wgmma kernels' 128-byte swizzled 64-column
//    blocks have no form: the forward is flash_fp32.cu's
//    `attn_tf32_kernel<D, kTrain, T>` (the fp32 prefill's kernel with the
//    per-key mask and the lse output; its note gives its design), the
//    backward `train_bwd_tf32_kernel<D, T>` below. Both replaced kernels on
//    the CUDA cores (`train_fwd_kernel`, `train_bwd_dkdv_kernel`,
//    `train_bwd_dq_kernel`: scalar fp32 FMAs from padded shared rows,
//    tiles filled by 4-byte loads with no overlap, one block per (64-key
//    tile, KV head, batch row): 8 blocks at JAX's tiny batch, each walking
//    its G heads and every later query tile alone), which ran at 6.5-10%
//    of the fp32 bound on an H100 at s2-pro's heads.
//
// `train_bwd_tf32_kernel` issues the backward's products on the tensor
// cores, mma.sync m16n8k8 .tf32 with fp32 sums, and is bounded by those
// products at 495 TFLOP/s (or by the bytes at the small shapes):
//  * 3xTF32 (tf32.cuh): an fp32 operand is big + small, a product of two
//    fp32 operands three mmas (big big, small big, big small), within
//    ~2^-19 of the fp32 product. bf16 inputs are exact in TF32: S = Q K^T
//    and dP = dO V^T are one mma, the products with the fp32 P or dS (dV,
//    dK, dQ) two; P and dS stay fp32 and dQ, dK, dV are rounded to bf16
//    once (the route's numerics before the redesign, so the plain version
//    and the tolerances did not move). A bf16 m16n8k16 kernel would have
//    taken the same instructions at D = 32 and rounded P and dS to bf16.
//  * One launch, two kinds of block, each output written once by one block
//    (deterministic, no atomics on data): dK/dV blocks own 64 keys of a KV
//    head (four warps of 16) and walk the packed query rows that can see
//    them (packed row m of (b, kv) is position m / G of head kv * G + m % G,
//    so the G heads of the group are one walk), STEP rows a step, with
//    S^T = K Q^T and dP^T = V dO^T in registers, P^T and dS^T as the next
//    mmas' A operand (dV += P^T dO, dK += dS^T Q); dQ blocks own 64 packed
//    rows and walk the key tiles up to the causal limit of their last row
//    (S = Q K^T, dP = dO V^T, dQ += dS K), as the forward does. The two
//    kinds run side by side on the SMs.
//  * Enough blocks at the small shapes: a dK/dV tile's walk is cut into Z
//    slices of `per` row tiles (`ops/flash_train.py:train_bwd_plan`, from
//    the shape and the SM count alone); each slice writes fp32 partials of
//    its 64 keys' dK and dV to a workspace and the last of a tile's slices
//    to finish (a release/acquire counter) sums them in slice order and
//    writes dK, dV, as flash_fp32.cu merges the suffix.
//  * The next step's rows (or keys), with their lse, delta and valid flags,
//    land by cp.async in a second stage while the current one is
//    multiplied: one barrier a step.
//  * Tiles read both as row pairs (mma fragments along D) and as columns
//    (B fragments along the walk) are stored unpadded with their 16-byte
//    chunks XOR-swizzled by row (`swz`), so that both reads land on 32
//    distinct banks.
//  * STEP = 2048 / D rows or keys a step (64, 32, 16 at D = 32, 64, 128),
//    so the shared memory (<= 97 KB) and the registers leave two blocks an
//    SM.

#include <initializer_list>
#include <type_traits>

#include "attn_bwd_wgmma.cuh"
#include "attn_wgmma.cuh"
#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace fs {
namespace attn32 {  // flash_fp32.cu: the training forward on the tensor cores

int run_train(const void* q, const void* k, const void* v, const int* kvalid, void* out,
              float* lse, int batch, int t_len, int n_head, int n_kv, int head_dim, bool bf16,
              float scale, cudaStream_t s);

}  // namespace attn32
}  // namespace fs

namespace {

constexpr int TC_THREADS = 128;
constexpr int BW = 64;  // keys of a dK/dV block, packed rows of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const void* q;         // (B, T, H, D)
  const void* k;         // (B, T, Hkv, D)
  const void* v;
  const void* dout;      // (B, T, H, D)
  const int* kvalid;     // (B, T)
  const float* lse;      // (B, H, T)
  const float* delta;    // (B, H, T)
  void* dq;
  void* dk;
  void* dv;
  float* work;           // n_split > 1: partials of every (tile, slice)
  int* counters;         // one per dK/dV tile, 0 on entry and exit
  int t_len, n_head, n_kv, n_group, batch, key_tiles, q_tiles, n_split, per;
  float scale;
};

template <int D, typename E>
struct Tc {
  static constexpr bool EXACT = std::is_same_v<E, __nv_bfloat16>;  // one TF32 term
  static constexpr int ESZ = sizeof(E);
  static constexpr int CE = 16 / ESZ;                 // elements of a 16-byte chunk
  static constexpr int CH = D / CE;                   // chunks of a row
  static constexpr int STEP = 2048 / D;               // rows (dK/dV) or keys (dQ) a step
  static constexpr int TILE = BW * D * ESZ;           // bytes of a 64-row tile
  static constexpr int STEP_BYTES = STEP * D * ESZ;   // bytes of a step's tile
  static constexpr int KV_STAGE = 2 * STEP_BYTES + 3 * STEP * 4;  // Q, dO; lse, delta, pos
  static constexpr int Q_STAGE = 2 * STEP_BYTES + STEP * 4;       // K, V; kvalid
  static constexpr int STAGE = KV_STAGE > Q_STAGE ? KV_STAGE : Q_STAGE;
  static constexpr int SMEM = 2 * TILE + 2 * STAGE;
  static_assert(CH >= (ESZ == 4 ? 8 : 4) && STEP % 16 == 0, "whole swizzle patterns");
  static_assert(SMEM <= 113 * 1024, "two blocks an SM");
};

// Element offset of (r, c) in a tile of rows D elements long whose 16-byte
// chunks are XOR-swizzled by row: a warp's fragment loads, row pairs
// (rows 8j + g, elements 8kd + 2t, + 1) and columns (rows 8j + 2t (+ 1),
// element 8i + g), each hit 32 distinct banks. fp32: chunk ^ 2x with
// x = 2 r1 + (r2 ^ r0) (r's bits), a bijection on the rows of either read;
// bf16 (64-byte rows, D = 32): chunk ^ ((r >> 1) & 3).
template <typename E, int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CE = 16 / sizeof(E);
  const int x = sizeof(E) == 4 ? 2 * (2 * ((r >> 1) & 1) + (((r >> 2) ^ r) & 1)) : (r >> 1) & 3;
  return r * D + ((c / CE) ^ x) * CE + c % CE;
}

template <typename E, int D>
__device__ __forceinline__ float2 pair(const E* tile, int r, int c) {
  const int o = swz<E, D>(r, c);
  if constexpr (std::is_same_v<E, __nv_bfloat16>) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + o);
    return make_float2(fs::Elem<__nv_bfloat16>::lo(w), fs::Elem<__nv_bfloat16>::hi(w));
  } else {
    return *reinterpret_cast<const float2*>(tile + o);
  }
}

template <typename E, int D>
__device__ __forceinline__ float elem(const E* tile, int r, int c) {
  return fs::to_float(tile[swz<E, D>(r, c)]);
}

// fp32 value -> TF32 terms (one where the input type is exact in TF32)
template <bool EXACT>
__device__ __forceinline__ void terms(float x, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT)
    big = __float_as_uint(x);
  else
    fs::tf32::split(x, big, small);
}

// copies row `src` (D elements, or zeros where !ok) into row r of a swizzled tile
template <typename E, int D>
__device__ __forceinline__ void copy_row_chunk(E* tile, int r, int c, const E* src, bool ok,
                                               const E* fallback) {
  constexpr int CE = 16 / sizeof(E);
  fs::wg::cp_async16(tile + swz<E, D>(r, c * CE), ok ? src + c * CE : fallback, ok);
}

template <typename E>
__device__ __forceinline__ void store2(E* p, float x, float y) {
  if constexpr (std::is_same_v<E, __nv_bfloat16>)
    *reinterpret_cast<uint32_t*>(p) = fs::Elem<__nv_bfloat16>::pack(x, y);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename E>
__device__ __forceinline__ void store4(E* p, float4 v) {
  if constexpr (std::is_same_v<E, __nv_bfloat16>)
    *reinterpret_cast<uint2*>(p) = make_uint2(fs::Elem<__nv_bfloat16>::pack(v.x, v.y),
                                              fs::Elem<__nv_bfloat16>::pack(v.z, v.w));
  else
    *reinterpret_cast<float4*>(p) = v;
}

// d[u] += a b[u] over NU n8 tiles, in the terms the operands' types need:
// a (and b) as big + small unless exact
template <bool A_EXACT, bool B_EXACT, int NU>
__device__ __forceinline__ void mma_terms(float (*d)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&am)[4], const uint32_t (*bb)[2],
                                          const uint32_t (*bm)[2]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) fs::tf32::mma(d[u], ab[0], ab[1], ab[2], ab[3], bb[u][0], bb[u][1]);
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      fs::tf32::mma(d[u], am[0], am[1], am[2], am[3], bb[u][0], bb[u][1]);
  }
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      fs::tf32::mma(d[u], ab[0], ab[1], ab[2], ab[3], bm[u][0], bm[u][1]);
  }
}

// d[j] = A B_j^T and e[j] = A' B'_j^T for j < NJ over the D dims, in one
// walk (two independent chains of mmas): A rows ra, ra + 8 of tiles a, a'
// (the warp's 16), B rows 8 j + g of tiles b, b'; fragments along D as
// pairs (the k8 step's index t is dim 8 kd + 2t, t + 4 is 8 kd + 2t + 1)
template <typename E, int D, int NJ>
__device__ __forceinline__ void scores(float (*d)[4], const E* at, const E* bt,
                                       float (*e)[4], const E* at2, const E* bt2, int ra,
                                       int g, int t) {
  constexpr bool EX = Tc<D, E>::EXACT;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) d[j][x] = e[j][x] = 0.f;
#pragma unroll 2
  for (int kd = 0; kd < D / 8; ++kd) {
    uint32_t ab[2][4], am[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const E* a = u ? at2 : at;
      const float2 a0 = pair<E, D>(a, ra, 8 * kd + 2 * t);
      const float2 a1 = pair<E, D>(a, ra + 8, 8 * kd + 2 * t);
      terms<EX>(a0.x, ab[u][0], am[u][0]);
      terms<EX>(a1.x, ab[u][1], am[u][1]);
      terms<EX>(a0.y, ab[u][2], am[u][2]);
      terms<EX>(a1.y, ab[u][3], am[u][3]);
    }
    uint32_t bb[2][NJ][2], bm[2][NJ][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 bv = pair<E, D>(u ? bt2 : bt, 8 * j + g, 8 * kd + 2 * t);
        terms<EX>(bv.x, bb[u][j][0], bm[u][j][0]);
        terms<EX>(bv.y, bb[u][j][1], bm[u][j][1]);
      }
    mma_terms<EX, EX, NJ>(d, ab[0], am[0], bb[0], bm[0]);
    mma_terms<EX, EX, NJ>(e, ab[1], am[1], bb[1], bm[1]);
  }
}

// acc[i] += P (16 x 8 of the walk, accumulators of tile j as they lie:
// k index t is walk row 8 j + 2t, t + 4 is 8 j + 2t + 1) times rows
// 8 j + 2t, + 1 of tile bt (dims 8 i + g) for every n8 tile i of D
template <typename E, int D>
__device__ __forceinline__ void accumulate(float (*acc)[4], const float (&p)[4], const E* bt,
                                           int j, int g, int t) {
  constexpr bool EX = Tc<D, E>::EXACT;
  const float a[4] = {p[0], p[2], p[1], p[3]};
  uint32_t ab[4], am[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) fs::tf32::split(a[e], ab[e], am[e]);
#pragma unroll
  for (int i0 = 0; i0 < D / 8; i0 += 4) {
    uint32_t bb[4][2], bm[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        terms<EX>(elem<E, D>(bt, 8 * j + 2 * t + e, 8 * (i0 + u) + g), bb[u][e], bm[u][e]);
    mma_terms<false, EX, 4>(acc + i0, ab, am, bb, bm);
  }
}

// ---------------------------------------------------------------------------
// dK / dV: 64 keys of (b, kv head), one slice of their walk
// ---------------------------------------------------------------------------

template <int D, typename E>
__device__ __forceinline__ void load_rows_stage(uint8_t* st, const TcArgs& a, int b, int hk,
                                                int rt) {
  using C = Tc<D, E>;
  constexpr int S = C::STEP;
  E* qs = reinterpret_cast<E*>(st);
  E* dos = reinterpret_cast<E*>(st + C::STEP_BYTES);
  float* lse_s = reinterpret_cast<float*>(st + 2 * C::STEP_BYTES);
  float* dlt_s = lse_s + S;
  int* pos_s = reinterpret_cast<int*>(dlt_s + S);
  const int grp = a.n_group, rows = a.t_len * grp;
  const E* q = static_cast<const E*>(a.q);
  const E* dout = static_cast<const E*>(a.dout);
  for (int idx = threadIdx.x; idx < S * C::CH; idx += TC_THREADS) {
    const int r = idx / C::CH, c = idx % C::CH, m = rt * S + r;
    const bool ok = m < rows;  // rows past the end read as zero
    const size_t off =
        (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp + m % grp) * D;
    copy_row_chunk<E, D>(qs, r, c, q + off, ok, q);
    copy_row_chunk<E, D>(dos, r, c, dout + off, ok, dout);
  }
  for (int r = threadIdx.x; r < S; r += TC_THREADS) {
    const int m = rt * S + r;
    const bool ok = m < rows;
    const size_t i = ((size_t)b * a.n_head + hk * grp + m % grp) * a.t_len + m / grp;
    fs::wg::cp_async4(lse_s + r, ok ? a.lse + i : a.lse, ok);
    fs::wg::cp_async4(dlt_s + r, ok ? a.delta + i : a.delta, ok);
    pos_s[r] = ok ? m / grp : -1;  // a padding row sees no key
  }
}

template <int D, typename E>
__device__ __forceinline__ void dkdv_block(const TcArgs& a, uint8_t* smem, int blk) {
  using C = Tc<D, E>;
  constexpr int S = C::STEP, NJ = S / 8, ND = D / 8;
  __shared__ int last_s;
  const int z = blk % a.n_split;
  blk /= a.n_split;
  const int kt = blk % a.key_tiles;
  blk /= a.key_tiles;
  const int hk = blk % a.n_kv, b = blk / a.n_kv;
  const int grp = a.n_group, rows = a.t_len * grp, k0 = kt * BW;
  // the walk: row tiles [rt0, n_rt), the first holding packed row k0 * G
  // (position k0, the first that sees a key of the tile); slice z takes
  // `per` of them
  const int n_rt = (rows + S - 1) / S, rt0 = k0 * grp / S;
  const int n_active = (n_rt - rt0 + a.per - 1) / a.per;
  if (z >= n_active) return;
  const int rt_lo = rt0 + z * a.per, n_steps = min(a.per, n_rt - rt_lo);

  E* ks = reinterpret_cast<E*>(smem);
  E* vs = reinterpret_cast<E*>(smem + C::TILE);
  uint8_t* ring = smem + 2 * C::TILE;
  {
    const E* k = static_cast<const E*>(a.k);
    const E* v = static_cast<const E*>(a.v);
    for (int idx = threadIdx.x; idx < BW * C::CH; idx += TC_THREADS) {
      const int r = idx / C::CH, c = idx % C::CH, j = k0 + r;
      const bool ok = j < a.t_len;  // keys past the end read as zero
      const size_t off = (((size_t)b * a.t_len + j) * a.n_kv + hk) * D;
      copy_row_chunk<E, D>(ks, r, c, k + off, ok, k);
      copy_row_chunk<E, D>(vs, r, c, v + off, ok, v);
    }
    load_rows_stage<D, E>(ring, a, b, hk, rt_lo);
    fs::wg::cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = 16 * warp;  // the warp's first key in the tile
  // this lane's keys: kw + g and kw + g + 8, and whether each is a real one
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + kw + g + 8 * h;
    key_ok[h] = key[h] < a.t_len && a.kvalid[(size_t)b * a.t_len + key[h]] != 0;
  }
  const float c2 = a.scale * kLog2e;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int n = 0; n < n_steps; ++n) {
    fs::tf32::cp_async_wait<0>();  // step n's rows (and K, V) have landed ...
    __syncthreads();               // ... for every thread, and step n - 1's are read
    if (n + 1 < n_steps) {
      load_rows_stage<D, E>(ring + ((n + 1) & 1) * C::STAGE, a, b, hk, rt_lo + n + 1);
      fs::wg::cp_async_commit();
    }
    const uint8_t* st = ring + (n & 1) * C::STAGE;
    const E* qs = reinterpret_cast<const E*>(st);
    const E* dos = reinterpret_cast<const E*>(st + C::STEP_BYTES);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * C::STEP_BYTES);
    const float* dlt_s = lse_s + S;
    const int* pos_s = reinterpret_cast<const int*>(dlt_s + S);

    // S^T = K Q^T and dP^T = V dO^T: key g (g + 8) of the warp, walk rows
    // 8 j + 2t, + 1
    float sc[NJ][4], dp[NJ][4];
    scores<E, D, NJ>(sc, ks, qs, dp, vs, dos, kw + g, g, t);
    // P^T = exp(S^T scale - lse) where visible, else 0;
    // dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool vis = key_ok[h] && key[h] <= pos_s[r];
        const float p = vis ? exp2f(fmaf(sc[j][e], c2, -lse_s[r] * kLog2e)) : 0.f;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dlt_s[r]) * a.scale;
      }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      accumulate<E, D>(dv, sc[j], dos, j, g, t);
      accumulate<E, D>(dk, dp[j], qs, j, g, t);
    }
  }

  // dk[i][e], dv[i][e]: key kw + g + 8 (e / 2), dim 8 i + 2t + e % 2
  E* dkg = static_cast<E*>(a.dk);
  E* dvg = static_cast<E*>(a.dv);
  if (n_active == 1) {  // the tile's one slice: dK, dV
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= a.t_len) continue;
      const size_t o = (((size_t)b * a.t_len + key[h]) * a.n_kv + hk) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        store2(dkg + o + 8 * i, dk[i][2 * h], dk[i][2 * h + 1]);
        store2(dvg + o + 8 * i, dv[i][2 * h], dv[i][2 * h + 1]);
      }
    }
    return;
  }
  constexpr int PS = 2 * BW * D;  // floats of one partial: dK, then dV
  const size_t tile_id = ((size_t)b * a.n_kv + hk) * a.key_tiles + kt;
  float* part = a.work + (tile_id * a.n_split + z) * PS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kw + g + 8 * h;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      *reinterpret_cast<float2*>(part + r * D + 8 * i + 2 * t) =
          make_float2(dk[i][2 * h], dk[i][2 * h + 1]);
      *reinterpret_cast<float2*>(part + BW * D + r * D + 8 * i + 2 * t) =
          make_float2(dv[i][2 * h], dv[i][2 * h + 1]);
    }
  }
  // the last of the tile's active slices sums their partials in slice
  // order and puts the counter back to 0
  __syncthreads();  // the block's partial is stored: publish it
  if (threadIdx.x == 0)
    last_s = fs::atomic_add_acq_rel(a.counters + tile_id, 1) == n_active - 1;
  __syncthreads();
  if (!last_s) return;
  const float* parts = a.work + tile_id * a.n_split * PS;
  for (int idx = threadIdx.x; idx < PS / 4; idx += TC_THREADS) {
    const int f = 4 * idx, r = (f % (BW * D)) / D, c = f % D, j = k0 + r;
    if (j >= a.t_len) continue;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(parts + f));
    for (int zz = 1; zz < n_active; ++zz) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(parts + zz * PS + f));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4((f < BW * D ? dkg : dvg) + (((size_t)b * a.t_len + j) * a.n_kv + hk) * D + c, acc);
  }
  if (threadIdx.x == 0) a.counters[tile_id] = 0;
}

// ---------------------------------------------------------------------------
// dQ: 64 packed rows of (b, kv head), every key tile up to their causal limit
// ---------------------------------------------------------------------------

template <int D, typename E>
__device__ __forceinline__ void load_keys_stage(uint8_t* st, const TcArgs& a, int b, int hk,
                                                int k0) {
  using C = Tc<D, E>;
  constexpr int S = C::STEP;
  E* ks = reinterpret_cast<E*>(st);
  E* vs = reinterpret_cast<E*>(st + C::STEP_BYTES);
  int* kv_s = reinterpret_cast<int*>(st + 2 * C::STEP_BYTES);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  for (int idx = threadIdx.x; idx < S * C::CH; idx += TC_THREADS) {
    const int r = idx / C::CH, c = idx % C::CH, j = k0 + r;
    const bool ok = j < a.t_len;
    const size_t off = (((size_t)b * a.t_len + j) * a.n_kv + hk) * D;
    copy_row_chunk<E, D>(ks, r, c, k + off, ok, k);
    copy_row_chunk<E, D>(vs, r, c, v + off, ok, v);
  }
  const int* src = a.kvalid + (size_t)b * a.t_len;
  for (int r = threadIdx.x; r < S; r += TC_THREADS)  // 0 past the end: masked
    fs::wg::cp_async4(kv_s + r, k0 + r < a.t_len ? src + k0 + r : src, k0 + r < a.t_len);
}

template <int D, typename E>
__device__ __forceinline__ void dq_block(const TcArgs& a, uint8_t* smem, int blk) {
  using C = Tc<D, E>;
  constexpr int S = C::STEP, NJ = S / 8, ND = D / 8;
  const int rt = blk % a.q_tiles;
  blk /= a.q_tiles;
  const int hk = blk % a.n_kv, b = blk / a.n_kv;
  const int grp = a.n_group, rows = a.t_len * grp;
  const int m0 = rt * BW, m_last = min(m0 + BW, rows) - 1;
  const int n_tiles = (m_last / grp + S) / S;  // up to the last row's causal limit

  E* qs = reinterpret_cast<E*>(smem);
  E* dos = reinterpret_cast<E*>(smem + C::TILE);
  uint8_t* ring = smem + 2 * C::TILE;
  const E* q = static_cast<const E*>(a.q);
  const E* dout = static_cast<const E*>(a.dout);
  {
    for (int idx = threadIdx.x; idx < BW * C::CH; idx += TC_THREADS) {
      const int r = idx / C::CH, c = idx % C::CH, m = m0 + r;
      const bool ok = m < rows;
      const size_t off =
          (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp + m % grp) * D;
      copy_row_chunk<E, D>(qs, r, c, q + off, ok, q);
      copy_row_chunk<E, D>(dos, r, c, dout + off, ok, dout);
    }
    load_keys_stage<D, E>(ring, a, b, hk, 0);
    fs::wg::cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the block
  // this lane's rows wr + g and wr + g + 8: position (-1 past the end: no
  // key visible), head, lse (times log2 e) and delta
  int pos[2], head[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wr + g + 8 * h;
    const bool ok = m < rows;
    pos[h] = ok ? m / grp : -1;
    head[h] = hk * grp + m % grp;
    const size_t i = ((size_t)b * a.n_head + head[h]) * a.t_len + (ok ? pos[h] : 0);
    lse2[h] = ok ? a.lse[i] * kLog2e : 0.f;
    dlt[h] = ok ? a.delta[i] : 0.f;
  }
  const float c2 = a.scale * kLog2e;

  float dq[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    fs::tf32::cp_async_wait<0>();
    __syncthreads();
    if (n + 1 < n_tiles) {
      load_keys_stage<D, E>(ring + ((n + 1) & 1) * C::STAGE, a, b, hk, (n + 1) * S);
      fs::wg::cp_async_commit();
    }
    const uint8_t* st = ring + (n & 1) * C::STAGE;
    const E* ks = reinterpret_cast<const E*>(st);
    const E* vs = reinterpret_cast<const E*>(st + C::STEP_BYTES);
    const int* kv_s = reinterpret_cast<const int*>(st + 2 * C::STEP_BYTES);
    const int k0 = n * S;

    // S = Q K^T and dP = dO V^T: row g (g + 8) of the warp, keys
    // k0 + 8 j + 2t, + 1
    float sc[NJ][4], dp[NJ][4];
    scores<E, D, NJ>(sc, qs, ks, dp, dos, vs, wr + g, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool vis = kv_s[jj] != 0 && k0 + jj <= pos[h];
        const float p = vis ? exp2f(fmaf(sc[j][e], c2, -lse2[h])) : 0.f;
        sc[j][e] = p * (dp[j][e] - dlt[h]) * a.scale;  // dS
      }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < NJ; ++j) accumulate<E, D>(dq, sc[j], ks, j, g, t);
  }

  // dq[i][e]: row wr + g + 8 (e / 2), dim 8 i + 2t + e % 2
  E* dqg = static_cast<E*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pos[h] < 0) continue;
    E* o = dqg + (((size_t)b * a.t_len + pos[h]) * a.n_head + head[h]) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < ND; ++i) store2(o + 8 * i, dq[i][2 * h], dq[i][2 * h + 1]);
  }
}

// blocks [0, key_tiles * Hkv * B * n_split) are dK/dV slices, the rest dQ
// row tiles; the two kinds run side by side
template <int D, typename E>
__global__ void __launch_bounds__(TC_THREADS, 2)
    train_bwd_tf32_kernel(const __grid_constant__ TcArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_dkdv = a.key_tiles * a.n_kv * a.batch * a.n_split;
  if ((int)blockIdx.x < n_dkdv)
    dkdv_block<D, E>(a, smem, blockIdx.x);
  else
    dq_block<D, E>(a, smem, blockIdx.x - n_dkdv);
}

template <int D, typename E>
int launch_bwd_tf32(TcArgs a, cudaStream_t stream) {
  using C = Tc<D, E>;
  const int rows = a.t_len * a.n_group;
  a.key_tiles = (a.t_len + BW - 1) / BW;
  a.q_tiles = (rows + BW - 1) / BW;
  // every row tile of the longest walk (key tile 0's) lies in a slice
  if (a.n_split < 1 || a.per < 1 ||
      (long long)a.n_split * a.per < (rows + C::STEP - 1) / C::STEP ||
      (a.n_split > 1 && (a.work == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        train_bwd_tf32_kernel<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const long long blocks = (long long)a.n_kv * a.batch * (a.key_tiles * a.n_split + a.q_tiles);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  train_bwd_tf32_kernel<D, E><<<(unsigned)blocks, TC_THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int D>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    train_fwd_wgmma_kernel(const fs::attn::Args a) {
  fs::attn::attn_fwd_wgmma<fs::attn::Mask::kKeyValid, D>(a);
}

template <int D>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    train_bwd_dkdv_wgmma_kernel(const fs::attn::BwdArgs a) {
  fs::attn::attn_bwd_dkdv_wgmma<D>(a);
}

template <int D>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    train_bwd_dq_wgmma_kernel(const fs::attn::BwdArgs a) {
  fs::attn::attn_bwd_dq_wgmma<D>(a);
}

bool bad_shape(int batch, int t_len, int n_head, int n_kv) {
  return batch < 1 || t_len < 1 || n_kv < 1 || n_head % n_kv != 0;
}

}  // namespace

extern "C" int fs_flash_train_fwd(const void* q, const void* k, const void* v,
                                  const void* kvalid, void* out, void* lse,
                                  int batch, int t_len, int n_head, int n_kv,
                                  int head_dim, int dtype, float scale,
                                  void* stream) {
  if (bad_shape(batch, t_len, n_head, n_kv)) return (int)cudaErrorInvalidValue;
  const int* kv = static_cast<const int*>(kvalid);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16 && head_dim == 32)  // "bf16_tf32"
    return fs::attn32::run_train(q, k, v, kv, out, l, batch, t_len, n_head, n_kv, head_dim,
                                 true, scale, s);
  if (dtype == fs::kBFloat16) {  // "wgmma"
    fs::attn::Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.mask = kv;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.lse = l;
    a.t_len = t_len;
    a.n_head = n_head;
    a.n_kv = n_kv;
    a.scale = scale;
    if (head_dim == 128)
      return fs::attn::launch<128>(train_fwd_wgmma_kernel<128>, a, batch, s);
    if (head_dim == 64)
      return fs::attn::launch<64>(train_fwd_wgmma_kernel<64>, a, batch, s);
  }
  if (dtype == fs::kFloat32)  // "fp32_tc"
    return fs::attn32::run_train(q, k, v, kv, out, l, batch, t_len, n_head, n_kv, head_dim,
                                 false, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The routes "fp32_tc" and "bf16_tf32" split each 64-key tile's walk into
// n_split slices of tiles_per_slice row tiles (`ops/flash_train.py:
// train_bwd_plan`); with n_split > 1 they need work, n_split fp32 partials
// of 2 * 64 * D floats per key tile (ceil(T / 64) * Hkv * B tiles), and
// counters, one int32 per key tile, all 0 on entry (the kernel leaves them
// 0). The "wgmma" route reads none of the four.
extern "C" int fs_flash_train_bwd(const void* q, const void* k, const void* v,
                                  const void* kvalid, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  void* dk, void* dv, void* work, void* counters,
                                  int n_split, int tiles_per_slice, int batch,
                                  int t_len, int n_head, int n_kv, int head_dim,
                                  int dtype, float scale, void* stream) {
  if (bad_shape(batch, t_len, n_head, n_kv)) return (int)cudaErrorInvalidValue;
  const int* kv = static_cast<const int*>(kvalid);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16 && head_dim != 32) {  // "wgmma"
    fs::attn::BwdArgs a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.dout = static_cast<const __nv_bfloat16*>(dout);
    a.kvalid = kv;
    a.lse = l;
    a.delta = dl;
    a.dq = static_cast<__nv_bfloat16*>(dq);
    a.dk = static_cast<__nv_bfloat16*>(dk);
    a.dv = static_cast<__nv_bfloat16*>(dv);
    a.t_len = t_len;
    a.n_head = n_head;
    a.n_kv = n_kv;
    a.scale = scale;
    if (head_dim == 128)
      return fs::attn::launch_bwd<128>(train_bwd_dkdv_wgmma_kernel<128>,
                                       train_bwd_dq_wgmma_kernel<128>, a, batch, s);
    if (head_dim == 64)
      return fs::attn::launch_bwd<64>(train_bwd_dkdv_wgmma_kernel<64>,
                                      train_bwd_dq_wgmma_kernel<64>, a, batch, s);
    return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv)})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  TcArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.kvalid = kv;
  a.lse = l;
  a.delta = dl;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  a.t_len = t_len;
  a.n_head = n_head;
  a.n_kv = n_kv;
  a.n_group = n_head / n_kv;
  a.batch = batch;
  a.n_split = n_split;
  a.per = tiles_per_slice;
  a.scale = scale;
  if (dtype == fs::kBFloat16)  // "bf16_tf32", D = 32
    return launch_bwd_tf32<32, __nv_bfloat16>(a, s);
  if (dtype == fs::kFloat32) {  // "fp32_tc"
    if (head_dim == 128) return launch_bwd_tf32<128, float>(a, s);
    if (head_dim == 64) return launch_bwd_tf32<64, float>(a, s);
    if (head_dim == 32) return launch_bwd_tf32<32, float>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// blocks of each bf16 backward kernel that one SM holds at once, at
// `head_dim`; returns the CUDA error code
extern "C" int fs_flash_train_bwd_occupancy(int head_dim, int* dkdv, int* dq) {
  if (head_dim == 128)
    return fs::attn::bwd_blocks_per_sm<128>(train_bwd_dkdv_wgmma_kernel<128>,
                                            train_bwd_dq_wgmma_kernel<128>, dkdv, dq);
  if (head_dim == 64)
    return fs::attn::bwd_blocks_per_sm<64>(train_bwd_dkdv_wgmma_kernel<64>,
                                           train_bwd_dq_wgmma_kernel<64>, dkdv, dq);
  return (int)cudaErrorInvalidValue;
}
