// fp32 attention on the tensor cores: the prefill (causal, per-row key
// offset), the prefix-cache suffix over an fp32 or int8 cache, and the
// training forward (causal, per-key valid mask, with the row logsumexp):
// routes "fp32_tc", "suffix_fp32_tc" and "suffix_kv8_fp32_tc" of
// `ops/flash_prefill.py`, launched from flash_prefill.cu's C entry points,
// and "fp32_tc" and "bf16_tf32" of `ops/flash_train.py`, launched from
// flash_train.cu's.
//
// Replaces, in fp32, the Pallas TPU kernels fish_speech_tpu/ops/
// pallas_attention.py (_prefill_kernel / flash_prefill_attention) and
// fish_speech_tpu/ops/pallas_attention_train.py (_fwd_kernel) and, for the
// suffix, the einsum over the cache of fish_speech_tpu/models/
// dual_ar.py:prefill_suffix (fish_speech_tpu/ops/attention.py:
// gqa_attention_kv8 under the int8 cache), with their semantics: key j is
// visible to query i iff offsets[b] <= j <= i (prefill), j <= start + i
// (suffix) or j <= i and kvalid[b, j] != 0 (training); masked scores are
// the finite -1e30 (a prefill row with no visible key averages V over all
// keys, as the TPU kernel gives it; a training row with none, which only
// left padding makes, has a finite output and takes a zero cotangent),
// keys past the end score -inf and read as zero. The training forward
// also writes lse = m + log(l), the fp32 row logsumexp the backward
// recomputes P from.
//
// It replaced kernels on the CUDA cores: the prefill's `prefill_kernel`
// (one block per 64 queries of one head, K/V in scalar 4-byte loads
// between two barriers, scores through shared memory with a third; the
// suffix ran on H x B blocks, each walking every key alone, and lost to
// SDPA on an H100) and the training forward's `train_fwd_kernel` (the
// same tiling, one block per (64 queries, head, batch row), fp32 FMAs from
// padded shared rows: 16 blocks at JAX's tiny training batch on 132 SMs).
//
// What bounds it: 4 D operations per visible (query, key) pair and head,
// against q, K/V and the output's bytes; at the prefill's full width (T =
// 1024, D = 128) the operations, at fp32's 67 TFLOP/s on the CUDA cores.
// The design:
// * Tensor cores in 3xTF32: each fp32 operand is big + small (tf32.cuh),
//   S = Q K^T and O = P V are each three mma.sync m16n8k8 .tf32 (big big,
//   big small, small big), fp32 sums, within ~2^-19 of fp32 products. The
//   int8 cache's K and V are integers, exact in TF32: two mmas (Q's or P's
//   two terms). ks scales the columns of S, vs those of P before P V, and
//   l sums the unscaled p (gqa_attention_kv8's folding). bf16 inputs (the
//   training forward at JAX's tiny D = 32, `train.cli --tiny`'s default
//   precision) are exact in TF32 too: S is one mma, P V two (P's terms),
//   and O is rounded to bf16 once.
// * Packed heads: packed row m of (b, kv) is position m / G of head
//   kv * G + m % G, and a block takes 64 consecutive packed rows (four
//   warps of 16), so each K/V tile is read once for the G heads of a KV
//   head.
// * A double-buffered cp.async ring of K/V tiles (BK keys: 64, or 32 at
//   D = 128 for two blocks an SM; the training forward's key-valid flags
//   ride in the same stage), one barrier a tile: tile n + 1 lands while
//   tile n is multiplied. Scores and probabilities stay in registers (an
//   mma's accumulators are the next mma's A operand once the keys are
//   numbered 2t, 2t + 1 in place of t, t + 4), with an online softmax of
//   each row over the four lanes that hold it. Tiles past the causal
//   limit of the block's last row are not walked.
// * The suffix splits its keys over Z slices (the grid's z, planned from
//   the shape alone by `ops/flash_prefill.py:suffix_plan`, so one CUDA graph
//   serves every start); each slice writes its rows' (m, l, O) to a
//   workspace and the last of a row tile's slices to finish (a
//   release/acquire counter) merges them in slice order: deterministic,
//   no atomics on data. The prefill and the training forward walk their
//   keys in one block.
// * Fragment loads are 8-byte (bf16: 4-byte) where the layout allows, and
//   the rows of Q, K and V are padded (fp32: by 8, 8 and 4 floats; int8
//   rows by 16 bytes; bf16 rows by 8 values) so that a warp's loads land on
//   distinct banks.

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

using namespace fs::wg;

constexpr int BQ = 64;        // packed query rows a block (four warps of 16)
constexpr int THREADS = 128;
constexpr int SPLIT_KEYS = 64;  // keys of the suffix plan's unit (SUFFIX_KEYS)
constexpr float kLog2e = 1.4426950408889634f;

// what a launch computes: the prefill (`mask` = offsets), the suffix
// (`mask` = start) or the training forward (`mask` = kvalid, writes lse)
enum Mode { kPrefill, kSuffix, kTrain };

// KT, the K/V element: float, int8_t (the int8 cache) or __nv_bfloat16
// (training in bf16, where q and the output are bf16 too)
template <typename KT>
using QType = std::conditional_t<std::is_same_v<KT, __nv_bfloat16>, __nv_bfloat16, float>;

template <int D, int M, typename KT>
struct Layout {
  static constexpr bool KV8 = std::is_same_v<KT, int8_t>;
  static constexpr bool BF16 = std::is_same_v<KT, __nv_bfloat16>;
  static constexpr int BK = D == 128 ? 32 : 64;  // keys a tile
  static constexpr int QSZ = sizeof(QType<KT>);
  static constexpr int ESZ = sizeof(KT);
  static constexpr int QS = D + 8;                 // Q row (elements)
  static constexpr int KS = KV8 ? D + 16 : D + 8;  // K row (elements)
  static constexpr int VS = KV8 ? D + 16 : BF16 ? D + 8 : D + 4;  // V row
  static constexpr int Q_BYTES = BQ * QS * QSZ;
  static constexpr int K_BYTES = BK * KS * ESZ;
  static constexpr int V_BYTES = BK * VS * ESZ;
  // ks, vs of the tile (int8 cache); the keys' valid flags (training)
  static constexpr int SC_BYTES = KV8 ? 2 * BK * 4 : M == kTrain ? BK * 4 : 0;
  static constexpr int STAGE = K_BYTES + V_BYTES + SC_BYTES;
  static constexpr int SMEM = Q_BYTES + 2 * STAGE;
  static_assert(SMEM <= 113 * 1024, "two blocks an SM");
  static_assert(SPLIT_KEYS % BK == 0, "a slice is whole tiles");
  static_assert(!(BF16 && M != kTrain), "bf16 is the training forward's");
};

struct Args {
  const void* q;             // (B, T, H, D): fp32, or bf16 (training in bf16)
  const void* k;             // (B, seq, Hkv, D): fp32, int8 (KV8) or bf16
  const void* v;
  const __nv_bfloat16* ks;   // KV8: (B, seq, Hkv)
  const __nv_bfloat16* vs;
  const int* mask;           // prefill: offsets (B,); suffix: start (1,); training: kvalid (B, T)
  void* out;                 // (B, T, H, D), q's dtype
  float* lse;                // training: (B, H, T)
  float* work;               // suffix, Z > 1: Z partials per row tile
  int* counters;             // one per row tile, 0 on entry and exit
  int t_len, seq, n_head, n_kv, n_group, row_tiles, tiles_per_slice;
  float scale;
};

template <int D, int M, typename KT>
__device__ __forceinline__ void load_tile(uint8_t* st, const Args& a, int b, int hk, int k0,
                                          int lim) {
  using L = Layout<D, M, KT>;
  constexpr int CH = D * L::ESZ / 16;  // 16-byte chunks of a row
  const size_t row_stride = (size_t)a.n_kv * D * L::ESZ;
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) +
                      ((size_t)b * a.seq * a.n_kv + hk) * D * L::ESZ;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) +
                      ((size_t)b * a.seq * a.n_kv + hk) * D * L::ESZ;
  for (int idx = threadIdx.x; idx < L::BK * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH, j = k0 + r;
    const bool ok = j < lim;  // keys past the end read as zero
    const size_t off = (size_t)j * row_stride + 16 * c;
    cp_async16(st + r * L::KS * L::ESZ + 16 * c, ok ? kb + off : kb, ok);
    cp_async16(st + L::K_BYTES + r * L::VS * L::ESZ + 16 * c, ok ? vb + off : vb, ok);
  }
  if constexpr (L::KV8) {
    float* sc = reinterpret_cast<float*>(st + L::K_BYTES + L::V_BYTES);
    for (int e = threadIdx.x; e < 2 * L::BK; e += THREADS) {
      const int j = k0 + e % L::BK;
      const __nv_bfloat16* src = e < L::BK ? a.ks : a.vs;
      sc[e] = j < lim ? __bfloat162float(src[((size_t)b * a.seq + j) * a.n_kv + hk]) : 0.f;
    }
  } else if constexpr (M == kTrain) {  // kvalid of the tile's keys, 0 past the end
    int* kv = reinterpret_cast<int*>(st + L::K_BYTES + L::V_BYTES);
    const int* src = a.mask + (size_t)b * a.seq;
    for (int e = threadIdx.x; e < L::BK; e += THREADS)
      cp_async4(kv + e, k0 + e < lim ? src + k0 + e : src, k0 + e < lim);
  }
}

// two adjacent elements (d, d + 1) of row r of a tile of rows `stride`
// elements long, as fp32
template <typename T>
__device__ __forceinline__ float2 pair_at(const void* tile, int r, int stride, int d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(tile)[(r * stride + d) / 2];
    return make_float2(fs::Elem<__nv_bfloat16>::lo(w), fs::Elem<__nv_bfloat16>::hi(w));
  } else if constexpr (std::is_same_v<T, int8_t>) {
    const uint16_t w =
        *reinterpret_cast<const uint16_t*>(static_cast<const uint8_t*>(tile) + r * stride + d);
    return make_float2((float)(int8_t)(w & 0xFF), (float)(int8_t)(w >> 8));
  } else {
    return *reinterpret_cast<const float2*>(static_cast<const float*>(tile) + r * stride + d);
  }
}

template <typename T>
__device__ __forceinline__ float elem_at(const void* tile, int r, int stride, int d) {
  return fs::to_float(static_cast<const T*>(tile)[r * stride + d]);
}

template <int D, int M, typename KT>
__device__ __forceinline__ float v_at(const uint8_t* st, int key, int d) {
  using L = Layout<D, M, KT>;
  const uint8_t* vt = st + L::K_BYTES;
  if constexpr (L::KV8)
    return (float)reinterpret_cast<const int8_t*>(vt)[key * L::VS + d];
  else
    return elem_at<KT>(vt, key, L::VS, d);
}

// kSuffix: `mask` is start, query i sits at start + i, and K/V are one layer
// of the cache (row stride seq); the keys of a row tile are split over the
// grid's z. Else seq == t_len and `mask` is offsets (kPrefill) or kvalid
// (kTrain).
template <int D, int M, typename KT>
__global__ void __launch_bounds__(THREADS, 2) attn_tf32_kernel(const __grid_constant__ Args a) {
  using L = Layout<D, M, KT>;
  using QT = QType<KT>;
  constexpr bool KV8 = L::KV8;
  constexpr bool Q_EXACT = L::BF16;        // q's values are TF32 values: one term
  constexpr bool K_EXACT = KV8 || L::BF16;  // so are K's and V's
  constexpr int BK = L::BK;
  constexpr int NS = BK / 8;  // n8 tiles of S
  constexpr int ND = D / 8;   // n8 tiles of O, k8 steps of S
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_s;
  QT* qs = reinterpret_cast<QT*>(smem);
  uint8_t* ring = smem + L::Q_BYTES;

  const int rt = blockIdx.x % a.row_tiles, hk = blockIdx.x / a.row_tiles;
  const int b = blockIdx.y, z = blockIdx.z, n_split = gridDim.z;
  const int grp = a.n_group, rows = a.t_len * grp;  // packed rows of (b, hk)
  const int m0 = rt * BQ, m_last = min(m0 + BQ, rows) - 1;
  const int off = M == kPrefill ? a.mask[b] : 0;
  const int diag = M == kSuffix ? a.mask[0] : 0;  // query i sits at diag + i
  const int lim = diag + a.t_len;                 // keys [0, lim) exist
  // the keys this block walks: [k_lo, k_hi)
  int k_lo = 0, k_hi, n_active = 1;
  if constexpr (M == kSuffix) {
    const int lim_rt = diag + m_last / grp + 1;  // keys the row tile sees
    const int chunk = a.tiles_per_slice * SPLIT_KEYS;
    k_lo = z * chunk;
    if (k_lo >= lim_rt) return;  // the slice lies past the row tile's keys
    n_active = (lim_rt + chunk - 1) / chunk;
    k_hi = min(k_lo + chunk, lim_rt);
  } else {
    // a prefill row before the offset sees no key and averages all T of them
    k_hi = m0 / grp < off ? a.t_len : m_last / grp + 1;
  }
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  // Q rows (zero past `rows`) and the first tile
  {
    constexpr int CH = D * L::QSZ / 16;
    const QT* q = static_cast<const QT*>(a.q);
    for (int idx = threadIdx.x; idx < BQ * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH, m = m0 + r;
      const bool ok = m < rows;
      const QT* src = q + (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp + m % grp) * D +
                      c * (16 / L::QSZ);
      cp_async16(reinterpret_cast<uint8_t*>(qs) + r * L::QS * L::QSZ + 16 * c, ok ? src : q, ok);
    }
    load_tile<D, M, KT>(ring, a, b, hk, k_lo, lim);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the block
  // this lane's rows: wr + g and wr + g + 8; the last key each sees
  int vis[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = min(m0 + wr + g + 8 * e, rows - 1) / grp;  // a padding row: the last
    vis[e] = diag + p;
  }

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int n = 0; n < n_tiles; ++n) {
    fs::tf32::cp_async_wait<0>();  // tile n (and Q) has landed ...
    __syncthreads();     // ... for every thread, and tile n - 1 is read
    if (n + 1 < n_tiles) {
      load_tile<D, M, KT>(ring + ((n + 1) & 1) * L::STAGE, a, b, hk, k_lo + (n + 1) * BK, lim);
      cp_async_commit();
    }
    const uint8_t* st = ring + (n & 1) * L::STAGE;
    const int k0 = k_lo + n * BK;

    // S = Q K^T: row g (g + 8) of the warp, keys 8 j + 2t, + 1 of tile j;
    // the k8 step's index t is dim 8 kd + 2t, t + 4 is 8 kd + 2t + 1
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < ND; ++kd) {
      const float2 q0 = pair_at<QT>(qs, wr + g, L::QS, 8 * kd + 2 * t);
      const float2 q1 = pair_at<QT>(qs, wr + g + 8, L::QS, 8 * kd + 2 * t);
      uint32_t qb[4], qm[4];
      if constexpr (Q_EXACT) {
        qb[0] = __float_as_uint(q0.x);
        qb[1] = __float_as_uint(q1.x);
        qb[2] = __float_as_uint(q0.y);
        qb[3] = __float_as_uint(q1.y);
      } else {
        fs::tf32::split(q0.x, qb[0], qm[0]);
        fs::tf32::split(q1.x, qb[1], qm[1]);
        fs::tf32::split(q0.y, qb[2], qm[2]);
        fs::tf32::split(q1.y, qb[3], qm[3]);
      }
      // K's fragments of every tile first, then each term's mmas over the
      // tiles: no mma waits on the one before (int8 or bf16 K: exact in
      // TF32, one term)
      uint32_t kb[NS][2], km[NS][2];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 kv = pair_at<KT>(st, 8 * j + g, L::KS, 8 * kd + 2 * t);
        if constexpr (K_EXACT) {
          kb[j][0] = __float_as_uint(kv.x);
          kb[j][1] = __float_as_uint(kv.y);
        } else {
          fs::tf32::split(kv.x, kb[j][0], km[j][0]);
          fs::tf32::split(kv.y, kb[j][1], km[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
        fs::tf32::mma(s[j], qb[0], qb[1], qb[2], qb[3], kb[j][0], kb[j][1]);
      if constexpr (!Q_EXACT) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
          fs::tf32::mma(s[j], qm[0], qm[1], qm[2], qm[3], kb[j][0], kb[j][1]);
      }
      if constexpr (!K_EXACT) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
          fs::tf32::mma(s[j], qb[0], qb[1], qb[2], qb[3], km[j][0], km[j][1]);
      }
    }

    // scale and mask; s[j][e] is row g + 8 (e / 2), key k0 + 8 j + 2t + e % 2
    const float* ksc = reinterpret_cast<const float*>(st + L::K_BYTES + L::V_BYTES);
    const int* kvs = reinterpret_cast<const int*>(ksc);  // training: kvalid of the tile
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * j + 2 * t + (e & 1), key = k0 + jj;
        float x = KV8 ? s[j][e] * (ksc[jj] * a.scale) : s[j][e] * a.scale;
        if (key >= lim)
          x = -INFINITY;  // no such key: weight exactly 0
        else if (key > vis[e >> 1] || key < off || (M == kTrain && kvs[jj] == 0))
          x = fs::kMaskedScore;
        s[j][e] = x;
      }
    // online softmax over the quad that holds a row; every tile has a key
    // below lim, so the new max is finite
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(fs::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(fs::kFullMask, mx, 2));
      alpha[h] = exp2f((m_run[h] - mx) * kLog2e);  // 0 on the first tile
      m_run[h] = mx;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m_run[e >> 1]) * kLog2e);
        l_run[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];

    // O += P V: P's tile j as A (k index t is key 8 j + 2t, t + 4 is
    // 8 j + 2t + 1: the accumulators as they lie), V's dims 8 i + g as B
    const float* vsc = ksc + BK;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};  // a0..a3
      if constexpr (KV8) {
        const float v0 = vsc[8 * j + 2 * t], v1 = vsc[8 * j + 2 * t + 1];
        p[0] *= v0; p[1] *= v0; p[2] *= v1; p[3] *= v1;
      }
      uint32_t pb[4], pm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) fs::tf32::split(p[e], pb[e], pm[e]);
      // four n8 tiles of O at a time: their V fragments, then each term's
      // mmas over the four
#pragma unroll
      for (int i0 = 0; i0 < ND; i0 += 4) {
        uint32_t vb[4][2], vm[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = v_at<D, M, KT>(st, 8 * j + 2 * t + e, 8 * (i0 + u) + g);
            if constexpr (K_EXACT)
              vb[u][e] = __float_as_uint(x);  // an integer or a bf16: exact in TF32
            else
              fs::tf32::split(x, vb[u][e], vm[u][e]);
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          fs::tf32::mma(o[i0 + u], pb[0], pb[1], pb[2], pb[3], vb[u][0], vb[u][1]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          fs::tf32::mma(o[i0 + u], pm[0], pm[1], pm[2], pm[3], vb[u][0], vb[u][1]);
        if constexpr (!K_EXACT) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fs::tf32::mma(o[i0 + u], pb[0], pb[1], pb[2], pb[3], vm[u][0], vm[u][1]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(fs::kFullMask, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(fs::kFullMask, l_run[h], 2);
  }
  // o[i][e]: row g + 8 (e / 2), dim 8 i + 2t + e % 2
  const size_t tile_id = ((size_t)b * a.n_kv + hk) * a.row_tiles + rt;
  constexpr int PS = BQ * (2 + D);  // floats of one partial: m, l, then O
  float* part = a.work + (tile_id * n_split + z) * PS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + g + 8 * h, m = m0 + r;
    if (n_active == 1) {  // the row tile's one slice: O / l
      if (m >= rows) continue;
      const float inv = 1.f / l_run[h];
      const int head = hk * grp + m % grp, pos = m / grp;
      QT* dst = static_cast<QT*>(a.out) + (((size_t)b * a.t_len + pos) * a.n_head + head) * D +
                2 * t;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if constexpr (L::BF16)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              fs::Elem<__nv_bfloat16>::pack(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
        else
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
      }
      if (M == kTrain && t == 0)
        a.lse[((size_t)b * a.n_head + head) * a.t_len + pos] = m_run[h] + logf(l_run[h]);
    } else if constexpr (M == kSuffix) {
      if (t == 0) {
        part[r] = m_run[h];
        part[BQ + r] = l_run[h];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)
        *reinterpret_cast<float2*>(part + 2 * BQ + r * D + 8 * i + 2 * t) =
            make_float2(o[i][2 * h], o[i][2 * h + 1]);
    }
  }
  if constexpr (M == kSuffix) {
    if (n_active == 1) return;
    // the last of the row tile's active slices merges their partials in
    // slice order and puts the counter back to 0
    __syncthreads();  // the block's partial is stored: publish it
    if (threadIdx.x == 0)
      last_s = fs::atomic_add_acq_rel(a.counters + tile_id, 1) == n_active - 1;
    __syncthreads();
    if (!last_s) return;
    const float* parts = a.work + tile_id * n_split * PS;
    float* wts = reinterpret_cast<float*>(smem);  // [n_active][BQ] weights, then [BQ] 1 / l
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      float mx = -INFINITY;
      for (int zz = 0; zz < n_active; ++zz) mx = fmaxf(mx, __ldcg(parts + zz * PS + r));
      float tot = 0.f;
      for (int zz = 0; zz < n_active; ++zz) {
        const float f = exp2f((__ldcg(parts + zz * PS + r) - mx) * kLog2e);
        wts[zz * BQ + r] = f;
        tot = fmaf(__ldcg(parts + zz * PS + BQ + r), f, tot);
      }
      wts[n_active * BQ + r] = 1.f / tot;
    }
    __syncthreads();
    float* out = static_cast<float*>(a.out);
    for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += THREADS) {
      const int r = idx / (D / 4), c = 4 * (idx % (D / 4)), m = m0 + r;
      if (m >= rows) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int zz = 0; zz < n_active; ++zz) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(parts + zz * PS + 2 * BQ + r * D + c));
        const float f = wts[zz * BQ + r];
        acc.x = fmaf(v.x, f, acc.x);
        acc.y = fmaf(v.y, f, acc.y);
        acc.z = fmaf(v.z, f, acc.z);
        acc.w = fmaf(v.w, f, acc.w);
      }
      const float inv = wts[n_active * BQ + r];
      *reinterpret_cast<float4*>(out + (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp +
                                        m % grp) * D + c) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
    if (threadIdx.x == 0) a.counters[tile_id] = 0;
  }
}

template <int D, int M, typename KT>
int launch(const Args& a, int batch, int n_split, cudaStream_t stream) {
  constexpr int smem = Layout<D, M, KT>::SMEM;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_tf32_kernel<D, M, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(a.row_tiles * a.n_kv, batch, n_split);
  attn_tf32_kernel<D, M, KT><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M, typename KT>
int launch_d(const Args& a, int head_dim, int batch, int n_split, cudaStream_t s) {
  if (head_dim == 128) return launch<128, M, KT>(a, batch, n_split, s);
  if (head_dim == 64) return launch<64, M, KT>(a, batch, n_split, s);
  if (head_dim == 32) return launch<32, M, KT>(a, batch, n_split, s);
  return (int)cudaErrorInvalidValue;
}

Args args(const void* q, const void* k, const void* v, const int* mask, void* out,
          int t_len, int seq, int n_head, int n_kv, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = out;
  a.t_len = t_len;
  a.seq = seq;
  a.n_head = n_head;
  a.n_kv = n_kv;
  a.n_group = n_head / n_kv;
  a.row_tiles = (t_len * a.n_group + BQ - 1) / BQ;
  a.scale = scale;
  return a;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

namespace fs {
namespace attn32 {

// fp32 prefill (fs_flash_prefill's "fp32_tc"): q (B, T, H, D), k/v
// (B, T, Hkv, D), offsets (B,), out (B, T, H, D); D in 32, 64, 128.
int run_prefill(const void* q, const void* k, const void* v, const int* offsets, void* out,
                int batch, int t_len, int n_head, int n_kv, int head_dim, float scale,
                cudaStream_t s) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const Args a = args(q, k, v, offsets, out, t_len, t_len, n_head, n_kv, scale);
  return launch_d<kPrefill, float>(a, head_dim, batch, 1, s);
}

// fp32 suffix (fs_flash_suffix's "suffix_fp32_tc" and
// "suffix_kv8_fp32_tc"): q (B, Ts, H, D) fp32; k/v one cache layer (B, seq,
// Hkv, D), fp32 or int8 (kv8, with ks/vs (B, seq, Hkv) bf16); start (1,);
// keys split into n_split slices of tiles_per_slice 64-key units, with
// work and counters (0 on entry) where n_split > 1.
int run_suffix(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const int* start, void* out, float* work, int* counters, int batch,
               int t_len, int n_head, int n_kv, int head_dim, int seq, bool kv8,
               int n_split, int tiles_per_slice, float scale, cudaStream_t s) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      (n_split > 1 && (work == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = args(q, k, v, start, out, t_len, seq, n_head, n_kv, scale);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.work = work;
  a.counters = counters;
  a.tiles_per_slice = tiles_per_slice;
  return kv8 ? launch_d<kSuffix, int8_t>(a, head_dim, batch, n_split, s)
             : launch_d<kSuffix, float>(a, head_dim, batch, n_split, s);
}

// training forward (fs_flash_train_fwd's "fp32_tc" and "bf16_tf32"): q
// (B, T, H, D), k/v (B, T, Hkv, D), fp32 (D in 32, 64, 128) or bf16 (D =
// 32); kvalid (B, T) int32; out (B, T, H, D) of q's dtype, lse (B, H, T)
// fp32.
int run_train(const void* q, const void* k, const void* v, const int* kvalid, void* out,
              float* lse, int batch, int t_len, int n_head, int n_kv, int head_dim, bool bf16,
              float scale, cudaStream_t s) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  Args a = args(q, k, v, kvalid, out, t_len, t_len, n_head, n_kv, scale);
  a.lse = lse;
  if (bf16)
    return head_dim == 32 ? launch<32, kTrain, __nv_bfloat16>(a, batch, 1, s)
                          : (int)cudaErrorInvalidValue;
  return launch_d<kTrain, float>(a, head_dim, batch, 1, s);
}

}  // namespace attn32
}  // namespace fs
