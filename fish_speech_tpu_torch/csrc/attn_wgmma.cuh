// Causal GQA attention forward on the Hopper tensor cores (wgmma): one
// mainloop behind three kernels that differ only in their key mask and
// where K/V come from,
//  * train_fwd_wgmma_kernel (flash_train.cu), Mask::kKeyValid: key j is
//    visible to query i iff j <= i and kvalid[b, j] != 0; writes O and the
//    row logsumexp lse = m + log(l) (the TPU kernel is _fwd_kernel of
//    fish_speech_tpu/ops/pallas_attention_train.py);
//  * prefill_wgmma_kernel (flash_prefill.cu), Mask::kOffset: key j is
//    visible iff j <= i and j >= offsets[b]; writes O (the TPU kernel is
//    _prefill_kernel of fish_speech_tpu/ops/pallas_attention.py);
//  * suffix_wgmma_kernel (flash_prefill.cu), Mask::kSuffix: the prefill
//    extended to a prefix-cache hit's suffix (dual_ar.prefill_suffix): query
//    i sits at position start + i, with start read from device memory (one
//    CUDA graph serves every start), K/V are one layer of the stacked cache
//    (row stride S, keys [0, start + T) read), and key j is visible iff
//    j <= start + i. With KV8 the cache is int8: each K/V tile lands by
//    cp.async in an int8 staging ring, goes to bf16 exactly in shared
//    memory (|x| <= 127), ks scales the columns of S = Q K^T and vs the
//    columns of P before P V, while l sums the unscaled p: the folding of
//    fish_speech_tpu/ops/attention.py:gqa_attention_kv8 (no Pallas kernel
//    there; JAX runs an einsum over the cache).
// Masked scores are the finite fs::kMaskedScore and keys past T get -inf,
// so a row with no visible key averages V over every key the block walks.
//
// What bounds it on the H100: 4 * D operations per visible (query, key)
// pair and head against 2 bytes per element of q, k, v and O, about 150
// operations a byte at T = 1024 (H = 32, Hkv = 8, D = 128), so the bf16
// tensor cores bound it (989 TFLOP/s), which only wgmma reaches.
//
// Design. bf16 q/k/v in the model's (B, T, H, D) layout, D in {64, 128}.
// * A block of 256 threads owns 128 query rows of one head: two
//   warpgroups of 64 rows. The grid is (H, B, ceil(T / 128)): the G heads
//   that share a KV head are neighbours, so their K/V reads meet in L2,
//   and the query tiles run from the last (most keys) to the first, so
//   the causal tail does not leave the card idle.
// * Shared memory (128-byte swizzle, wgmma.cuh): the Q tile (32 KB at
//   D = 128) and three stages of 64-key K and V tiles (16 KB each) and of
//   their key-valid flags, loaded with cp.async, zero-filled past T
//   (0 * V stays finite). Tile j + 1 is copied while tile j's K and tile
//   j - 1's V are read; one barrier per tile.
// * S = Q K^T: D/16 wgmma.m64n64k16, both operands from shared memory,
//   both K-major (rows are D-contiguous), fp32 accumulators in registers.
// * Mask (only on tiles that need one: the diagonal, the ragged end, a
//   tile with an invalid key or before the offset) and the online softmax
//   in registers: each thread holds 2 rows x 16 columns of S, the row max
//   is reduced over the 4 threads of a quad; m and l are fp32.
// * O += P V: P = rn_bf16(exp(s - m_running)), unnormalised, is wgmma's
//   register A operand: the accumulator layout of S is the A-fragment
//   layout of a k16 slice, so no shuffle. V (64 keys x D) is the B operand
//   from shared memory, MN-major (D is N and contiguous): transpose-B and
//   the MN-major descriptor. O (64 x D fp32 per warpgroup) stays in
//   registers and is rescaled by exp(m_old - m_new) per tile.
// * Software pipeline inside a warpgroup: iteration j issues S of tile j
//   and then P V of tile j - 1, waits for S only (wait_group 1), and runs
//   tile j's mask and softmax while P V runs on the tensor cores; it then
//   retires P V, rescales O and only then packs tile j's P (kept in fp32
//   in S's registers meanwhile) into the bf16 fragments the P V in flight
//   read. The last tile's P V follows the walk; on tile 0 the P V adds
//   P = 0, so no branch splits a wgmma group.
// * l sums the fp32 p (before their rounding to bf16); the epilogue
//   writes O / l. The TPU kernels round the normalised P to bf16 instead:
//   both put one bf16 rounding (2^-9 relative) on each weight.
// * No register of a wgmma in flight is written before the wait that
//   retires it, and every descriptor and fragment is built before the
//   fence, so ptxas keeps the wgmmas asynchronous (C7513). One block per
//   SM (about 130 KB of shared memory and up to 255 registers a thread).
//
// The KV8 staging costs a second barrier per tile (the bf16 tile must be
// whole before S reads it) and 34 KB more shared memory (D = 128).
//
// Left for later: TMA with mbarriers, a producer warp beside ping-pong
// consumer warpgroups (softmax of one overlapping the wgmmas of the
// other), 128-key tiles.

#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace fs {
namespace attn {

constexpr int BQ = 128;      // query rows per block (2 warpgroups x 64)
constexpr int BK = 64;       // keys per tile
constexpr int NST = 3;       // K/V stages: tile j + 1 lands, j is read, j - 1's V too
constexpr int THREADS = 256;
constexpr float kLog2e = 1.4426950408889634f;

enum class Mask { kKeyValid, kOffset, kSuffix };

struct Args {
  const __nv_bfloat16* q;  // (B, T, H, D)
  const __nv_bfloat16* k;  // (B, T, Hkv, D); kSuffix: a cache layer (B, S, Hkv, D)
  const __nv_bfloat16* v;
  const int* mask;         // kKeyValid: kvalid (B, T); kOffset: offsets (B,);
                           // kSuffix: start (1,)
  __nv_bfloat16* out;      // (B, T, H, D)
  float* lse;              // (B, H, T), kKeyValid only
  int t_len, n_head, n_kv;
  float scale;
  int kv_seq = 0;          // kSuffix: S, the cache's row stride in keys
  const int8_t* k8 = nullptr;  // KV8: the int8 cache layer (B, S, Hkv, D)
  const int8_t* v8 = nullptr;
  const __nv_bfloat16* ks = nullptr;  // KV8: scales (B, S, Hkv)
  const __nv_bfloat16* vs = nullptr;
};

template <int D, bool KV8 = false>
struct Layout {
  static constexpr int DB = D / 64;              // 64-column blocks of a row
  static constexpr int Q_BLOCK = BQ * 128;       // a column block of the Q tile
  static constexpr int KV_BLOCK = BK * 128;      // a column block of a K/V tile
  static constexpr int KV_TILE = DB * KV_BLOCK;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + DB * Q_BLOCK;    // [stage] K tiles
  static constexpr int V_OFF = K_OFF + NST * KV_TILE;   // [stage] V tiles
  static constexpr int M_OFF = V_OFF + NST * KV_TILE;   // [stage][BK] kvalid
  static constexpr int SC_OFF = M_OFF + NST * BK * 4;   // KV8: [stage][ks | vs] fp32
  static constexpr int I8_TILE = BK * D;                // an int8 K or V tile
  static constexpr int I8_OFF = SC_OFF + (KV8 ? NST * 2 * BK * 4 : 0);  // [2][K, V]
  static constexpr int SMEM = 1024 + I8_OFF + (KV8 ? 4 * I8_TILE : 0);  // + alignment slack
};

// O += P V for one 64-key tile: P (64 x 64 bf16) in A fragments, V from the
// MN-major descriptors of its k16 steps
template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                         const uint64_t (&dv)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128) {
      wg::wgmma_m64n128k16_rs_tb(o, p[kk], dv[kk]);
    } else {
      wg::wgmma_m64n64k16_rs_tb(o, p[kk], dv[kk]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of head hx of a (B, seq, Hx, D) tensor into DB
// stacked 128-byte-swizzled blocks of ROWS rows; rows at or past `limit`
// (default: seq) read as 0
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* src,
                                          int b, int row0, int hx, int n_hx,
                                          int seq, int limit = -1) {
  if (limit < 0) limit = seq;
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool valid = row < limit;
    const __nv_bfloat16* s = src + (((size_t)b * seq + row) * n_hx + hx) * D + 8 * c;
    wg::cp_async16(dst + (c / 8) * (ROWS * 128) + wg::sw128(r, c % 8),
                   valid ? s : src, valid);
  }
}

// KV8: BK int8 rows of head hx of a (B, seq, Hx, D) cache layer into a
// plain (BK, D) staging tile; rows at or past `limit` read as 0
template <int D>
__device__ __forceinline__ void load_tile_i8(uint8_t* dst, const int8_t* src, int b,
                                             int row0, int hx, int n_hx, int seq,
                                             int limit) {
  constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
  static_assert(BK * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < BK * CH / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool valid = row < limit;
    const int8_t* s = src + (((size_t)b * seq + row) * n_hx + hx) * D + 16 * c;
    wg::cp_async16(dst + r * D + 16 * c, valid ? s : src, valid);
  }
}

// KV8: a staged int8 tile into the swizzled bf16 layout of load_tile, exact
template <int D>
__device__ __forceinline__ void convert_tile_i8(uint8_t* dst, const uint8_t* src) {
  constexpr int CH = D / 16;
#pragma unroll
  for (int it = 0; it < BK * CH / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / CH, c = idx % CH;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * D + 16 * c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)x[2 * e], (float)x[2 * e + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // bf16 chunk 2c + h: int8 columns 16c + 8h ..
      const int cc = 2 * c + h;
      *reinterpret_cast<uint4*>(dst + (cc / 8) * (BK * 128) + wg::sw128(r, cc % 8)) =
          make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
    }
  }
}

template <Mask M, int D, bool KV8 = false>
__device__ __forceinline__ void attn_fwd_wgmma(const Args& a) {
  static_assert(!KV8 || M == Mask::kSuffix, "an int8 cache is a suffix's");
  using L = Layout<D, KV8>;
  constexpr int KS = D / 16;  // k16 steps of S = Q K^T
  constexpr int NO = D / 2;   // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* kv_s = reinterpret_cast<int*>(sm + L::M_OFF);
  float* sc_s = reinterpret_cast<float*>(sm + L::SC_OFF);  // KV8 scales

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int t_len = a.t_len;
  const int hk = h / (a.n_head / a.n_kv);
  const int off = M == Mask::kOffset ? a.mask[b] : 0;
  // kSuffix: query i sits at diag + i and keys [0, lim) exist
  const int diag = M == Mask::kSuffix ? a.mask[0] : 0;
  const int lim = diag + t_len;
  const int seq = M == Mask::kSuffix ? a.kv_seq : t_len;

  // Keys a run of rows [first, last] walks: up to the causal limit of its
  // last row, or all T where a row lies before its offset (it sees no key
  // and averages every key, as the TPU kernel gives it).
  auto kv_tiles = [&](int first, int last) {
    const int end = (M == Mask::kOffset && first < off) ? t_len : diag + last + 1;
    return (end + BK - 1) / BK;
  };
  const int n_tiles = kv_tiles(q0, min(q0 + BQ, t_len) - 1);
  const int r0 = q0 + 64 * wgi;  // this warpgroup's first row
  const int my_tiles = r0 < t_len ? kv_tiles(r0, min(r0 + 64, t_len) - 1) : 0;

  // K, V and the key-valid flags (0 past T) of tile j into stage j % NST;
  // KV8: the int8 tiles into staging slot j % 2 and the tile's scales into
  // `sc_next` (thread t < BK: ks of key t, BK <= t < 2 BK: vs of key t - BK)
  float sc_next = 0.f;
  auto load_kv = [&](int j) {
    const int st = j % NST;
    if constexpr (KV8) {
      uint8_t* stage8 = sm + L::I8_OFF + 2 * (j % 2) * L::I8_TILE;
      load_tile_i8<D>(stage8, a.k8, b, j * BK, hk, a.n_kv, seq, lim);
      load_tile_i8<D>(stage8 + L::I8_TILE, a.v8, b, j * BK, hk, a.n_kv, seq, lim);
      if (tid < 2 * BK) {
        const int key = j * BK + tid % BK;
        const __nv_bfloat16* sp = tid < BK ? a.ks : a.vs;
        sc_next = key < lim ? __bfloat162float(sp[((size_t)b * seq + key) * a.n_kv + hk])
                            : 0.f;
      }
    } else {
      load_tile<D, BK>(sm + L::K_OFF + st * L::KV_TILE, a.k, b, j * BK, hk, a.n_kv, seq, lim);
      load_tile<D, BK>(sm + L::V_OFF + st * L::KV_TILE, a.v, b, j * BK, hk, a.n_kv, seq, lim);
    }
    if (M == Mask::kKeyValid && tid < BK) {
      const int key = j * BK + tid;
      const bool ok = key < t_len;
      wg::cp_async4(kv_s + st * BK + tid, ok ? a.mask + (size_t)b * t_len + key : a.mask, ok);
    }
  };

  load_tile<D, BQ>(sm + L::Q_OFF, a.q, b, q0, h, a.n_head, t_len);
  load_kv(0);
  wg::cp_async_commit();

  float s[32], o[NO];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_g = r0 + 16 * warp + g;  // this thread's rows: row_g, row_g + 8
  // P of the tile before, bf16: the operand of its P V, in flight during
  // this tile's softmax
  uint32_t pc[4][4] = {};

  // V descriptors of the tile in `stage`, built before the wgmma fence
  auto v_descs = [&](int stage, uint64_t (&dv)[4]) {
    const uint32_t va = wg::smem_u32(sm + L::V_OFF + stage * L::KV_TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dv[kk] = wg::sw128_desc_mn(va + kk * 16 * 128, L::KV_BLOCK);
      asm volatile("" : "+l"(dv[kk]));
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pc[kk][r]));
    }
  };

  for (int j = 0; j < n_tiles; ++j) {
    // tile j - 1's V; on tile 0, P V adds P = 0 times tile 0's (finite) V,
    // so that every iteration runs the same wgmma groups
    const int k0 = j * BK, st = j % NST, sv = j > 0 ? (j - 1) % NST : 0;
    wg::cp_async_wait<0>();
    // tile j is in place for every thread, and both warpgroups have retired
    // every read of tile j - 2's stage, which tile j + 1 now takes
    __syncthreads();
    if constexpr (KV8) {
      // tile j's int8 staging into its bf16 stage (tile j - 3's, retired),
      // its scales into shared memory; the fence makes the generic stores
      // visible to wgmma's async proxy, the barrier the tile whole
      const uint8_t* stage8 = sm + L::I8_OFF + 2 * (j % 2) * L::I8_TILE;
      convert_tile_i8<D>(sm + L::K_OFF + st * L::KV_TILE, stage8);
      convert_tile_i8<D>(sm + L::V_OFF + st * L::KV_TILE, stage8 + L::I8_TILE);
      if (tid < 2 * BK) sc_s[st * 2 * BK + tid] = sc_next;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (j + 1 < n_tiles) load_kv(j + 1);
    wg::cp_async_commit();
    if (j > my_tiles || my_tiles == 0) continue;  // past this warpgroup's limit
    uint64_t dv[4];
    v_descs(sv, dv);
    if (j == my_tiles) {  // this warpgroup's last P V
      wg::fence_regs(o);
      wg::wgmma_fence();
      pv_wgmma<D>(o, pc, dv);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(o);
      continue;
    }

    // S = Q K^T of tile j, then P V of tile j - 1, both in flight; every
    // descriptor is built before the wgmma fence
    const uint32_t qa = wg::smem_u32(sm + L::Q_OFF + wgi * 64 * 128);
    const uint32_t ka = wg::smem_u32(sm + L::K_OFF + st * L::KV_TILE);
    uint64_t dq[KS], dk[KS];
#pragma unroll
    for (int f = 0; f < KS; ++f) {
      dq[f] = wg::sw128_desc(qa + (f / 4) * L::Q_BLOCK + (f % 4) * 32);
      dk[f] = wg::sw128_desc(ka + (f / 4) * L::KV_BLOCK + (f % 4) * 32);
      asm volatile("" : "+l"(dq[f]), "+l"(dk[f]));
    }
    wg::fence_regs(s);
    wg::fence_regs(o);
    wg::wgmma_fence();
#pragma unroll
    for (int f = 0; f < KS; ++f) wg::wgmma_m64n64k16_ss(s, dq[f], dk[f], f > 0);
    wg::wgmma_commit();
    pv_wgmma<D>(o, pc, dv);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // S is retired; P V runs under the softmax
    wg::fence_regs(s);

    // scale and mask; s[i] is row row_g + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + 2 * tq + i % 2
    bool need_mask = k0 + BK - 1 > diag + r0 || k0 + BK > lim;
    if constexpr (M == Mask::kOffset) {
      need_mask |= k0 < off;
    } else if constexpr (M == Mask::kKeyValid) {  // an invalid key (one vote per warp)
      need_mask |= !__all_sync(kFullMask, kv_s[st * BK + lane] != 0 &&
                                              kv_s[st * BK + lane + 32] != 0);
    }
    const float* scs = sc_s + st * 2 * BK;  // KV8: ks of the tile's keys, then vs
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int jj = 8 * (i / 4) + 2 * tq + i % 2, key = k0 + jj;
      float x = KV8 ? s[i] * (scs[jj] * a.scale) : s[i] * a.scale;
      if (need_mask) {
        const int row = row_g + 8 * ((i / 2) % 2);
        bool visible = key <= row + diag;
        if constexpr (M == Mask::kOffset) visible = visible && key >= off;
        if constexpr (M == Mask::kKeyValid) visible = visible && kv_s[st * BK + jj] != 0;
        x = key >= lim ? -INFINITY : (visible ? x : kMaskedScore);
      }
      s[i] = x;
    }

    // online softmax: the row max over the quad; a tile walked always has
    // a key below T, so the new max is finite
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = m[e];
#pragma unroll
      for (int i = 2 * e; i < 32; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      alpha[e] = ex2((m[e] - mx) * kLog2e);  // 0 on the first tile
      m[e] = mx;
      l[e] *= alpha[e];
    }
    // p = exp(s - m) in fp32, in place: pc is still read by the P V in
    // flight, so P reaches its bf16 fragments only after that retires
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2((s[i] - m[(i / 2) % 2]) * kLog2e);
      l[(i / 2) % 2] += s[i];
    }

    // retire P V of tile j - 1, rescale O to this tile's max, and pack P's
    // A fragments: register r of k16 step kk is row (r % 2), keys
    // 16 kk + 8 (r / 2) + 2 tq, +1: accumulators 8 kk + 2 r, +1 (KV8: the
    // columns scaled by vs)
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, jj = 8 * (i / 4) + 2 * tq;
        if constexpr (KV8) {
          pc[kk][r] = pack_bf16(s[i] * scs[BK + jj], s[i + 1] * scs[BK + jj + 1]);
        } else {
          pc[kk][r] = pack_bf16(s[i], s[i + 1]);
        }
      }
  }
  // the last tile's P V, where this warpgroup walked every tile of the block
  if (my_tiles == n_tiles) {
    uint64_t dv[4];
    v_descs((n_tiles - 1) % NST, dv);
    wg::fence_regs(o);
    wg::wgmma_fence();
    pv_wgmma<D>(o, pc, dv);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
  }

  // epilogue: l over the quad, O / l in bf16 pairs, lse = m + log(l)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(kFullMask, l[e], 1);
    l[e] += __shfl_xor_sync(kFullMask, l[e], 2);
    const int row = row_g + 8 * e;
    if (row >= t_len) continue;
    const float inv = 1.f / l[e];
    __nv_bfloat16* dst = a.out + (((size_t)b * t_len + row) * a.n_head + h) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * e;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = pack_bf16(o[i] * inv, o[i + 1] * inv);
    }
    if (M == Mask::kKeyValid && tq == 0)
      a.lse[((size_t)b * a.n_head + h) * t_len + row] = m[e] + logf(l[e]);
  }
}

// sets the kernel's shared memory and launches it on the (H, B, query
// tiles) grid; returns the CUDA error code
template <int D, bool KV8 = false, typename Kernel>
int launch(Kernel kernel, const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Layout<D, KV8>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.n_head, batch, (a.t_len + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace fs
