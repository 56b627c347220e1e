// Causal GQA training-attention backward on the Hopper tensor cores
// (wgmma), with the key-valid mask of the forward (attn_wgmma.cuh): two
// kernels, instantiated in flash_train.cu, that each write their outputs
// once (no atomics, deterministic):
//  * train_bwd_dkdv_wgmma_kernel: dK and dV;
//  * train_bwd_dq_wgmma_kernel: dQ.
// They replace the TPU kernel _bwd_kernel of
// fish_speech_tpu/ops/pallas_attention_train.py. Key j is visible to query
// i iff j <= i < T and kvalid[b, j] != 0. With lse the forward's row
// logsumexp and delta = rowsum(dO * O) (both fp32, per query):
//   P = exp(S * scale - lse) where visible, exactly 0 elsewhere;
//   dS = P (dO V^T - delta) * scale, from the fp32 P;
//   dV = sum over the G heads of P^T dO, dK = the same of dS^T Q, dQ = dS K,
// with P and dS rounded to bf16 as the matrix products' operands, as the
// TPU kernel and the plain version (ops/flash_train.py) round them; every
// sum is fp32.
//
// What bounds it on the H100: the two kernels run seven products of 2 * D
// operations per visible (query, key) pair and head (four for dK/dV, three
// for dQ; the minimal count is five, S and dP once) against 2 bytes per
// element of q, k, v, dO, dQ, dK and dV: hundreds of operations a byte at
// s2-pro's T = 1024, so the bf16 tensor cores bound it, which only wgmma
// reaches.
//
// Design. bf16 in the model's (B, T, H, D) layout, D in {64, 128}; 256
// threads a block in two warpgroups; tiles in shared memory in the
// 128-byte swizzle, loaded with cp.async by every thread (attn_wgmma.cuh's
// load_tile), zero-filled past T.
// * dK/dV: a block owns 128 keys of one KV head, 64 per warpgroup, with
//   keys on wgmma's M. The grid is (Hkv, B, key blocks), the first key
//   block (the longest walk) first. The K and V tiles stay in shared
//   memory; the block walks the G query heads of the group and, for each,
//   the 64-query tiles from the one holding its first key to T, with the
//   Q and dO tiles and their lse and delta in two cp.async stages (tile
//   j + 1 lands while tile j is used; one barrier a tile). Per tile and
//   warpgroup:
//     S^T = K Q^T and dP^T = V dO^T: 2 * D/16 wgmma.m64n64k16, both
//       operands from shared memory, K-major (rows are D-contiguous);
//     P^T and dS^T in registers, lse and delta per column from shared
//       memory, the mask only on tiles that need one, each pair of
//       columns packed to bf16 as soon as it is made (so the fp32 values
//       die as they go: at D = 128 the kernel needs 255 registers; ptxas
//       spilled 40 bytes when it packed after the whole tile, and 60 for
//       the mask below without its shared `ok`);
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the accumulator layout of
//       S^T is the A-fragment layout of its k16 slices (wgmma.cuh), so
//       no shuffle; dO and Q are the B operand read MN-major (D is N and
//       contiguous) through the transpose-B flag, from the same tiles that
//       were K-major B operands just before.
//   dK and dV stay in fp32 registers through the whole walk (64 + 64 a
//   thread at D = 128) and are written once in bf16. A warpgroup whose
//   keys all lie after a query tile skips it.
// * dQ: the forward's structure with queries on M: a block owns 128 query
//   rows of one head (64 per warpgroup), the grid is (H, B, query blocks),
//   the last block (the most keys) first; Q and dO stay in shared memory,
//   64-key K and V tiles and their key-valid flags stream through two
//   cp.async stages. Per key tile: S = Q K^T and dP = dO V^T (K and V
//   K-major), P and dS with the row's lse and delta in registers, then
//   dQ += bf16(dS) K (K read MN-major). dQ is written once in bf16.
// * Every fragment and each tile's descriptor is built before the wgmma
//   fence of its group (a k16 step adds a constant to the descriptor), and
//   every group is retired before its registers are written again, so
//   ptxas keeps the wgmmas asynchronous (C7513). One block per
//   SM (about 130 KB of shared memory; up to 255 registers a thread).
//
// Left for later: overlapping a tile's dK/dV products with the next tile's
// S^T/dP^T (the registers are at the limit at D = 128), a producer warp
// with setmaxnreg, TMA.

#pragma once

#include "attn_wgmma.cuh"

namespace fs {
namespace attn {

constexpr int NSB = 2;  // cp.async stages of the streamed tiles

struct BwdArgs {
  const __nv_bfloat16* q;     // (B, T, H, D)
  const __nv_bfloat16* k;     // (B, T, Hkv, D)
  const __nv_bfloat16* v;     // (B, T, Hkv, D)
  const __nv_bfloat16* dout;  // (B, T, H, D)
  const int* kvalid;          // (B, T)
  const float* lse;           // (B, H, T)
  const float* delta;         // (B, H, T)
  __nv_bfloat16* dq;          // (B, T, H, D)
  __nv_bfloat16* dk;          // (B, T, Hkv, D)
  __nv_bfloat16* dv;          // (B, T, Hkv, D)
  int t_len, n_head, n_kv;
  float scale;
};

// dK/dV kernel: K and V of 128 keys, then NSB stages of 64-row Q and dO
// tiles and of their lse and delta
template <int D>
struct DkdvLayout {
  static constexpr int DB = D / 64;
  static constexpr int K_BLOCK = BQ * 128;    // a column block of the K/V tile
  static constexpr int R_BLOCK = BK * 128;    // a column block of a Q/dO tile
  static constexpr int R_TILE = DB * R_BLOCK;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + DB * K_BLOCK;
  static constexpr int Q_OFF = V_OFF + DB * K_BLOCK;   // [stage] Q tiles
  static constexpr int O_OFF = Q_OFF + NSB * R_TILE;   // [stage] dO tiles
  static constexpr int S_OFF = O_OFF + NSB * R_TILE;   // [stage][lse 64 | delta 64]
  static constexpr int SMEM = 1024 + S_OFF + NSB * 2 * BK * 4;
};

// dQ kernel: Q and dO of 128 rows, then NSB stages of 64-key K and V tiles
// and of their key-valid flags (the forward's layout with dO beside Q)
template <int D>
struct DqLayout {
  static constexpr int DB = D / 64;
  static constexpr int Q_BLOCK = BQ * 128;
  static constexpr int KV_BLOCK = BK * 128;
  static constexpr int KV_TILE = DB * KV_BLOCK;
  static constexpr int Q_OFF = 0;
  static constexpr int O_OFF = Q_OFF + DB * Q_BLOCK;
  static constexpr int K_OFF = O_OFF + DB * Q_BLOCK;   // [stage] K tiles
  static constexpr int V_OFF = K_OFF + NSB * KV_TILE;  // [stage] V tiles
  static constexpr int M_OFF = V_OFF + NSB * KV_TILE;  // [stage][BK] kvalid
  static constexpr int SMEM = 1024 + M_OFF + NSB * BK * 4;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~uintptr_t(1023));
}

// d (64 x D) += a (64 x 64, four k16 A fragments) * a 64 x D tile read
// MN-major (rows are K and D-contiguous) through its descriptor `db`: a
// k16 step is 16 rows, +2048 bytes
template <int D>
__device__ __forceinline__ void mma_rs_tile(float (&d)[D / 2], const uint32_t (&a)[4][4],
                                            uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128) {
      wg::wgmma_m64n128k16_rs_tb(d, a[kk], db + kk * (2048 >> 4));
    } else {
      wg::wgmma_m64n64k16_rs_tb(d, a[kk], db + kk * (2048 >> 4));
    }
  }
}

// descriptor of k16 step f of a K-major tile of DB stacked column blocks
// of `block` bytes, from the tile's own: +32 bytes a step inside a column
// block (the start address is in 16-byte units in the low bits)
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int f, int block) {
  return desc + (uint64_t)(((f / 4) * block + (f % 4) * 32) >> 4);
}

// a (64 x 64 fp32 accumulators) packed into the bf16 A fragments of its
// four k16 slices: register r of step kk holds accumulators 8 kk + 2 r, +1
__device__ __forceinline__ void pack_frags(const float (&a)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(a[8 * kk + 2 * r], a[8 * kk + 2 * r + 1]);
}

// the 64 x D fp32 accumulator tile d as bf16 rows [row_g, row_g + 8] of a
// (B, T, Hx, D) tensor; rows past T are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&d)[D / 2],
                                           int b, int row_g, int hx, int n_hx,
                                           int t_len, int tq) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_g + 8 * e;
    if (row >= t_len) continue;
    __nv_bfloat16* dst = out + (((size_t)b * t_len + row) * n_hx + hx) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * e;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = pack_bf16(d[i], d[i + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void attn_bwd_dkdv_wgmma(const BwdArgs& a) {
  using L = DkdvLayout<D>;
  constexpr int KS = D / 16;  // k16 steps of S^T and dP^T
  constexpr int NA = D / 2;   // dK (and dV) accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  float* stat_s = reinterpret_cast<float*>(sm + L::S_OFF);

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BQ;
  const int t_len = a.t_len, group = a.n_head / a.n_kv;
  const int qt0 = k0 / BK;                  // the first query tile any key sees
  const int per = (t_len + BK - 1) / BK - qt0;  // query tiles walked per head
  const int n_walk = group * per;
  const int kw0 = k0 + 64 * wgi;            // this warpgroup's first key
  const int key_g = kw0 + 16 * warp + g;    // this thread's keys: key_g, key_g + 8
  bool kv_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = key_g + 8 * e;
    kv_ok[e] = key < t_len && a.kvalid[(size_t)b * t_len + key] != 0;
  }

  // Q and dO of walk step j (head j / per, query tile qt0 + j % per) and
  // their lse and delta (0 past T) into stage j % NSB
  auto load_q = [&](int j) {
    const int st = j % NSB, h = hk * group + j / per, q0 = (qt0 + j % per) * BK;
    load_tile<D, BK>(sm + L::Q_OFF + st * L::R_TILE, a.q, b, q0, h, a.n_head, t_len);
    load_tile<D, BK>(sm + L::O_OFF + st * L::R_TILE, a.dout, b, q0, h, a.n_head, t_len);
    if (tid < 2 * BK) {
      const int i = q0 + tid % BK;
      const bool ok = i < t_len;
      const float* src = tid < BK ? a.lse : a.delta;
      const size_t gi = ((size_t)b * a.n_head + h) * t_len + i;
      wg::cp_async4(stat_s + st * 2 * BK + tid, ok ? src + gi : src, ok);
    }
  };

  load_tile<D, BQ>(sm + L::K_OFF, a.k, b, k0, hk, a.n_kv, t_len);
  load_tile<D, BQ>(sm + L::V_OFF, a.v, b, k0, hk, a.n_kv, t_len);
  load_q(0);
  wg::cp_async_commit();

  float dk[NA], dv[NA], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = wg::smem_u32(sm + L::K_OFF + wgi * 64 * 128);
  const uint32_t va = wg::smem_u32(sm + L::V_OFF + wgi * 64 * 128);

  for (int j = 0; j < n_walk; ++j) {
    const int st = j % NSB, q0 = (qt0 + j % per) * BK;
    wg::cp_async_wait<0>();
    // step j is in place for every thread, and every read of step j - 1's
    // stage, which step j + 1 now takes, has retired
    __syncthreads();
    if (j + 1 < n_walk) load_q(j + 1);
    wg::cp_async_commit();
    if (q0 + BK - 1 < kw0 || kw0 >= t_len) continue;  // no key here sees the tile

    // S^T = K Q^T and dP^T = V dO^T in one group; the four tiles'
    // descriptors are built before the fence
    const uint32_t qa = wg::smem_u32(sm + L::Q_OFF + st * L::R_TILE);
    const uint32_t oa = wg::smem_u32(sm + L::O_OFF + st * L::R_TILE);
    uint64_t dka = wg::sw128_desc(ka), dva = wg::sw128_desc(va);
    uint64_t dqb = wg::sw128_desc(qa), dob = wg::sw128_desc(oa);
    asm volatile("" : "+l"(dka), "+l"(dva), "+l"(dqb), "+l"(dob));
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
#pragma unroll
    for (int f = 0; f < KS; ++f)
      wg::wgmma_m64n64k16_ss(s, k_step(dka, f, L::K_BLOCK), k_step(dqb, f, L::R_BLOCK), f > 0);
#pragma unroll
    for (int f = 0; f < KS; ++f)
      wg::wgmma_m64n64k16_ss(dp, k_step(dva, f, L::K_BLOCK), k_step(dob, f, L::R_BLOCK), f > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // P^T and dS^T; s[i] is key key_g + 8 * ((i / 2) % 2), query
    // q0 + 8 * (i / 4) + 2 * tq + i % 2. The mask is needed on the
    // diagonal tile, at the ragged end and for this thread's invalid keys.
    const float* lse_s = stat_s + st * 2 * BK;
    const float* dlt_s = lse_s + BK;
    const bool need_mask = q0 < kw0 + 63 || q0 + BK > t_len || !(kv_ok[0] && kv_ok[1]);
    // each pair of columns is packed as soon as it is made, so the fp32
    // P^T and dS^T die as they go: register r of k16 step kk holds
    // accumulators 8 kk + 2 r, +1 (rows r % 2, columns 16 kk + 8 (r / 2)
    // + 2 tq, +1)
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = 16 * kk + 8 * (r / 2) + 2 * tq, e = r % 2, key = key_g + 8 * e;
        const float2 lse = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dlt = *reinterpret_cast<const float2*>(dlt_s + col);
        const int i = 8 * kk + 2 * r;
        float p0 = ex2(fmaf(s[i], sl2, -lse.x * kLog2e));
        float p1 = ex2(fmaf(s[i + 1], sl2, -lse.y * kLog2e));
        if (need_mask) {
          const bool ok = kv_ok[e] && q0 + col < t_len;
          p0 = ok && key <= q0 + col ? p0 : 0.f;
          p1 = ok && key <= q0 + col + 1 && q0 + col + 1 < t_len ? p1 : 0.f;
        }
        pf[kk][r] = pack_bf16(p0, p1);
        df[kk][r] = pack_bf16(p0 * (dp[i] - dlt.x) * a.scale,
                              p1 * (dp[i + 1] - dlt.y) * a.scale);
      }

    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: fragments and descriptors
    // before the fence, the group retired before the next tile writes them
    uint64_t dob_mn = wg::sw128_desc_mn(oa, L::R_BLOCK);
    uint64_t dqb_mn = wg::sw128_desc_mn(qa, L::R_BLOCK);
    asm volatile("" : "+l"(dob_mn), "+l"(dqb_mn));
    wg::fence_regs(dv);
    wg::fence_regs(dk);
    wg::wgmma_fence();
    mma_rs_tile<D>(dv, pf, dob_mn);
    mma_rs_tile<D>(dk, df, dqb_mn);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dv);
    wg::fence_regs(dk);
  }

  store_rows<D>(a.dk, dk, b, key_g, hk, a.n_kv, t_len, tq);
  store_rows<D>(a.dv, dv, b, key_g, hk, a.n_kv, t_len, tq);
}

template <int D>
__device__ __forceinline__ void attn_bwd_dq_wgmma(const BwdArgs& a) {
  using L = DqLayout<D>;
  constexpr int KS = D / 16;
  constexpr int NA = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  int* kv_s = reinterpret_cast<int*>(sm + L::M_OFF);

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int t_len = a.t_len;
  const int hk = h / (a.n_head / a.n_kv);
  // the key tiles a run of rows walks: up to the causal limit of its last
  const int n_tiles = (min(q0 + BQ, t_len) - 1) / BK + 1;
  const int r0 = q0 + 64 * wgi;
  const int my_tiles = r0 < t_len ? (min(r0 + 64, t_len) - 1) / BK + 1 : 0;
  const int row_g = r0 + 16 * warp + g;  // this thread's rows: row_g, row_g + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_g + 8 * e;
    const size_t gi = ((size_t)b * a.n_head + h) * t_len + row;
    lse2[e] = row < t_len ? a.lse[gi] * kLog2e : 0.f;
    dlt[e] = row < t_len ? a.delta[gi] : 0.f;
  }

  // K, V and the key-valid flags (0 past T) of tile j into stage j % NSB
  auto load_kv = [&](int j) {
    const int st = j % NSB;
    load_tile<D, BK>(sm + L::K_OFF + st * L::KV_TILE, a.k, b, j * BK, hk, a.n_kv, t_len);
    load_tile<D, BK>(sm + L::V_OFF + st * L::KV_TILE, a.v, b, j * BK, hk, a.n_kv, t_len);
    if (tid < BK) {
      const int key = j * BK + tid;
      const bool ok = key < t_len;
      wg::cp_async4(kv_s + st * BK + tid, ok ? a.kvalid + (size_t)b * t_len + key : a.kvalid,
                    ok);
    }
  };

  load_tile<D, BQ>(sm + L::Q_OFF, a.q, b, q0, h, a.n_head, t_len);
  load_tile<D, BQ>(sm + L::O_OFF, a.dout, b, q0, h, a.n_head, t_len);
  load_kv(0);
  wg::cp_async_commit();

  float dq[NA], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t qa = wg::smem_u32(sm + L::Q_OFF + wgi * 64 * 128);
  const uint32_t oa = wg::smem_u32(sm + L::O_OFF + wgi * 64 * 128);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK, st = j % NSB;
    wg::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) load_kv(j + 1);
    wg::cp_async_commit();
    if (j >= my_tiles) continue;  // past this warpgroup's causal limit

    // S = Q K^T and dP = dO V^T in one group
    const uint32_t kb = wg::smem_u32(sm + L::K_OFF + st * L::KV_TILE);
    const uint32_t vb = wg::smem_u32(sm + L::V_OFF + st * L::KV_TILE);
    uint64_t dqa = wg::sw128_desc(qa), doa = wg::sw128_desc(oa);
    uint64_t dkb = wg::sw128_desc(kb), dvb = wg::sw128_desc(vb);
    asm volatile("" : "+l"(dqa), "+l"(doa), "+l"(dkb), "+l"(dvb));
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
#pragma unroll
    for (int f = 0; f < KS; ++f)
      wg::wgmma_m64n64k16_ss(s, k_step(dqa, f, L::Q_BLOCK), k_step(dkb, f, L::KV_BLOCK), f > 0);
#pragma unroll
    for (int f = 0; f < KS; ++f)
      wg::wgmma_m64n64k16_ss(dp, k_step(doa, f, L::Q_BLOCK), k_step(dvb, f, L::KV_BLOCK), f > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // P and dS; s[i] is row row_g + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + 2 * tq + i % 2. Rows past T are never written,
    // keys past T have kvalid 0.
    bool need_mask = k0 + BK - 1 > r0;
    need_mask |= !__all_sync(kFullMask, kv_s[st * BK + lane] != 0 &&
                                            kv_s[st * BK + lane + 32] != 0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * tq + i % 2, e = (i / 2) % 2;
      const int key = k0 + col, row = row_g + 8 * e;
      float p = ex2(fmaf(s[i], sl2, -lse2[e]));
      if (need_mask) p = (key <= row && kv_s[st * BK + col] != 0) ? p : 0.f;
      dp[i] = p * (dp[i] - dlt[e]) * a.scale;
    }

    // dQ += bf16(dS) K, K read MN-major
    uint32_t df[4][4];
    pack_frags(dp, df);
    uint64_t dkb_mn = wg::sw128_desc_mn(kb, L::KV_BLOCK);
    asm volatile("" : "+l"(dkb_mn));
    wg::fence_regs(dq);
    wg::wgmma_fence();
    mma_rs_tile<D>(dq, df, dkb_mn);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dq);
  }

  store_rows<D>(a.dq, dq, b, row_g, h, a.n_head, t_len, tq);
}

// lets both kernels use their shared memory; returns the CUDA error code
template <int D, typename KernelKV, typename KernelQ>
int allow_bwd_smem(KernelKV dkdv, KernelQ dq) {
  cudaError_t e = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, DkdvLayout<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   DqLayout<D>::SMEM);
}

// launches dK/dV on the (Hkv, B, key blocks) grid, then dQ on the (H, B,
// query blocks) grid; returns the CUDA error code
template <int D, typename KernelKV, typename KernelQ>
int launch_bwd(KernelKV dkdv, KernelQ dq, const BwdArgs& a, int batch,
               cudaStream_t stream) {
  int e = allow_bwd_smem<D>(dkdv, dq);
  if (e != 0) return e;
  const int blocks = (a.t_len + BQ - 1) / BQ;
  dkdv<<<dim3(a.n_kv, batch, blocks), THREADS, DkdvLayout<D>::SMEM, stream>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  dq<<<dim3(a.n_head, batch, blocks), THREADS, DqLayout<D>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// how many blocks of each kernel one SM holds at once (registers and
// shared memory); returns the CUDA error code
template <int D, typename KernelKV, typename KernelQ>
int bwd_blocks_per_sm(KernelKV dkdv, KernelQ dq, int* n_dkdv, int* n_dq) {
  int e = allow_bwd_smem<D>(dkdv, dq);
  if (e != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n_dkdv, dkdv, THREADS,
                                                         DkdvLayout<D>::SMEM);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n_dq, dq, THREADS,
                                                            DqLayout<D>::SMEM);
}

}  // namespace attn
}  // namespace fs
