// Causal GQA attention forward on the Hopper tensor cores (wgmma): one
// mainloop behind two kernels that differ only in their key mask,
//  * train_fwd_wgmma_kernel (flash_train.cu), Mask::kKeyValid: key j is
//    visible to query i iff j <= i and kvalid[b, j] != 0; writes O and the
//    row logsumexp lse = m + log(l) (the TPU kernel is _fwd_kernel of
//    fish_speech_tpu/ops/pallas_attention_train.py);
//  * prefill_wgmma_kernel (flash_prefill.cu), Mask::kOffset: key j is
//    visible iff j <= i and j >= offsets[b]; writes O (the TPU kernel is
//    _prefill_kernel of fish_speech_tpu/ops/pallas_attention.py).
// (The prefix-cache suffix, a decode-like walk over the cache, has its own
// kernel: flash_prefill.cu, suffix_wgmma_kernel.)
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
// fp16 (the `--half` serving path): prefill_wgmma_kernel is templated on
// the 16-bit type T (common.cuh `Elem`): q/k/v/O in fp16, S and P V on
// wgmma's `.f16` operands, P = rn_f16(exp(s - m_running)) (11 significant
// bits where bf16 keeps 8; a p below 2^-24 of the row's running max rounds
// to 0, and l sums the unrounded p, as in bf16). The training forward stays
// bf16.
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

enum class Mask { kKeyValid, kOffset };

template <typename T = __nv_bfloat16>
struct ArgsT {
  const T* q;              // (B, T, H, D)
  const T* k;              // (B, T, Hkv, D)
  const T* v;
  const int* mask;         // kKeyValid: kvalid (B, T); kOffset: offsets (B,)
  T* out;                  // (B, T, H, D)
  float* lse;              // (B, H, T), kKeyValid only
  int t_len, n_head, n_kv;
  float scale;
};
using Args = ArgsT<>;

template <int D>
struct Layout {
  static constexpr int DB = D / 64;              // 64-column blocks of a row
  static constexpr int Q_BLOCK = BQ * 128;       // a column block of the Q tile
  static constexpr int KV_BLOCK = BK * 128;      // a column block of a K/V tile
  static constexpr int KV_TILE = DB * KV_BLOCK;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + DB * Q_BLOCK;    // [stage] K tiles
  static constexpr int V_OFF = K_OFF + NST * KV_TILE;   // [stage] V tiles
  static constexpr int M_OFF = V_OFF + NST * KV_TILE;   // [stage][BK] kvalid
  static constexpr int SMEM = 1024 + M_OFF + NST * BK * 4;  // + alignment slack
};

// O += P V for one 64-key tile: P (64 x 64, T) in A fragments, V from the
// MN-major descriptors of its k16 steps
template <int D, typename T>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                         const uint64_t (&dv)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128) {
      wg::wgmma_m64n128k16_rs_tb<T>(o, p[kk], dv[kk]);
    } else {
      wg::wgmma_m64n64k16_rs_tb<T>(o, p[kk], dv[kk]);
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
// stacked 128-byte-swizzled blocks of ROWS rows; rows at or past seq read
// as 0
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          int b, int row0, int hx, int n_hx,
                                          int seq) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool valid = row < seq;
    const T* s = src + (((size_t)b * seq + row) * n_hx + hx) * D + 8 * c;
    wg::cp_async16(dst + (c / 8) * (ROWS * 128) + wg::sw128(r, c % 8),
                   valid ? s : src, valid);
  }
}

template <Mask M, int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void attn_fwd_wgmma(const ArgsT<T>& a) {
  using L = Layout<D>;
  constexpr int KS = D / 16;  // k16 steps of S = Q K^T
  constexpr int NO = D / 2;   // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* kv_s = reinterpret_cast<int*>(sm + L::M_OFF);

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int t_len = a.t_len;
  const int hk = h / (a.n_head / a.n_kv);
  const int off = M == Mask::kOffset ? a.mask[b] : 0;

  // Keys a run of rows [first, last] walks: up to the causal limit of its
  // last row, or all T where a row lies before its offset (it sees no key
  // and averages every key, as the TPU kernel gives it).
  auto kv_tiles = [&](int first, int last) {
    const int end = (M == Mask::kOffset && first < off) ? t_len : last + 1;
    return (end + BK - 1) / BK;
  };
  const int n_tiles = kv_tiles(q0, min(q0 + BQ, t_len) - 1);
  const int r0 = q0 + 64 * wgi;  // this warpgroup's first row
  const int my_tiles = r0 < t_len ? kv_tiles(r0, min(r0 + 64, t_len) - 1) : 0;

  // K, V and the key-valid flags (0 past T) of tile j into stage j % NST
  auto load_kv = [&](int j) {
    const int st = j % NST;
    load_tile<D, BK>(sm + L::K_OFF + st * L::KV_TILE, a.k, b, j * BK, hk, a.n_kv, t_len);
    load_tile<D, BK>(sm + L::V_OFF + st * L::KV_TILE, a.v, b, j * BK, hk, a.n_kv, t_len);
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
  // P of the tile before, in T: the operand of its P V, in flight during
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
    if (j + 1 < n_tiles) load_kv(j + 1);
    wg::cp_async_commit();
    if (j > my_tiles || my_tiles == 0) continue;  // past this warpgroup's limit
    uint64_t dv[4];
    v_descs(sv, dv);
    if (j == my_tiles) {  // this warpgroup's last P V
      wg::fence_regs(o);
      wg::wgmma_fence();
      pv_wgmma<D, T>(o, pc, dv);
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
    for (int f = 0; f < KS; ++f) wg::wgmma_m64n64k16_ss<T>(s, dq[f], dk[f], f > 0);
    wg::wgmma_commit();
    pv_wgmma<D, T>(o, pc, dv);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // S is retired; P V runs under the softmax
    wg::fence_regs(s);

    // scale and mask; s[i] is row row_g + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + 2 * tq + i % 2
    bool need_mask = k0 + BK - 1 > r0 || k0 + BK > t_len;
    if constexpr (M == Mask::kOffset) {
      need_mask |= k0 < off;
    } else if constexpr (M == Mask::kKeyValid) {  // an invalid key (one vote per warp)
      need_mask |= !__all_sync(kFullMask, kv_s[st * BK + lane] != 0 &&
                                              kv_s[st * BK + lane + 32] != 0);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int jj = 8 * (i / 4) + 2 * tq + i % 2, key = k0 + jj;
      float x = s[i] * a.scale;
      if (need_mask) {
        const int row = row_g + 8 * ((i / 2) % 2);
        bool visible = key <= row;
        if constexpr (M == Mask::kOffset) visible = visible && key >= off;
        if constexpr (M == Mask::kKeyValid) visible = visible && kv_s[st * BK + jj] != 0;
        x = key >= t_len ? -INFINITY : (visible ? x : kMaskedScore);
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
    // 16 kk + 8 (r / 2) + 2 tq, +1: accumulators 8 kk + 2 r, +1, rounded
    // to T
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        pc[kk][r] = Elem<T>::pack(s[i], s[i + 1]);
      }
  }
  // the last tile's P V, where this warpgroup walked every tile of the block
  if (my_tiles == n_tiles) {
    uint64_t dv[4];
    v_descs((n_tiles - 1) % NST, dv);
    wg::fence_regs(o);
    wg::wgmma_fence();
    pv_wgmma<D, T>(o, pc, dv);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
  }

  // epilogue: l over the quad, O / l in T pairs, lse = m + log(l)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(kFullMask, l[e], 1);
    l[e] += __shfl_xor_sync(kFullMask, l[e], 2);
    const int row = row_g + 8 * e;
    if (row >= t_len) continue;
    const float inv = 1.f / l[e];
    T* dst = a.out + (((size_t)b * t_len + row) * a.n_head + h) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * e;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = Elem<T>::pack(o[i] * inv, o[i + 1] * inv);
    }
    if (M == Mask::kKeyValid && tq == 0)
      a.lse[((size_t)b * a.n_head + h) * t_len + row] = m[e] + logf(l[e]);
  }
}

// sets the kernel's shared memory and launches it on the (H, B, query
// tiles) grid; returns the CUDA error code
template <int D, typename Kernel, typename A>
int launch(Kernel kernel, const A& a, int batch, cudaStream_t stream) {
  constexpr int smem = Layout<D>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.n_head, batch, (a.t_len + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace fs
