// Causal GQA prefill attention with a per-row key start offset.
//
// Replaces the Pallas TPU kernel fish_speech_tpu/ops/pallas_attention.py
// (_prefill_kernel / flash_prefill_attention): key j is visible to query i
// iff j <= i and j >= offsets[b]; masked scores are the finite -1e30, so a
// row with no visible key (a pad row before its offset) is the uniform
// average of V over all T keys, exactly as the TPU kernel gives it.
//
// What bounds it on the H100: at the flagship's prefill shapes (H=32,
// Hkv=8, D=128, T up to 4096) the work is ~T^2*H*D*2 multiply-adds per
// layer with K/V reused by every query tile, so it is compute-bound. The TPU
// kernel kept a head's whole K/V in VMEM; a Hopper SM has at most 227 KB of
// shared memory, so this kernel streams K/V through shared memory in tiles of
// BK keys and keeps an online (running max / running sum) softmax in float32
// per query row. Scores never reach device memory.
//
// Three routes, one per dtype (fs_flash_prefill dispatches on it; the
// wrapper's `ops/flash_prefill.py:_route` names the route it counts):
//  * "wgmma", bf16 (every served model): `prefill_wgmma_kernel`, the
//    tensor-core mainloop of attn_wgmma.cuh (whose note gives its design)
//    with the offset mask;
//  * "wgmma_f16", fp16 (the `--half` serving path): the same kernel
//    instantiated for __half (wgmma's `.f16` operands, P rounded to fp16);
//  * "cuda_cores", fp32 (the small fp32 reference models):
//    `prefill_kernel`, one block of 256 threads per (query tile of BQ=64
//    rows, head, batch row), products on the CUDA cores in float32 from
//    shared memory, tiles past the causal limit of the block skipped; at
//    head dim 32 (the tiny model's slow stack), 64 or 128, where the
//    tensor-core routes take 64 and 128.
//
// fs_flash_suffix serves a prefix-cache hit's suffix prefill
// (dual_ar.prefill_suffix; JAX runs an
// einsum over the cache there, fish_speech_tpu/models/dual_ar.py:
// prefill_suffix): query i sits at position start + i, with start read
// from device memory, K/V come from one layer of the stacked cache (row
// stride S), key j is visible iff j <= start + i, and only keys
// [0, start + T) are read. Six forms, {bf16, fp16, fp32} x {a cache of
// q's dtype, int8 cache}: `suffix_wgmma_kernel<D, KV8, T>` (below: the G
// heads of a KV head packed into one block's rows, the keys split over
// blocks and merged in the launch, TMA loads by a producer warp, wgmma; T
// bf16 or fp16; the int8 cache's scales are bf16 under either) and
// `prefill_kernel` with SUFFIX set (fp32). Under the int8 cache K/V go to
// the kernel's type exactly, ks scales the score columns and vs the
// probability columns before P V, l summing the unscaled p
// (fish_speech_tpu/ops/attention.py:gqa_attention_kv8). What bounds the
// suffix on the H100: 4 * D operations per visible (query, key) pair and
// head against the cache's K/V bytes: at start 951, T 64 the K/V of a layer
// is 4 MB, ~0.06 operations a byte over the card's bf16 ratio, so the
// bytes bound it.

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block
constexpr int PS = BK + 1;   // padded row stride of the probability tile

template <int D>
constexpr size_t prefill_smem_bytes() {
  // Qs[BQ][D+1] + Ks[BK][D+1] + Vs[BK][D] + Ps[BQ][BK+1] + 3 row vectors
  // + the tile's ks and vs (KV8)
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS + 3 * BQ + 2 * BK);
}

__device__ __forceinline__ float ld(float x) { return x; }
__device__ __forceinline__ float ld(int8_t x) { return (float)x; }

// SUFFIX: `mask` is start (1,), query i sits at start + i and K/V are a
// cache layer of row stride `seq`; else `mask` is offsets (B,) and
// seq == t_len. KV8 (with SUFFIX): KT is int8_t and ksc/vsc the layer's
// bf16 scales (B, seq, Hkv).
template <typename T, typename KT, int D, bool SUFFIX, bool KV8>
__global__ void __launch_bounds__(NT)
    prefill_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const __nv_bfloat16* __restrict__ ksc,
                   const __nv_bfloat16* __restrict__ vsc,
                   const int* __restrict__ mask, T* __restrict__ out, int t_len,
                   int seq, int n_head, int n_kv, float scale) {
  constexpr int QP = D + 1;  // padded strides keep shared reads conflict-free
  constexpr int KP = D + 1;
  constexpr int NC = D / 32;  // output columns per thread: 1 at the tiny D = 32
  static_assert(NC >= 1 && NC * 32 == D, "whole output columns per lane");

  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][QP]
  float* ks = qs + BQ * QP;         // [BK][KP]
  float* vs = ks + BK * KP;         // [BK][D]
  float* ps = vs + BK * D;          // [BQ][PS]
  float* row_m = ps + BQ * PS;      // running max per query row
  float* row_l = row_m + BQ;        // running sum per query row
  float* row_a = row_l + BQ;        // rescale factor of the current tile
  float* scl = row_a + BQ;          // KV8: ks of the tile's keys, then vs

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_head / n_kv);
  const int off = SUFFIX ? 0 : mask[b];
  const int diag = SUFFIX ? mask[0] : 0;  // query i sits at diag + i
  const int lim = diag + t_len;           // keys [0, lim) exist

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int i = q0 + r;
    float x = 0.f;
    if (i < t_len) x = fs::to_float(q[(((size_t)b * t_len + i) * n_head + h) * D + c]);
    qs[r * QP + c] = x;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // Rows before the offset see no key; the TPU kernel averages them over
  // all T keys, so such a block walks every tile. Otherwise the causal
  // limit of the block's last row bounds the walk.
  const int last_q = min(q0 + BQ, t_len) - 1;
  const int kv_end = q0 < off ? t_len : diag + last_q + 1;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // score ownership: rows sr*4..sr*4+3, columns sc + 16*c
  const int sr = tid >> 4;
  const int sc = tid & 15;
  // output ownership: rows warp*8..warp*8+7, columns lane + 32*c; the same
  // warp runs the softmax of these rows, so only a warp barrier separates
  // the softmax from the P.V product.
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int j = k0 + r;
      float kx = 0.f, vx = 0.f;  // zero rows past T keep 0 * x finite
      if (j < lim) {
        const size_t g = (((size_t)b * seq + j) * n_kv + hk) * D + c;
        kx = ld(k[g]);
        vx = ld(v[g]);
      }
      ks[r * KP + c] = kx;
      vs[r * D + c] = vx;
    }
    if (KV8 && tid < 2 * BK) {
      const int j = k0 + tid % BK;
      const __nv_bfloat16* sp = tid < BK ? ksc : vsc;
      scl[tid] = j < lim ? __bfloat162float(sp[((size_t)b * seq + j) * n_kv + hk]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = qs[(sr * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[(sc + 16 * c) * KP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + sr * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + sc + 16 * c;
        float x;
        if (j >= lim) {
          x = -INFINITY;  // no such key: weight exactly 0
        } else if (j <= i + diag && j >= off) {
          x = KV8 ? s[r][c] * (scl[sc + 16 * c] * scale) : s[r][c] * scale;
        } else {
          x = fs::kMaskedScore;
        }
        ps[(sr * 4 + r) * PS + sc + 16 * c] = x;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two columns per lane
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x0 = ps[r * PS + lane];
      const float x1 = ps[r * PS + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, fs::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      ps[r * PS + lane] = p0;
      ps[r * PS + lane + 32] = p1;
      const float sum = fs::warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = row_a[warp * 8 + r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
      const float vscale = KV8 ? scl[BK + j] : 1.f;  // p * vs, l unscaled
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = ps[(warp * 8 + r) * PS + j] * vscale;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = q0 + warp * 8 + r;
    if (i >= t_len) continue;
    const float inv = 1.f / row_l[warp * 8 + r];
    T* o = out + (((size_t)b * t_len + i) * n_head + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) fs::store(o + lane + 32 * c, acc[r][c] * inv);
  }
}

template <typename T, typename KT, int D, bool SUFFIX, bool KV8>
int launch_prefill(const void* q, const void* k, const void* v, const void* ksc,
                   const void* vsc, const int* mask, void* out, int batch,
                   int t_len, int seq, int n_head, int n_kv, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  auto kernel = prefill_kernel<T, KT, D, SUFFIX, KV8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + BQ - 1) / BQ, n_head, batch);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const __nv_bfloat16*>(ksc),
      static_cast<const __nv_bfloat16*>(vsc), mask, static_cast<T*>(out),
      t_len, seq, n_head, n_kv, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    prefill_wgmma_kernel(const fs::attn::ArgsT<T> a) {
  fs::attn::attn_fwd_wgmma<fs::attn::Mask::kOffset, D, T>(a);
}

// the tensor-core prefill ("wgmma" in bf16, "wgmma_f16" in fp16) at head dim
// 64 or 128
template <typename T>
int launch_prefill_wgmma(const void* q, const void* k, const void* v,
                         const int* off, void* out, int batch, int t_len,
                         int n_head, int n_kv, int head_dim, float scale,
                         cudaStream_t s) {
  fs::attn::ArgsT<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.mask = off;
  a.out = static_cast<T*>(out);
  a.lse = nullptr;
  a.t_len = t_len;
  a.n_head = n_head;
  a.n_kv = n_kv;
  a.scale = scale;
  if (head_dim == 128)
    return fs::attn::launch<128>(prefill_wgmma_kernel<128, T>, a, batch, s);
  if (head_dim == 64)
    return fs::attn::launch<64>(prefill_wgmma_kernel<64, T>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The suffix attention on the tensor cores (routes "suffix_wgmma",
// "suffix_kv8_wgmma" and their fp16 forms): `suffix_wgmma_kernel<D, KV8,
// T>`, a decode-like walk of one cache layer by G * Ts query rows.
//
// The suffix is a decode with Ts * G query rows in place of G: its queries
// are few and its keys, [0, start + Ts) of the cache, many. So the design
// is that of the decode kernels (flash_decode.cu), on wgmma:
// * GQA packing. Packed row m of (b, kv) is position i = m / G of head
//   kv * G + m % G (in q's (B, Ts, H, D) layout these heads are
//   neighbours), and a block takes 64 or 128 consecutive packed rows (the
//   wrapper's `rows_per_block`). Each K/V tile is read once per block, not
//   once per head; rows of one position share its mask.
// * Two consumer warpgroups. With 64 rows a block they take the slice's
//   tiles in turn over the same rows (tile n to warpgroup n % 2), and
//   their two softmax states join through shared memory at the end: the
//   keys of a block are walked twice as fast, for one request's few rows.
//   With 128 rows each takes its own 64 and both walk every tile: each
//   tile is read from L2 for twice the rows, for many rows (a group
//   admission), where the card's L2 bandwidth bounds the walk.
// * Split over keys. The grid is (row tiles x Hkv, B, Z): the wrapper picks
//   the rows a block and Z from the shape alone (`ops/flash_prefill.py:
//   suffix_plan`), never from start, so one CUDA graph serves every start.
//   Slice z owns keys [z * chunk, (z + 1) * chunk) (chunk a multiple of
//   the 64-key tile) of the row tile's keys [0, start + i_last + 1); a
//   slice wholly past them returns at once, and only tiles that reach the
//   causal diagonal or the end of the keys apply the mask. Each active
//   slice writes its (m, l, O) partial to a workspace, and the last of the
//   row tile's slices to finish (a release/acquire counter, as in
//   flash_decode.cu) merges them in slice order and writes O once, in q's
//   dtype (`merge_partials`: the partials' m and l first, one round trip,
//   their weights in shared memory, then each thread's columns of one slice
//   after another, every load of a slice issued before any sum: loads
//   behind branches measured a round trip each). A row tile with one
//   active slice writes O itself.
// * Loads. One producer warp keeps the slice's K/V tiles in flight by TMA
//   on full/empty mbarriers: 16-bit tiles land in the 128-byte swizzle,
//   ready as wgmma's B operand, six stages deep (a warpgroup holds two);
//   int8 tiles land plain, three deep, or two while the warpgroups take
//   the tiles in turn (each its own stage: `Layout`), freed once converted,
//   with their bf16 scales (0 past the keys) read by the producer's lanes.
// * Tensor cores: S = Q K^T on wgmma.m64n64k16 (both operands from shared
//   memory), the mask and an online softmax in registers, O += P V on
//   wgmma with P (rounded to T) as the register A operand and V MN-major
//   from shared memory. Each warpgroup pipelines its tiles as the prefill
//   mainloop does (attn_wgmma.cuh): S of its tile j and P V of tile j - 1
//   go out together and tile j's softmax runs under P V; the other
//   warpgroup fills the tensor cores meanwhile.
// * int8 cache: the landed int8 K and V tiles go once to T in shared tiles
//   (exact, |x| <= 127), by the warpgroup that takes the tile or by both
//   for a tile they share (two buffers, by tile parity), and the stage is
//   released at once; ks scales the columns of S, vs those of P, and l sums
//   the unscaled p (fish_speech_tpu/ops/attention.py:gqa_attention_kv8).
//   wgmma reads B only from shared memory, so the int8 -> T step of
//   decode_kv8_mma_kernel (in registers, for mma.sync's B) has no place
//   here.
// * Keys past start + Ts may hold anything: their scores are -inf, and on
//   the 16-bit cache their V rows are zeroed in shared memory (0 * NaN is
//   not 0); masked keys below it score the finite fs::kMaskedScore.
// What bounds it on the H100: the cache's K/V bytes of keys [0, start + Ts)
// (4 * D operations per visible (query, key) pair and head are far below
// the bf16 ratio at Ts <= 128).
// ---------------------------------------------------------------------------

namespace sfx {

using namespace fs::wg;

constexpr int BQ = 64;          // packed query rows of a warpgroup
constexpr int BK = 64;          // keys per tile
constexpr int CONSUMERS = 256;  // two warpgroups; the producer warp follows
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_SPLIT = 16;   // most slices (ops/flash_prefill.py)

// Stages of the K/V ring: a 16-bit stage is held by a warpgroup for two of
// its tiles (S of one beside P V of the one before), an int8 stage only
// until its conversion. Tile n lands in stage n % nst, where nst is NST
// with pairs and the even NST & ~1 with turns: the full barrier's wait
// tells phases apart by parity alone, so a consumer must wait on every
// phase of the stages it reads, and with turns (tile n to warpgroup n % 2)
// an even nst gives each warpgroup stages of its own. KV8's four buffers
// of converted tiles: two per warpgroup (turns) or three by tile (pairs).
template <int D, bool KV8>
struct Layout {
  static constexpr int NST = KV8 ? 3 : 6;
  static constexpr int NCONV = 4;
  static constexpr int DB = D / 64;                 // 64-column blocks of a row
  static constexpr int BLOCK = 64 * 128;            // a column block of 64 rows
  static constexpr int TILE16 = DB * BLOCK;         // a 16-bit Q, K or V tile
  static constexpr int TILE8 = BK * D;              // an int8 K or V tile
  static constexpr int STAGE = KV8 ? 2 * TILE8 : 2 * TILE16;
  static constexpr int Q_OFF = 0;                   // [warpgroup] Q tiles
  static constexpr int RING_OFF = Q_OFF + 2 * TILE16;  // [stage][K, V]
  static constexpr int CONV_OFF = RING_OFF + NST * STAGE;  // KV8: [buffer][K, V]
  static constexpr int SC_OFF = CONV_OFF + (KV8 ? NCONV * 2 * TILE16 : 0);  // KV8: [stage][ks | vs]
  static constexpr int WSC_OFF = SC_OFF + (KV8 ? NST * 2 * BK * 4 : 0);  // KV8: [buffer][ks | vs]
  static constexpr int SMEM = 1024 + WSC_OFF + (KV8 ? NCONV * 2 * BK * 4 : 0);  // + alignment slack
  static_assert(SMEM <= 232448, "the block's shared memory");
  // the epilogue reuses the ring: warpgroup 1's state, the merge's weights
  static_assert(NST * STAGE >= (D / 2 + 4) * 128 * 4, "the ring holds a warpgroup's state");
  static_assert(NST * STAGE >= 2 * MAX_SPLIT * 2 * BQ * 4, "the ring holds the merge's m and l");
};

template <typename T>
struct Args {
  const T* q;                     // (B, Ts, H, D)
  T* out;                         // (B, Ts, H, D)
  const __nv_bfloat16* ks;        // KV8: the layer's scales (B, S, Hkv)
  const __nv_bfloat16* vs;
  const int* start;               // (1,)
  float* work;                    // Z partials per row tile (Z > 1)
  int* counters;                  // one per row tile, 0 on entry and exit
  int t_len, n_head, n_kv, s_len, n_group, row_tiles, tiles_per_slice;
  int rows_per_block;             // 64 (tiles taken in turn) or 128 (in pairs)
  float scale;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// a landed int8 tile (BK rows of D bytes) into the 128-byte-swizzled T
// layout of a 16-bit tile, exact; thread i of n takes every n-th chunk
template <int D, typename T>
__device__ __forceinline__ void convert_i8(uint8_t* dst, const uint8_t* src, int i, int n) {
  using E = fs::Elem<T>;
  constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
  for (int idx = i; idx < BK * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + 16 * c);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t p[8];  // pairs of neighbouring columns
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[2 * k] = E::template i8x2<0>(w[k], w[k] >> 8);
      p[2 * k + 1] = E::template i8x2<2>(w[k], w[k] >> 8);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 16-bit chunk 2c + h: int8 columns 16c + 8h ..
      const int cc = 2 * c + h;
      *reinterpret_cast<uint4*>(dst + (cc / 8) * (64 * 128) + sw128(r, cc % 8)) =
          make_uint4(p[4 * h], p[4 * h + 1], p[4 * h + 2], p[4 * h + 3]);
    }
  }
}

// The last block's merge of a row tile's n_active partials (rows `br` of
// them, each m, l, then O) into out: the weights exp(m_z - max) / sum_z
// l_z exp(m_z - max) per row into shared memory, then each thread's NI
// groups of four columns of every slice, NI loads in flight at a time.
template <int D, int NI, typename T>
__device__ __forceinline__ void merge_partials(const float* parts, int ps, int br,
                                               int n_active, float* wm, float* wl,
                                               T* out_bh, int m0, int rows, int grp,
                                               int n_head, int hk) {
  using E = fs::Elem<T>;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < n_active * br; idx += CONSUMERS) {
    const float* pz = parts + (size_t)(idx / br) * ps;
    wm[idx] = __ldcg(pz + idx % br);
    wl[idx] = __ldcg(pz + br + idx % br);
  }
  bar_sync(1, CONSUMERS);
  for (int r = tid; r < br; r += CONSUMERS) {
    float mx = -INFINITY;
    for (int zz = 0; zz < n_active; ++zz) mx = fmaxf(mx, wm[zz * br + r]);
    float tot = 0.f;
    for (int zz = 0; zz < n_active; ++zz) {
      const float f = fs::attn::ex2((wm[zz * br + r] - mx) * fs::attn::kLog2e);
      wm[zz * br + r] = f;
      tot = fmaf(wl[zz * br + r], f, tot);
    }
    const float inv = 1.f / tot;
    for (int zz = 0; zz < n_active; ++zz) wm[zz * br + r] *= inv;
  }
  bar_sync(1, CONSUMERS);
  float4 acc[NI];
#pragma unroll
  for (int it = 0; it < NI; ++it) acc[it] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int zz = 0; zz < n_active; ++zz) {
    const float* pz = parts + (size_t)zz * ps + 2 * br;
    float4 v[NI];
    float f[NI];
#pragma unroll
    for (int it = 0; it < NI; ++it) {  // every load of the slice before any sum
      const int w = tid + it * CONSUMERS, r = w / (D / 4);
      v[it] = __ldcg(reinterpret_cast<const float4*>(pz + r * D + (w % (D / 4)) * 4));
      f[it] = wm[zz * br + r];
    }
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      acc[it].x = fmaf(v[it].x, f[it], acc[it].x);
      acc[it].y = fmaf(v[it].y, f[it], acc[it].y);
      acc[it].z = fmaf(v[it].z, f[it], acc[it].z);
      acc[it].w = fmaf(v[it].w, f[it], acc[it].w);
    }
  }
#pragma unroll
  for (int it = 0; it < NI; ++it) {
    const int w = tid + it * CONSUMERS, m = m0 + w / (D / 4);
    if (m >= rows) continue;
    T* dst = out_bh + ((size_t)(m / grp) * n_head + hk * grp + m % grp) * D +
             (w % (D / 4)) * 4;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(E::pack(acc[it].x, acc[it].y), E::pack(acc[it].z, acc[it].w));
  }
}

template <int D, bool KV8, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    suffix_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Args<T> a) {
  using L = Layout<D, KV8>;
  constexpr int NST = L::NST;
  using E = fs::Elem<T>;
  constexpr int KS = D / 16;  // k16 steps of S = Q K^T
  constexpr int NO = D / 2;   // O accumulators per thread
  constexpr float kLog2e = fs::attn::kLog2e;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  __shared__ int last_s;
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int rt = blockIdx.x % a.row_tiles, hk = blockIdx.x / a.row_tiles;
  const int b = blockIdx.y, z = blockIdx.z, n_split = gridDim.z;
  const int br = a.rows_per_block;
  const int grp = a.n_group, rows = a.t_len * grp;  // packed rows of (b, hk)
  const int m0 = rt * br, m_end = min(m0 + br, rows);
  const int start = a.start[0];
  const int lim = start + a.t_len;                     // keys [0, lim) exist
  const int lim_rt = start + (m_end - 1) / grp + 1;    // keys the row tile sees
  const int chunk = a.tiles_per_slice * BK;
  const int k_lo = z * chunk;
  if (k_lo >= lim_rt) return;  // the slice lies past the row tile's keys
  const int n_active = (lim_rt + chunk - 1) / chunk;
  const int n_tiles = (min(k_lo + chunk, lim_rt) - k_lo + BK - 1) / BK;
  const bool pair = a.rows_per_block == 2 * BQ;  // each warpgroup its own rows
  const int nst = pair ? NST : NST & ~1;           // stages in use (Layout)

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      fs::tma::bar_init(&full[s], KV8 ? 32 : 1);  // KV8: every producer lane's scales
      fs::tma::bar_init(&empty[s], pair ? 8 : 4);  // the warps that read the stage
    }
    fs::tma::bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    const int lane = tid - CONSUMERS;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % nst, k0 = k_lo + n * BK;
      if (n >= nst) fs::tma::bar_wait_sleep_or_trap(&empty[s], (n / nst - 1) & 1);
      if constexpr (KV8) {
        float* sc = reinterpret_cast<float*>(sm + L::SC_OFF) + s * 2 * BK;
        for (int e = lane; e < 2 * BK; e += 32) {
          const int key = k0 + e % BK;
          const __nv_bfloat16* src = e < BK ? a.ks : a.vs;
          sc[e] = key < lim
                      ? __bfloat162float(src[((size_t)b * a.s_len + key) * a.n_kv + hk])
                      : 0.f;
        }
      }
      if (lane == 0) {
        uint8_t* st = sm + L::RING_OFF + s * L::STAGE;
        const int row = b * a.s_len + k0;
        fs::tma::bar_expect(&full[s], L::STAGE);
        if constexpr (KV8) {
          fs::tma::load_3d(st, &kmap, &full[s], 0, hk, row);
          fs::tma::load_3d(st + L::TILE8, &vmap, &full[s], 0, hk, row);
        } else {
#pragma unroll
          for (int bx = 0; bx < L::DB; ++bx) {
            fs::tma::load_3d(st + bx * L::BLOCK, &kmap, &full[s], 64 * bx, hk, row);
            fs::tma::load_3d(st + L::TILE16 + bx * L::BLOCK, &vmap, &full[s], 64 * bx,
                             hk, row);
          }
        }
      } else if constexpr (KV8) {
        fs::tma::bar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  // the threads that share a tile, this one's index among them, and their
  // named barrier: the block (pairs) or the warpgroup (turns)
  const int n_share = pair ? CONSUMERS : 128, i_share = pair ? tid : t;
  const int bar_id = pair ? 1 : 2 + wg;
  const int wrow0 = pair ? BQ * wg : 0;  // the warpgroup's first row in the block

  // the block's Q rows (zero past `rows`): one 64-row tile per warpgroup
  // with pairs, one shared tile with turns
  {
    constexpr int CH = D / 8;  // 16-byte chunks of a row
    for (int idx = tid; idx < br * CH; idx += CONSUMERS) {
      const int r = idx / CH, c = idx % CH, m = m0 + r;
      const bool valid = m < rows;
      const T* src = a.q + (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp +
                            m % grp) * D + 8 * c;
      cp_async16(sm + L::Q_OFF + (r / BQ) * L::TILE16 + (c / 8) * L::BLOCK +
                     sw128(r % BQ, c % 8), valid ? src : a.q, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(1, CONSUMERS);
  }

  // this thread's rows: row_a and row_a + 8 of its warpgroup's tile; the
  // last key each sees (a padding row past `rows` sees what the last row
  // sees)
  const int row_a = 16 * warp + g;
  int vis[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    vis[e] = start + min(m0 + wrow0 + row_a + 8 * e, rows - 1) / grp;
  const int vis_first = start + min(m0 + wrow0, rows - 1) / grp;  // the fewest

  float s[32], o[NO];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(sm + L::Q_OFF + (pair ? wg : 0) * L::TILE16);
  // software pipeline of a warpgroup's tiles: S of its tile j and P V of
  // its tile j - 1 go out together; tile j's mask and softmax run while
  // P V runs; P V is retired, O rescaled, and only then tile j's P (kept
  // in fp32 in S's registers meanwhile) packed into the fragments that P V
  // read. The last tile's P V follows the walk. No branch splits the
  // wgmmas (ptxas would serialize them, C7520): before the first tile the
  // P V adds P = 0 times the Q tile (finite values) in place of a V.
  uint32_t pc[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pc[kk][r] = 0u;
  uint32_t prev_va = qa;  // the tile before's V (shared address)
  int prev_st = -1;       // and its stage (16-bit: released once P V retires)
  auto release = [&](int stage_index) {  // the stage is read: refill it
    fs::tma::fence_proxy_async();
    __syncwarp();
    if (lane == 0) fs::tma::bar_arrive(&empty[stage_index]);
  };
  auto v_descs = [&](uint32_t va, uint64_t (&dv)[4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dv[kk] = sw128_desc_mn(va + kk * 16 * 128, L::BLOCK);
      asm volatile("" : "+l"(dv[kk]));
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pc[kk][r]));
    }
  };

  int j = 0;  // this warpgroup's tiles so far
  for (int n = pair ? 0 : wg; n < n_tiles; n += pair ? 1 : 2, ++j) {
    const int st = n % nst, k0 = k_lo + n * BK;
    uint8_t* stage = sm + L::RING_OFF + st * L::STAGE;
    fs::tma::bar_wait_or_trap(&full[st], (n / nst) & 1);
    const uint8_t* kt = stage;
    uint8_t* vt = stage + L::TILE16;
    // KV8: the converted tiles' buffer: the warpgroup's two in turn, or
    // three by tile for pairs
    const int cb = pair ? n % 3 : 2 * wg + j % 2;
    float* wsc = reinterpret_cast<float*>(sm + L::WSC_OFF) + cb * 2 * BK;
    if constexpr (KV8) {
      uint8_t* conv = sm + L::CONV_OFF + cb * 2 * L::TILE16;
      // turns: the warpgroup is past its tile j - 1, which retired the P V
      // of tile j - 2, this buffer's last; pairs: buffer n % 3 was tile
      // n - 3's, whose P V both warpgroups retired before the barrier of
      // tile n - 1
      if (!pair) bar_sync(bar_id, 128);
      convert_i8<D, T>(conv, stage, i_share, n_share);
      convert_i8<D, T>(conv + L::TILE16, stage + L::TILE8, i_share, n_share);
      if (i_share < 2 * BK)
        wsc[i_share] = reinterpret_cast<const float*>(sm + L::SC_OFF)[st * 2 * BK + i_share];
      // the stage's generic reads come before its refill by the TMA, the
      // converted tiles' generic writes before the wgmmas read them
      release(st);
      bar_sync(bar_id, n_share);
      kt = conv;
      vt = conv + L::TILE16;
    } else if (k0 + BK > lim) {
      // keys past lim: their V rows to 0, so that P = 0 times them is 0
      for (int idx = i_share; idx < BK * L::DB * 8; idx += n_share) {
        const int r = idx / (L::DB * 8), c = idx % (L::DB * 8);
        if (k0 + r >= lim)
          *reinterpret_cast<uint4*>(vt + (c / 8) * L::BLOCK + r * 128 + (c % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      fs::tma::fence_proxy_async();
      bar_sync(bar_id, n_share);
    }

    // S = Q K^T of tile j, then P V of tile j - 1, both in flight; every
    // descriptor and fragment is built before the wgmma fence
    const uint32_t ka = smem_u32(kt);
    uint64_t dq[KS], dk[KS], dv[4];
#pragma unroll
    for (int f = 0; f < KS; ++f) {
      dq[f] = sw128_desc(qa + (f / 4) * L::BLOCK + (f % 4) * 32);
      dk[f] = sw128_desc(ka + (f / 4) * L::BLOCK + (f % 4) * 32);
      asm volatile("" : "+l"(dq[f]), "+l"(dk[f]));
    }
    v_descs(prev_va, dv);
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < KS; ++f) wgmma_m64n64k16_ss<T>(s, dq[f], dk[f], f > 0);
    wgmma_commit();
    fs::attn::pv_wgmma<D, T>(o, pc, dv);
    wgmma_commit();
    wgmma_wait<1>();  // S is retired; P V runs under the softmax
    fence_regs(s);

    // scale and mask; s[i] is row row_a + 8 ((i / 2) % 2), key
    // k0 + 8 (i / 4) + 2 tq + i % 2
    const bool need_mask = k0 + BK - 1 > vis_first || k0 + BK > lim;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int jj = 8 * (i / 4) + 2 * tq + i % 2, key = k0 + jj;
      float x = KV8 ? s[i] * (wsc[jj] * a.scale) : s[i] * a.scale;
      if (need_mask)
        x = key >= lim ? -INFINITY : (key <= vis[(i / 2) % 2] ? x : fs::kMaskedScore);
      s[i] = x;
    }
    // online softmax: the row max over the quad; every tile walked has a key
    // below lim, so the new max is finite
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = m_run[e];
#pragma unroll
      for (int i = 2 * e; i < 32; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(fs::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(fs::kFullMask, mx, 2));
      alpha[e] = fs::attn::ex2((m_run[e] - mx) * kLog2e);  // 0 on the first tile
      m_run[e] = mx;
      l_run[e] *= alpha[e];
    }
    // p in fp32, in place: pc is still read by the P V in flight
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = fs::attn::ex2((s[i] - m_run[(i / 2) % 2]) * kLog2e);
      l_run[(i / 2) % 2] += s[i];
    }
    // retire P V of tile j - 1 (and free its stage), rescale O to this
    // tile's max, and pack P's A fragments: register r of k16 step kk is
    // row (r % 2), keys 16 kk + 8 (r / 2) + 2 tq, +1: accumulators 8 kk +
    // 2 r, +1 (KV8: times vs), rounded to T
    wgmma_wait<0>();
    fence_regs(o);
    if (!KV8 && j > 0) release(prev_st);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, jj = 8 * (i / 4) + 2 * tq;
        pc[kk][r] = KV8 ? E::pack(s[i] * wsc[BK + jj], s[i + 1] * wsc[BK + jj + 1])
                        : E::pack(s[i], s[i + 1]);
      }
    prev_va = smem_u32(vt);
    prev_st = st;
  }
  {  // the last tile's P V (P = 0 for a warpgroup that took no tile)
    uint64_t dv[4];
    v_descs(prev_va, dv);
    fence_regs(o);
    wgmma_fence();
    fs::attn::pv_wgmma<D, T>(o, pc, dv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  if (!KV8 && j > 0) release(prev_st);

  // l over the quad. With turns, warpgroup 1's state joins warpgroup 0's
  // through the ring (every tile has landed and been read by now): the same
  // thread of each holds the same rows and columns
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(fs::kFullMask, l_run[e], 1);
    l_run[e] += __shfl_xor_sync(fs::kFullMask, l_run[e], 2);
  }
  float* xs = reinterpret_cast<float*>(sm + L::RING_OFF);
  bar_sync(1, CONSUMERS);
  if (!pair) {
    if (wg == 1) {  // [NO + 4][128]
#pragma unroll
      for (int i = 0; i < NO; ++i) xs[i * 128 + t] = o[i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        xs[(NO + e) * 128 + t] = m_run[e];
        xs[(NO + 2 + e) * 128 + t] = l_run[e];
      }
    }
    bar_sync(1, CONSUMERS);
    if (wg == 0) {
      float f0[2], f1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m1 = xs[(NO + e) * 128 + t], l1 = xs[(NO + 2 + e) * 128 + t];
        const float mx = fmaxf(m_run[e], m1);  // finite: warpgroup 0 saw a tile
        f0[e] = fs::attn::ex2((m_run[e] - mx) * kLog2e);
        f1[e] = fs::attn::ex2((m1 - mx) * kLog2e);  // 0 if warpgroup 1 saw none
        m_run[e] = mx;
        l_run[e] = l_run[e] * f0[e] + l1 * f1[e];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int e = (i / 2) % 2;
        o[i] = o[i] * f0[e] + xs[i * 128 + t] * f1[e];
      }
    }
  }
  const size_t tile_id = ((size_t)b * a.n_kv + hk) * a.row_tiles + rt;
  const int ps = br * (2 + D);  // floats of one partial: m, l, then O
  if (pair || wg == 0) {  // the warpgroups that hold rows
    float* part = a.work + (tile_id * n_split + z) * ps;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wrow0 + row_a + 8 * e, m = m0 + r;
      if (n_active == 1) {  // the row tile's one slice: O / l in T
        if (m >= rows) continue;
        const float inv = 1.f / l_run[e];
        T* dst = a.out + (((size_t)b * a.t_len + m / grp) * a.n_head + hk * grp + m % grp) * D +
                 2 * tq;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int i = 4 * c + 2 * e;
          *reinterpret_cast<uint32_t*>(dst + 8 * c) = E::pack(o[i] * inv, o[i + 1] * inv);
        }
      } else {
        if (tq == 0) {
          part[r] = m_run[e];
          part[br + r] = l_run[e];
        }
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int i = 4 * c + 2 * e;
          *reinterpret_cast<float2*>(part + 2 * br + r * D + 8 * c + 2 * tq) =
              make_float2(o[i], o[i + 1]);
        }
      }
    }
  }
  if (n_active == 1) return;
  // the last of the row tile's active slices merges their partials in
  // slice order and puts the counter back to 0
  bar_sync(1, CONSUMERS);  // the block's partial is stored: publish it
  if (tid == 0)
    last_s = fs::atomic_add_acq_rel(a.counters + tile_id, 1) == n_active - 1;
  bar_sync(1, CONSUMERS);
  if (!last_s) return;
  const float* parts = a.work + tile_id * n_split * ps;
  T* out_bh = a.out + (size_t)b * a.t_len * a.n_head * D;
  constexpr int NI = 2 * BQ * D / 4 / CONSUMERS;  // groups of four columns a thread
  if (pair)
    merge_partials<D, NI, T>(parts, ps, br, n_active, xs, xs + MAX_SPLIT * 2 * BQ, out_bh,
                             m0, rows, grp, a.n_head, hk);
  else
    merge_partials<D, NI / 2, T>(parts, ps, br, n_active, xs, xs + MAX_SPLIT * 2 * BQ,
                                 out_bh, m0, rows, grp, a.n_head, hk);
  if (tid == 0) a.counters[tile_id] = 0;
}

// The TMA map of one cache layer, (B, S, Hkv, D) of T (16-bit: boxes of 64
// dims x 1 head x BK keys, 128-byte swizzle) or int8 (boxes of D bytes x 1
// head x BK keys, plain), read as D x Hkv x (B * S)
template <typename T, bool KV8>
int cache_map(CUtensorMap* map, const void* base, int batch, int s_len, int n_kv,
              int head_dim) {
  const int esize = KV8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)head_dim, (cuuint64_t)n_kv,
                              (cuuint64_t)batch * s_len};
  const cuuint64_t strides[2] = {(cuuint64_t)head_dim * esize,
                                 (cuuint64_t)n_kv * head_dim * esize};
  const cuuint32_t box[3] = {KV8 ? (cuuint32_t)head_dim : 64u, 1u, (cuuint32_t)BK};
  const CUtensorMapDataType type = KV8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : fs::Elem<T>::kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fs::tma::encode(map, type, 3, base, dims, strides, box,
                         KV8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool KV8, typename T>
int launch(const void* k, const void* v, const Args<T>& a, int batch, int n_split,
           cudaStream_t stream) {
  constexpr int smem = Layout<D, KV8>::SMEM;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        suffix_wgmma_kernel<D, KV8, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  CUtensorMap kmap, vmap;
  int rc = cache_map<T, KV8>(&kmap, k, batch, a.s_len, a.n_kv, D);
  if (rc == 0) rc = cache_map<T, KV8>(&vmap, v, batch, a.s_len, a.n_kv, D);
  if (rc != 0) return rc;
  dim3 grid(a.row_tiles * a.n_kv, batch, n_split);
  suffix_wgmma_kernel<D, KV8, T><<<grid, THREADS, smem, stream>>>(kmap, vmap, a);
  return (int)cudaGetLastError();
}

}  // namespace sfx

// the tensor-core suffix over a cache of T or an int8 cache (kv8)
template <typename T>
int launch_suffix_wgmma(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const int* st,
                        void* out, float* work, int* counters, int batch,
                        int t_len, int n_head, int n_kv, int head_dim, int seq,
                        bool kv8, int rows_per_block, int n_split,
                        int tiles_per_slice, float scale, cudaStream_t s) {
  sfx::Args<T> a;
  a.q = static_cast<const T*>(q);
  a.out = static_cast<T*>(out);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.start = st;
  a.work = work;
  a.counters = counters;
  a.t_len = t_len;
  a.n_head = n_head;
  a.n_kv = n_kv;
  a.s_len = seq;
  a.n_group = n_head / n_kv;
  a.rows_per_block = rows_per_block;
  a.row_tiles = (t_len * a.n_group + rows_per_block - 1) / rows_per_block;
  a.tiles_per_slice = tiles_per_slice;
  a.scale = scale;
  if (head_dim == 128)
    return kv8 ? sfx::launch<128, true>(k, v, a, batch, n_split, s)
               : sfx::launch<128, false>(k, v, a, batch, n_split, s);
  if (head_dim == 64)
    return kv8 ? sfx::launch<64, true>(k, v, a, batch, n_split, s)
               : sfx::launch<64, false>(k, v, a, batch, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// the fp32 suffix route at head dim D
template <int D>
int launch_suffix_fp32(const void* q, const void* k, const void* v,
                       const void* ksc, const void* vsc, const int* start,
                       void* out, int batch, int t_len, int seq, int n_head,
                       int n_kv, bool kv8, float scale, cudaStream_t s) {
  if (kv8)
    return launch_prefill<float, int8_t, D, true, true>(
        q, k, v, ksc, vsc, start, out, batch, t_len, seq, n_head, n_kv, scale, s);
  return launch_prefill<float, float, D, true, false>(
      q, k, v, nullptr, nullptr, start, out, batch, t_len, seq, n_head, n_kv,
      scale, s);
}

}  // namespace

extern "C" int fs_flash_prefill(const void* q, const void* k, const void* v,
                                const void* offsets, void* out, int batch,
                                int t_len, int n_head, int n_kv, int head_dim,
                                int dtype, float scale, void* stream) {
  if (batch < 1 || t_len < 1 || n_kv < 1 || n_head % n_kv != 0)
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16)  // "wgmma"
    return launch_prefill_wgmma<__nv_bfloat16>(q, k, v, off, out, batch, t_len,
                                               n_head, n_kv, head_dim, scale, s);
  if (dtype == fs::kFloat16)  // "wgmma_f16"
    return launch_prefill_wgmma<__half>(q, k, v, off, out, batch, t_len, n_head,
                                        n_kv, head_dim, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 128)  // "cuda_cores"
    return launch_prefill<float, float, 128, false, false>(
        q, k, v, nullptr, nullptr, off, out, batch, t_len, t_len, n_head, n_kv,
        scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_prefill<float, float, 64, false, false>(
        q, k, v, nullptr, nullptr, off, out, batch, t_len, t_len, n_head, n_kv,
        scale, s);
  if (dtype == fs::kFloat32 && head_dim == 32)  // the tiny model's slow stack
    return launch_prefill<float, float, 32, false, false>(
        q, k, v, nullptr, nullptr, off, out, batch, t_len, t_len, n_head, n_kv,
        scale, s);
  return (int)cudaErrorInvalidValue;
}

// q (B, T, H, D) bf16, fp16 or fp32; k/v one layer of the stacked cache,
// (B, seq, Hkv, D) of q's dtype or int8 (kv8, with ks/vs (B, seq, Hkv) bf16); start (1,) int32
// on the device; out (B, T, H, D). The caller keeps start + T <= seq. The
// 16-bit routes take blocks of rows_per_block (64 or 128) packed rows of
// each (b, kv) and split the keys into n_split slices of tiles_per_slice
// 64-key tiles (`ops/flash_prefill.py:suffix_plan`; every key lies in
// one); with n_split > 1 they need work, n_split fp32 partials of
// rows_per_block * (2 + D) floats per row tile, and counters, one int32
// per row tile, all 0 on entry (the kernel leaves them 0). The fp32 routes
// ignore those five.
extern "C" int fs_flash_suffix(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* start,
                               void* out, void* work, void* counters, int batch,
                               int t_len, int n_head, int n_kv, int head_dim,
                               int seq, int dtype, int kv8, int rows_per_block,
                               int n_split, int tiles_per_slice, float scale,
                               void* stream) {
  if (batch < 1 || t_len < 1 || n_kv < 1 || n_head % n_kv != 0 || seq < t_len)
    return (int)cudaErrorInvalidValue;
  if (kv8 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16 || dtype == fs::kFloat16) {
    if ((rows_per_block != sfx::BQ && rows_per_block != 2 * sfx::BQ) ||
        n_split < 1 || n_split > sfx::MAX_SPLIT || tiles_per_slice < 1 ||
        (long long)n_split * tiles_per_slice * sfx::BK < seq ||
        (n_split > 1 && (work == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    float* wk = static_cast<float*>(work);
    int* cnt = static_cast<int*>(counters);
    if (dtype == fs::kBFloat16)  // "suffix_wgmma", "suffix_kv8_wgmma"
      return launch_suffix_wgmma<__nv_bfloat16>(q, k, v, ks, vs, st, out, wk, cnt,
                                                batch, t_len, n_head, n_kv, head_dim,
                                                seq, kv8 != 0, rows_per_block, n_split,
                                                tiles_per_slice, scale, s);
    // "suffix_wgmma_f16", "suffix_kv8_wgmma_f16"
    return launch_suffix_wgmma<__half>(q, k, v, ks, vs, st, out, wk, cnt, batch,
                                       t_len, n_head, n_kv, head_dim, seq, kv8 != 0,
                                       rows_per_block, n_split, tiles_per_slice,
                                       scale, s);
  }
  if (dtype == fs::kFloat32 && head_dim == 128)  // "suffix_cuda_cores", "suffix_kv8_..."
    return launch_suffix_fp32<128>(q, k, v, ks, vs, st, out, batch, t_len, seq,
                                   n_head, n_kv, kv8 != 0, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_suffix_fp32<64>(q, k, v, ks, vs, st, out, batch, t_len, seq,
                                  n_head, n_kv, kv8 != 0, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 32)  // the tiny model's slow stack
    return launch_suffix_fp32<32>(q, k, v, ks, vs, st, out, batch, t_len, seq,
                                  n_head, n_kv, kv8 != 0, scale, s);
  return (int)cudaErrorInvalidValue;
}
