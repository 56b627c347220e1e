// Attention of one query position over one layer of a stacked KV cache.
//
// Replaces the Pallas TPU kernel fish_speech_tpu/ops/pallas_decode.py
// (_decode_kernel / flash_decode_attention): row b attends its first
// lengths[b] cache positions with a float32 online softmax, or, given
// per-row `starts`, positions [starts[b], lengths[b]) (the lockstep batch's
// left pad masked out, the JAX einsum's `kv_valid`). The G query
// heads that share a KV head are served together, so each K/V row is read
// from device memory once per step, not once per query head.
//
// What bounds it on the H100: decode attention does 2*G multiply-adds per
// K/V element it reads, far below the ~295 operations per byte at which the
// card stops being memory-bound, so its time is bytes moved: 2 * len * Hkv *
// D * 2 bytes per layer in bf16. It reads only the first lengths[b]
// positions, so no fixed-length buckets are needed.
//
// Design: flash-decoding in one launch. The grid is (Hkv, B, Z): the
// wrapper picks Z from S and the card's SM count alone
// (`ops/flash_decode.py:decode_split_count`, about one block per SM at
// batch 1), never from `lengths`, so the launch is the same at every step
// and can be captured in a CUDA graph. Block z reads positions
// [z * chunk, (z + 1) * chunk) of [starts[b], lengths[b]), chunk = ceil(S
// / Z) rounded up to 16 (`slice_chunk`, mirrored by `decode_slice`; a chunk
// cut from the row's length instead measured slower at len 4000 and no
// faster at 2048); a block whose slice is empty (past the length or wholly
// before the start) returns at once, and only the slices with work merge.
// The slice's K and V rows stream into a ring of three 32 KB stages in shared memory
// (two blocks fit an SM), all in flight at once. bf16 runs on the tensor
// cores (`decode_mma_kernel`): one thread asks the TMA for each stage's
// boxes (64 dims x 64 positions, 128-byte swizzle) against an mbarrier,
// and each warp takes tiles of 16 positions, S^T = Q K^T and O += P V by
// mma.sync with one max and one rescale per tile (P as two bf16 terms).
// fp32 runs on the CUDA cores (`decode_kernel`): 16-byte cp.async into
// XOR-swizzled stages, 16-byte pieces per lane, a shuffle sum per score,
// one max and one rescale per warp and stage. The warps' states merge
// through shared memory. A lone active slice writes `out` itself;
// otherwise each block writes its (m, l, acc) partial to a workspace and,
// after a barrier, one thread bumps a per-(b, hk) counter with a
// release-acquire atomic; the block that arrives last merges the partials
// in split order (deterministic; no atomics on data), writes `out` and
// puts the counter back to 0. The workspace and counters are allocated
// once per device by the wrapper, so a call allocates and memsets nothing
// and launches one kernel.
//
// The int8-KV variant (fs_flash_decode_kv8) serves the slow stack under the
// int8 KV cache, where the JAX package ran the einsum of
// fish_speech_tpu/ops/attention.py:66-104 (gqa_attention_kv8; no Pallas
// kernel). It reads int8 K/V rows and their bf16 per-(position, head)
// scales and folds the scales in as that einsum does: score = (q . k_i8) *
// ks * 1/sqrt(d), online fp32 softmax, accumulator += (p * vs) * v_i8. Half
// the bytes of the bf16 cache (plus 4 bytes of scales per row and head),
// so at the serving lengths the launch and the merge, not the bytes, set
// its time. It has the bf16 kernel's design: the same split, slices, ring
// (TMA boxes of int8 rows) and merge by the last block, one launch and no
// allocation; bf16 q runs on the tensor cores (`decode_kv8_mma_kernel`,
// int8 -> bf16 in registers), fp32 q on the CUDA cores (`decode_kv8_kernel`).
//
// fp16 (the `--half` serving path): `decode_mma_kernel` and
// `decode_kv8_mma_kernel` are templated on the 16-bit type T (common.cuh
// `Elem`) and run in fp16 on mma.sync's `.f16` operands, with the bf16
// forms' split, ring and merge. P (and, under the int8 cache, p * vs) keeps
// the bf16 forms' two terms, hi = rn_f16(p) and lo = rn_f16(p - hi): 22
// significant bits where one fp16 term would keep 11, so the plain version
// models p in fp32 as for bf16 (`ops/flash_decode.py`); a term below
// fp16's normal range (2^-14) keeps fp16's subnormal steps (2^-24). The
// int8 cache's scales stay bf16 and the int8 values go to fp16 exactly.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAXG = 8;       // query heads per KV head served by one block
constexpr int UNROLL = 4;     // positions per warp iteration, fp32 int8-KV

constexpr int SLICE_ALIGN = 16;   // slice lengths are multiples of this
constexpr int MAX_SPLIT = 64;     // most blocks over one (b, hk) row
constexpr int STAGE_BYTES = 32768;  // K and V rows of one stage of the ring
constexpr int STAGES = 3;         // stages of the ring: two blocks fit an SM
constexpr int ML = 2 * MAXG;      // a partial's (m, l) ahead of its acc
constexpr int CW = 8;             // warps per block, CUDA-core (fp32) kernel
constexpr int TW = 4;             // warps per block, tensor-core (bf16) kernel

// Positions per slice of a cache of S positions split Z ways: ceil(S / Z)
// rounded up to SLICE_ALIGN (`ops/flash_decode.py:decode_slice`). The
// chunk comes from S, not from the row's length: a chunk cut from the
// length measured slower at len 4000 and no faster at 2048 (PERF.md).
__host__ __device__ __forceinline__ int slice_chunk(int s_len, int n_split) {
  const int c = (s_len + n_split - 1) / n_split;
  const int a = (c + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN;
  return a > SLICE_ALIGN ? a : SLICE_ALIGN;
}

// positions of one stage: the K and V rows of SP positions fill STAGE_BYTES
template <typename T, int D>
__host__ __device__ constexpr int stage_positions() {
  return STAGE_BYTES / (2 * D * (int)sizeof(T));
}

// stages of the ring: STAGES, or fewer where a slice has fewer
template <typename T, int D>
__host__ __device__ __forceinline__ int ring_stages(int s_len, int n_split) {
  constexpr int SP = stage_positions<T, D>();
  const int subs = (slice_chunk(s_len, n_split) + SP - 1) / SP;
  return subs < STAGES ? subs : STAGES;
}

// element offset of the 16-byte piece c of row j of a stage: the pieces of
// eight neighbouring rows are spread over the banks (XOR with j % 8). A row
// of fewer than eight pieces (fp32 at D = 16: four) XORs within its own
// pieces: eight lanes then read two whole neighbouring rows, 128 bytes
// without a conflict.
template <typename T, int D>
__device__ __forceinline__ int swz(int j, int c) {
  constexpr int PIECES = D * (int)sizeof(T) / 16;
  constexpr int MASK = (PIECES < 8 ? PIECES : 8) - 1;
  return j * D + ((c ^ (j & MASK)) << 4) / (int)sizeof(T);
}

// 8 bf16 or 4 fp32 values of one 16-byte load, as fp32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& w, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
  } else {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
}

// Merge the first n_active partials of one (b, hk) row into out_bh (G x D),
// in split order, 32 at a time. A partial is ML + G * D floats: its max
// (log2 units) per head, its sum per head, then the unnormalised
// accumulator. A thread takes four d of one head and loads up to 32
// partials at once, so a row of up to 32 slices is one round trip.
template <typename T, int D>
__device__ void merge_partials(const float* part, int n_active, int n_group,
                               T* out_bh) {
  const int stride = ML + n_group * D;
  constexpr int ZU = 32;
  for (int t = threadIdx.x; t < n_group * D / 4; t += blockDim.x) {
    const int g = t / (D / 4), d = (t % (D / 4)) * 4;
    float mx = -INFINITY, tot = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z0 = 0; z0 < n_active; z0 += ZU) {
      float4 a[ZU];
      float mz[ZU], lz[ZU];
#pragma unroll
      for (int u = 0; u < ZU; ++u)
        if (z0 + u < n_active) {
          const float* st = part + (size_t)(z0 + u) * stride;
          mz[u] = __ldcg(st + g);
          lz[u] = __ldcg(st + MAXG + g);
          a[u] = __ldcg(reinterpret_cast<const float4*>(st + ML + g * D + d));
        }
      // the batch's max first, so its weights do not wait on each other
      float m_new = mx;
#pragma unroll
      for (int u = 0; u < ZU; ++u)
        if (z0 + u < n_active) m_new = fmaxf(m_new, mz[u]);
      const float r = exp2f(mx - m_new);  // 0 on the first batch
      tot *= r;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] *= r;
      mx = m_new;
#pragma unroll
      for (int u = 0; u < ZU; ++u) {
        if (z0 + u >= n_active) break;
        const float f = exp2f(mz[u] - mx);
        tot = fmaf(lz[u], f, tot);
        o[0] = fmaf(a[u].x, f, o[0]); o[1] = fmaf(a[u].y, f, o[1]);
        o[2] = fmaf(a[u].z, f, o[2]); o[3] = fmaf(a[u].w, f, o[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) fs::store(out_bh + g * D + d + e, o[e] / tot);
  }
}

// Copies positions [p0, p0 + SP) ∩ [.., end) of K and V into a stage of
// the ring (rows past `end` zero-filled; pieces in `swz` order) and commits
// them as one group.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_stage(T* stage, const T* kb, const T* vb,
                                           size_t row_stride, int p0, int end) {
  constexpr int SP = stage_positions<T, D>();
  constexpr int PIECES = D * (int)sizeof(T) / 16;  // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < 2 * SP * PIECES; idx += THREADS) {
    const int kv = idx / (SP * PIECES), j = (idx / PIECES) % SP, c = idx % PIECES;
    const bool valid = p0 + j < end;
    const T* src = (kv ? vb : kb) + (size_t)(valid ? p0 + j : p0) * row_stride +
                   c * 16 / (int)sizeof(T);
    fs::wg::cp_async16(stage + kv * SP * D + swz<T, D>(j, c), src, valid);
  }
  fs::wg::cp_async_commit();
}

__device__ __forceinline__ void wait_stage(int n_stages) {
  // the oldest of the n_stages groups in flight has landed
  if (n_stages == 1) fs::wg::cp_async_wait<0>();
  else if (n_stages == 2) fs::wg::cp_async_wait<1>();
  else if (n_stages == 3) fs::wg::cp_async_wait<2>();
  else fs::wg::cp_async_wait<3>();
}

// The slice of block (hk, b, z) within the row's visible positions [lo,
// len), lo = starts[b] (0 without `starts`): returns false (after writing
// 0 for a row with no visible position) when the block has nothing to do.
// The slices keep their places in the split: slice z covers [z * chunk,
// (z + 1) * chunk) ∩ [lo, len), so the slices wholly before lo or past len
// are empty and their blocks return; `first` is the first slice with work
// and `n_active` the number of slices with work, whose partials the row's
// last block merges (`block_finish`).
template <typename T, int D>
__device__ __forceinline__ bool block_slice(const int* lengths,
                                            const int* starts, T* out_bh,
                                            int s_len, int n_group, int& start,
                                            int& end, int& first,
                                            int& n_active) {
  const int z = blockIdx.z, n_split = gridDim.z;
  const int len = min(max(lengths[blockIdx.y], 0), s_len);
  const int lo = starts ? min(max(starts[blockIdx.y], 0), len) : 0;
  if (lo == len) {  // no visible position: 0, as the old kernel gave
    if (z == 0)
      for (int idx = threadIdx.x; idx < n_group * D; idx += blockDim.x)
        fs::store(out_bh + idx, 0.f);
    return false;
  }
  const int chunk = slice_chunk(s_len, n_split);
  first = lo / chunk;
  const int last = (len + chunk - 1) / chunk;  // one past the last slice
  if (z < first || z >= last) return false;
  n_active = last - first;
  start = max(z * chunk, lo);
  end = min(z * chunk + chunk, len);
  return true;
}

// The block's warps have left their (m, l, acc) in sm_m [W][NG], sm_l
// [W][NG] and sm_acc [W][NG][AS] (rows AS >= D floats apart; m = -inf for
// a warp that saw no position). Merges them; a lone active slice writes
// `out`, otherwise the block writes its partial and the last of the row's
// n_active blocks merges the partials of slices first .. first + n_active
// - 1.
template <typename T, int D, int W, int NG, int AS = D>
__device__ void block_finish(const float* sm_m, const float* sm_l,
                             const float* sm_acc, T* out_bh, float* part,
                             int* counter, int n_group, int first,
                             int n_active) {
  __shared__ int last_s;
  const int z = blockIdx.z;
  const bool direct = n_active == 1;
  const int stride = ML + n_group * D;
  float* st = part + (size_t)z * stride;
  for (int idx = threadIdx.x; idx < n_group * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, sm_m[w * NG + g]);
    float tot = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = sm_m[w * NG + g];
      if (mw == -INFINITY) continue;  // the warp saw no position
      const float f = exp2f(mw - mx);
      tot += sm_l[w * NG + g] * f;
      o += sm_acc[(w * NG + g) * AS + d] * f;
    }
    if (direct) {
      fs::store(out_bh + idx, o / tot);
    } else {
      st[ML + idx] = o;
      if (d == 0) {
        st[g] = mx;
        st[MAXG + g] = tot;
      }
    }
  }
  if (direct) return;
  __syncthreads();  // the block's partial is stored: publish it
  if (threadIdx.x == 0)
    last_s = fs::atomic_add_acq_rel(counter, 1) == n_active - 1;
  __syncthreads();
  if (!last_s) return;
  merge_partials<T, D>(part + (size_t)first * stride, n_active, n_group, out_bh);
  if (threadIdx.x == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// fp32 (and any dtype): CUDA cores. Each of CW warps scores SP / CW
// positions of a stage for its G heads (NG >= n_group bounds the
// registers): lanes hold 16-byte pieces of a row, a shuffle sum per score,
// one max and one rescale per warp and stage. A row is D / 4 lanes (fp32),
// so a warp load takes 32 / (D / 4) rows: 2 at D = 128, 8 at D = 16 (the
// tiny model's fast stack), 4 at D = 32 (its slow stack).
// ---------------------------------------------------------------------------
template <typename T, int D, int NG>
__global__ void __launch_bounds__(CW * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  const int* __restrict__ starts, T* __restrict__ out,
                  float* __restrict__ work, int* __restrict__ counters,
                  int s_len, int n_kv, int n_group, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / VEC;         // lanes per K/V row
  constexpr int RPW = 32 / LPR;        // rows per warp load
  constexpr int SP = stage_positions<T, D>();
  constexpr int TP = SP / CW;          // positions per warp and stage
  constexpr int U = TP / RPW;          // rows per lane and stage
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "a row is whole lanes of a warp");
  static_assert(U * RPW * CW == SP, "a stage splits evenly over the warps");
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / LPR, li = lane % LPR;
  const size_t bh = (size_t)b * n_kv + hk;
  T* out_bh = out + bh * n_group * D;
  int start, end, first, n_active;
  if (!block_slice<T, D>(lengths, starts, out_bh, s_len, n_group, start, end,
                         first, n_active))
    return;
  const int n_stages = ring_stages<T, D>(s_len, gridDim.z);
  const int n_sub = (end - start + SP - 1) / SP;
  const size_t row_stride = (size_t)n_kv * D;  // elements between positions
  const T* kb = k + ((size_t)b * s_len * n_kv + hk) * D;
  const T* vb = v + ((size_t)b * s_len * n_kv + hk) * D;
  for (int st = 0; st < n_stages; ++st) {  // one group per stage, even if empty
    if (st < n_sub)
      load_stage<T, D, CW * 32>(ring + st * 2 * SP * D, kb, vb, row_stride,
                                start + st * SP, end);
    else
      fs::wg::cp_async_commit();
  }

  float qr[NG][VEC], m[NG], l[NG], acc[NG][VEC];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    float f[VEC];
    if (g < n_group)
      unpack16<T>(*reinterpret_cast<const uint4*>(q + (bh * n_group + g) * D +
                                                  li * VEC), f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] = g < n_group ? f[e] : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int sub = 0; sub < n_sub; ++sub) {
    wait_stage(n_stages);
    __syncthreads();
    const T* ks = ring + (sub % n_stages) * 2 * SP * D;
    const T* vs = ks + SP * D;
    if (start + sub * SP + warp * TP < end) {  // the warp's first position
      float s[U][NG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = warp * TP + u * RPW + rg;  // row in the stage
        float kf[VEC];
        unpack16<T>(*reinterpret_cast<const uint4*>(ks + swz<T, D>(j, li)), kf);
        const bool valid = start + sub * SP + j < end;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(fs::kFullMask, d, o);
          s[u][g] = valid ? d * scale_log2 : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float mt = s[0][g];
#pragma unroll
        for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[u][g]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, o));
        const float m_new = fmaxf(m[g], mt);
        const float a = exp2f(m[g] - m_new);  // 0 on the warp's first tile
        l[g] *= a;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
        m[g] = m_new;
#pragma unroll
        for (int u = 0; u < U; ++u) s[u][g] = exp2f(s[u][g] - m_new);  // p; 0 if masked
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = warp * TP + u * RPW + rg;
        float vf[VEC];
        unpack16<T>(*reinterpret_cast<const uint4*>(vs + swz<T, D>(j, li)), vf);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          l[g] += s[u][g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (sub + n_stages < n_sub)
      load_stage<T, D, CW * 32>(ring + (sub % n_stages) * 2 * SP * D, kb, vb,
                                row_stride, start + (sub + n_stages) * SP, end);
    else
      fs::wg::cp_async_commit();
  }
  // the warps' states go where the ring was (every stage has been read)
  float* sm_m = reinterpret_cast<float*>(ring_raw);
  float* sm_l = sm_m + CW * NG;
  float* sm_acc = sm_l + CW * NG;
  // the row groups of a warp share its max: add their sums
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(fs::kFullMask, l[g], o);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] += __shfl_xor_sync(fs::kFullMask, acc[g][e], o);
    }
    if (lane == 0) {
      sm_m[warp * NG + g] = m[g];
      sm_l[warp * NG + g] = l[g];
    }
    if (rg == 0)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[(warp * NG + g) * D + li * VEC + e] = acc[g][e];
  }
  __syncthreads();
  block_finish<T, D, CW, NG>(sm_m, sm_l, sm_acc, out_bh,
                             work + bh * gridDim.z * (ML + n_group * D),
                             counters + bh, n_group, first, n_active);
}

// ---------------------------------------------------------------------------
// bf16 or fp16 (T): tensor cores (mma.sync m16n8k16, fp32 sums). A warp takes tiles of
// 16 positions: S^T = Q K^T with the G heads on M (rows past G are zero),
// the positions on N and D on K; one max and one rescale per tile; then
// O += P V with P as the A operand straight from S's registers and V read
// transposed by ldmatrix. The TPU kernel keeps p in fp32; here p is split
// into two T terms, hi = rn(p) and lo = rn(p - hi), and each takes one
// mma, so P keeps 16 significant bits in bf16 (|p - hi - lo| <= 2^-17 p)
// where one bf16 term would keep 8, and 22 in fp16. K and V rows come from the ring in
// `tswz` order, so ldmatrix reads eight rows without bank conflicts.
// ---------------------------------------------------------------------------
// d += a b, m16n8k16 with fp32 sums, the operands in T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  if constexpr (fs::Elem<T>::kF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fs::wg::smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fs::wg::smem_u32(p)));
}

// element offset of the 16-byte piece c of row j in a stage of the bf16
// kernel: TMA boxes of SP rows x 64 dims (128 bytes), the 128-byte swizzle
template <int SP>
__device__ __forceinline__ int tswz(int j, int c) {
  return (c >> 3) * SP * 64 + j * 64 + (((c & 7) ^ (j & 7)) << 3);
}

template <int D, typename T>
__global__ void __launch_bounds__(TW * 32)
    decode_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const T* __restrict__ q,
                      const int* __restrict__ lengths,
                      const int* __restrict__ starts,
                      T* __restrict__ out, float* __restrict__ work,
                      int* __restrict__ counters, int s_len, int n_kv,
                      int n_group, float scale_log2) {
  using E = fs::Elem<T>;
  constexpr int SP = stage_positions<T, D>();
  constexpr int KS = D / 16;  // k steps of S, n tiles of O
  constexpr int NBOX = D / 64, BOX = SP * 64;  // boxes per K (or V) stage
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  // the swizzled boxes want 1024-byte aligned stages (1 KB of slack)
  T* ring = reinterpret_cast<T*>(
      ring_raw + ((1024 - fs::wg::smem_u32(ring_raw) % 1024) % 1024));
  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;  // mma row group, thread in group
  const size_t bh = (size_t)b * n_kv + hk;
  T* out_bh = out + bh * n_group * D;
  int start, end, first, n_active;
  if (!block_slice<T, D>(lengths, starts, out_bh, s_len, n_group, start, end,
                         first, n_active))
    return;
  const int n_stages = ring_stages<T, D>(s_len, gridDim.z);
  const int n_sub = (end - start + SP - 1) / SP;
  auto issue = [&](int slot, int sub) {  // thread 0: K and V boxes of a stage
    T* st = ring + slot * 2 * SP * D;
    fs::tma::bar_expect(&full[slot], STAGE_BYTES);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
#pragma unroll
      for (int bx = 0; bx < NBOX; ++bx)
        fs::tma::load_3d(st + (kv * NBOX + bx) * BOX, kv ? &vmap : &kmap,
                         &full[slot], 64 * bx, hk, b * s_len + start + sub * SP);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < n_stages; ++st) fs::tma::bar_init(&full[st]);
    fs::tma::bar_init_fence();
    for (int st = 0; st < n_stages && st < n_sub; ++st) issue(st, st);
  }
  __syncthreads();  // the barriers' init is visible

  // A of S^T: Q, head g (row g + 8 is zero), d pairs 2qd and 2qd + 8 of
  // each k step
  uint32_t qa[KS][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(q + (bh * n_group + g) * D);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    qa[s][0] = g < n_group ? qrow[8 * s + qd] : 0u;
    qa[s][1] = g < n_group ? qrow[8 * s + 4 + qd] : 0u;
  }
  float m = -INFINITY, l = 0.f;  // head g
  float acc[KS * 2][4];          // O[g][8 n + 2 qd, + 1] in [n][0..1]
#pragma unroll
  for (int n = 0; n < KS * 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix rows: lane l feeds row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  for (int sub = 0; sub < n_sub; ++sub) {
    const int slot = sub % n_stages;
    T* stage = ring + slot * 2 * SP * D;
    fs::tma::bar_wait(&full[slot], (sub / n_stages) & 1);
    const T* ks = stage;
    const T* vs = stage + NBOX * BOX;
    for (int t = warp; t * 16 < SP; t += TW) {
      const int pb = start + sub * SP + t * 16;  // the tile's first position
      if (pb >= end) break;
      // S^T (heads x 16 positions) in two n tiles of 8 positions
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // matrices: positions 0-7 / 8-15 (mi / 2) x d pieces 2kk, 2kk + 1 (mi % 2)
        uint32_t kf[4];
        const int j = t * 16 + (mi >> 1) * 8 + mr;
        ldsm4(kf, ks + tswz<SP>(j, 2 * kk + (mi & 1)));
        mma16<T>(s[0], qa[kk][0], 0u, qa[kk][1], 0u, kf[0], kf[1]);
        mma16<T>(s[1], qa[kk][0], 0u, qa[kk][1], 0u, kf[2], kf[3]);
      }
      // s[n][0..1]: head g, positions pb + 8 n + 2 qd, + 1
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = pb + 8 * n + 2 * qd + e < end;
          s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
          mt = fmaxf(mt, s[n][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, 2));
      const float m_new = fmaxf(m, mt);  // finite: position pb is valid
      const float a = exp2f(m - m_new);
      m = m_new;
      l *= a;
#pragma unroll
      for (int n = 0; n < KS * 2; ++n) {
        acc[n][0] *= a;
        acc[n][1] *= a;
      }
      // P as the A operand (positions 2qd.. and 8 + 2qd..), the fp32 p
      // carried as hi + lo, two T terms (16 significant bits in bf16, 22
      // in fp16)
      uint32_t phi[2], plo[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float p0 = exp2f(s[n][0] - m_new), p1 = exp2f(s[n][1] - m_new);
        l += p0 + p1;
        phi[n] = E::pack(p0, p1);
        plo[n] = E::pack(p0 - E::lo(phi[n]), p1 - E::hi(phi[n]));
      }
      // V rows past the slice may hold anything (even NaN): their B values
      // are zeroed, as 0 * NaN would not be 0. mv[h]: positions
      // 8 h + 2 qd, + 1 of the tile
      uint32_t mv[2] = {~0u, ~0u};
      if (pb + 16 > end)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mv[h] = (pb + 8 * h + 2 * qd < end ? 0x0000FFFFu : 0u) |
                  (pb + 8 * h + 2 * qd + 1 < end ? 0xFFFF0000u : 0u);
      // O (heads x D) += P (heads x 16 positions) V (16 positions x D)
#pragma unroll
      for (int pp = 0; pp < KS; ++pp) {
        // matrices: positions 0-7 / 8-15 (mi % 2) x d pieces 2pp, 2pp + 1 (mi / 2)
        uint32_t vf[4];
        const int j = t * 16 + (mi & 1) * 8 + mr;
        ldsm4_t(vf, vs + tswz<SP>(j, 2 * pp + (mi >> 1)));
        vf[0] &= mv[0]; vf[1] &= mv[1]; vf[2] &= mv[0]; vf[3] &= mv[1];
        mma16<T>(acc[2 * pp], phi[0], 0u, phi[1], 0u, vf[0], vf[1]);
        mma16<T>(acc[2 * pp + 1], phi[0], 0u, phi[1], 0u, vf[2], vf[3]);
        mma16<T>(acc[2 * pp], plo[0], 0u, plo[1], 0u, vf[0], vf[1]);
        mma16<T>(acc[2 * pp + 1], plo[0], 0u, plo[1], 0u, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0 && sub + n_stages < n_sub) issue(slot, sub + n_stages);
  }
  // the four lanes of head g hold parts of its sum
  l += __shfl_xor_sync(fs::kFullMask, l, 1);
  l += __shfl_xor_sync(fs::kFullMask, l, 2);
  // the warps' states go where the ring was (every stage has been read)
  float* sm_m = reinterpret_cast<float*>(ring);
  float* sm_l = sm_m + TW * MAXG;
  float* sm_acc = sm_l + TW * MAXG;
  if (qd == 0) {
    sm_m[warp * MAXG + g] = m;
    sm_l[warp * MAXG + g] = l;
  }
#pragma unroll
  for (int n = 0; n < KS * 2; ++n) {
    sm_acc[(warp * MAXG + g) * D + 8 * n + 2 * qd] = acc[n][0];
    sm_acc[(warp * MAXG + g) * D + 8 * n + 2 * qd + 1] = acc[n][1];
  }
  __syncthreads();
  block_finish<T, D, TW, MAXG>(sm_m, sm_l, sm_acc, out_bh,
                               work + bh * gridDim.z * (ML + n_group * D),
                               counters + bh, n_group, first, n_active);
}

// The TMA map of one layer of the cache, (B, S, Hkv, D) bf16 or fp16 (T)
// read as D x Hkv x (B * S) in boxes of 64 dims x 1 head x SP positions
// (encoded once and kept by `fs::tma::encode`).
template <typename T, int D>
int cache_map(CUtensorMap* map, const void* base, int batch, int s_len,
              int n_kv) {
  constexpr int SP = stage_positions<T, D>();
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n_kv,
                              (cuuint64_t)batch * s_len};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n_kv * D * 2};
  const cuuint32_t box[3] = {64, 1, SP};
  return fs::tma::encode(map,
                         fs::Elem<T>::kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, base, dims, strides, box);
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, const int* starts, void* out,
                  float* work, int* counters, int batch, int s_len,
                  int n_kv, int n_group, int n_split, float scale,
                  cudaStream_t stream) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr bool kTensorCores = !std::is_same<T, float>::value;
  // the ring, or the warps' states that take its place at the end
  const int warps = kTensorCores ? TW : CW, ng = kTensorCores || n_group > 4 ? MAXG : 4;
  const size_t smem =
      1024 + std::max((size_t)ring_stages<T, D>(s_len, n_split) * STAGE_BYTES,
                      sizeof(float) * warps * ng * (2 + D));
  dim3 grid(n_kv, batch, n_split);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  // one attribute call per kernel: up to STAGES stages of the ring
  static bool sized[3] = {false, false, false};
  const int which = kTensorCores ? 0 : n_group <= 4 ? 1 : 2;
  if (!sized[which]) {
    constexpr int most = 1024 + STAGES * STAGE_BYTES;
    cudaError_t e;
    if constexpr (kTensorCores)
      e = cudaFuncSetAttribute(decode_mma_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    else
      e = cudaFuncSetAttribute(which == 1 ? decode_kernel<T, D, 4> : decode_kernel<T, D, 8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    sized[which] = true;
  }
  if constexpr (kTensorCores) {
    CUtensorMap kmap, vmap;
    int rc = cache_map<T, D>(&kmap, k, batch, s_len, n_kv);
    if (rc == 0) rc = cache_map<T, D>(&vmap, v, batch, s_len, n_kv);
    if (rc != 0) return rc;
    decode_mma_kernel<D, T><<<grid, TW * 32, smem, stream>>>(
        kmap, vmap, qt, lengths, starts, ot, work, counters, s_len, n_kv,
        n_group, scale * kLog2e);
  } else if (n_group <= 4) {
    decode_kernel<T, D, 4><<<grid, CW * 32, smem, stream>>>(
        qt, kt, vt, lengths, starts, ot, work, counters, s_len, n_kv,
        n_group, scale * kLog2e);
  } else {
    decode_kernel<T, D, 8><<<grid, CW * 32, smem, stream>>>(
        qt, kt, vt, lengths, starts, ot, work, counters, s_len, n_kv,
        n_group, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 K/V with bf16 per-(position, head) scales: the bf16 kernels' split,
// ring and merge, with the einsum's scales folded in per position.
// ---------------------------------------------------------------------------

// p * vs enters P.V as this many bf16 terms: 2 carries it as hi + lo (16
// significant bits), 1 rounds it to bf16 once, as the JAX einsum rounds
// (weights * vs).astype(q.dtype) (ROADMAP §3 records the choice)
constexpr int KV8_PV_TERMS = 2;

// two exact fp32 integers (|v| <= 128) as a pair of T, exact: in bf16 their
// top halves (the low 16 bits of such an fp32 are 0), in fp16 by
// conversion (fp16 holds every integer up to 2048)
template <typename T>
__device__ __forceinline__ uint32_t pack_int2(float lo, float hi) {
  if constexpr (fs::Elem<T>::kF16)
    return fs::Elem<T>::pack(lo, hi);
  else
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// byte offset of the 16-byte chunk c of row r of a K or V stage: rows of D
// int8 values, in the 128-byte swizzle at D = 128, plain at D = 64
template <int D>
__device__ __forceinline__ int kv8_off(int r, int c) {
  if constexpr (D == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * D + (c << 4);
}

// ---------------------------------------------------------------------------
// bf16 or fp16 q (T): tensor cores (mma.sync m16n8k16, fp32 sums) on the
// TMA ring of decode_mma_kernel, one warp per tile of 16 positions. Each
// int8 value becomes T in registers (exact: |k| <= 127). The positions take the
// mma's M (all 16 rows used) and the G <= 8 heads its N:
//   S = K Q^T (16 positions x 8 heads), one mma per 16 d. The dot product's
//   order over d is free, so thread qd of a row group reads the D/4
//   contiguous bytes [qd D/4, (qd + 1) D/4) of its K rows, each 4 bytes one
//   k step, and Q^T takes the same d's.
//   O^T += V^T P (D x 8 heads, 16 positions deep). P's rows leave S's
//   registers as heads x positions by movmatrix.trans. V^T needs two
//   positions per register, so thread g reads the D/8 bytes
//   [g D/8, (g + 1) D/8) of its four V rows and pairs them across rows; row
//   r of M tile t is d = (D/8)(r % 8) + 2 t + r / 8.
// Scores are scaled by ks * scale per position, with one max and one
// rescale per tile and head. The scales of a stage's positions are read
// into shared memory during the stage before it (the first stage's while
// its K and V fly). Positions at or past the slice's end get score -inf,
// scale 0 and V 0: the cache may hold anything there.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

template <int D, typename T>
__global__ void __launch_bounds__(TW * 32)
    decode_kv8_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const T* __restrict__ q,
                          const __nv_bfloat16* __restrict__ ks,
                          const __nv_bfloat16* __restrict__ vs,
                          const int* __restrict__ lengths,
                          const int* __restrict__ starts,
                          T* __restrict__ out,
                          float* __restrict__ work, int* __restrict__ counters,
                          int s_len, int n_kv, int n_group, float scale_log2) {
  using E = fs::Elem<T>;
  constexpr int SP = stage_positions<int8_t, D>();
  constexpr int SPT = SP / (TW * 32);  // scale positions per thread
  constexpr int KS = D / 16;   // k steps of S
  constexpr int MT = D / 16;   // M tiles of O^T
  constexpr int NV = D / 8;    // V bytes per thread and row
  constexpr int CPT = D / 64;  // 16-byte K chunks per thread and row
  constexpr int AS = D + 1;    // sm_acc row stride (fewer bank conflicts)
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ float sc_k[2][SP], sc_v[2][SP];  // stage sub's in [sub % 2]
  unsigned char* ring =
      ring_raw + ((1024 - fs::wg::smem_u32(ring_raw) % 1024) % 1024);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;  // mma row group, thread in group
  const size_t bh = (size_t)b * n_kv + hk;
  T* out_bh = out + bh * n_group * D;
  int start, end, first, n_active;
  if (!block_slice<T, D>(lengths, starts, out_bh, s_len, n_group, start, end,
                         first, n_active))
    return;
  const int n_stages = ring_stages<int8_t, D>(s_len, gridDim.z);
  const int n_sub = (end - start + SP - 1) / SP;
  auto issue = [&](int slot, int sub) {  // thread 0: K and V boxes of a stage
    unsigned char* st = ring + slot * STAGE_BYTES;
    const int row = b * s_len + start + sub * SP;
    fs::tma::bar_expect(&full[slot], STAGE_BYTES);
    fs::tma::load_3d(st, &kmap, &full[slot], 0, hk, row);
    fs::tma::load_3d(st + SP * D, &vmap, &full[slot], 0, hk, row);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < n_stages; ++st) fs::tma::bar_init(&full[st]);
    fs::tma::bar_init_fence();
    for (int st = 0; st < n_stages && st < n_sub; ++st) issue(st, st);
  }
  // a stage's scales: ks * scale_log2 and vs of its positions, 0 past end
  const __nv_bfloat16* ks_row = ks + (size_t)b * s_len * n_kv + hk;
  const __nv_bfloat16* vs_row = vs + (size_t)b * s_len * n_kv + hk;
  float nk[SPT], nv[SPT];
  auto fetch = [&](int sub) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int p = start + sub * SP + threadIdx.x + i * TW * 32;
      nk[i] = p < end ? __bfloat162float(ks_row[(size_t)p * n_kv]) * scale_log2 : 0.f;
      nv[i] = p < end ? __bfloat162float(vs_row[(size_t)p * n_kv]) : 0.f;
    }
  };
  auto keep = [&](int sub) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      sc_k[sub & 1][threadIdx.x + i * TW * 32] = nk[i];
      sc_v[sub & 1][threadIdx.x + i * TW * 32] = nv[i];
    }
  };
  fetch(0);
  // B of S: Q^T, head g (heads past G are zero); k step s takes the d's
  // qd D/4 + 4 s .. + 3, the bytes of K this thread reads
  uint32_t qb[KS][2];
  const uint2* qrow = reinterpret_cast<const uint2*>(
      q + (bh * n_group + g) * D + qd * (D / 4));
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint2 w = g < n_group ? qrow[s] : make_uint2(0u, 0u);
    qb[s][0] = w.x;
    qb[s][1] = w.y;
  }
  keep(0);
  __syncthreads();  // the barriers' init and the first scales are visible

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // heads 2 qd + e
  float acc[MT][4];  // O^T rows (D/8) g + 2 t (+ 1), heads 2 qd, 2 qd + 1
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int sub = 0; sub < n_sub; ++sub) {
    const int slot = sub % n_stages;
    const unsigned char* kst = ring + slot * STAGE_BYTES;
    const unsigned char* vst = kst + SP * D;
    const float* sk = sc_k[sub & 1];
    const float* sv = sc_v[sub & 1];
    if (sub + 1 < n_sub) fetch(sub + 1);  // lands while this stage is read
    fs::tma::bar_wait(&full[slot], (sub / n_stages) & 1);
    for (int t = warp; t * 16 < SP; t += TW) {
      const int pb = start + sub * SP + t * 16;  // the tile's first position
      if (pb >= end) break;
      const int r0 = t * 16 + g, r1 = r0 + 8;   // this thread's rows of S
      // S: [0..1] position r0, heads 2 qd, 2 qd + 1; [2..3] position r1
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const uint4 k0 = *reinterpret_cast<const uint4*>(kst + kv8_off<D>(r0, CPT * qd + c));
        const uint4 k1 = *reinterpret_cast<const uint4*>(kst + kv8_off<D>(r1, CPT * qd + c));
        const uint32_t w0[4] = {k0.x, k0.y, k0.z, k0.w}, w1[4] = {k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t x0 = w0[i] ^ 0x80808080u, x1 = w1[i] ^ 0x80808080u;
          mma16<T>(sc,
                   pack_int2<T>(fs::i8_to_f32<0>(x0), fs::i8_to_f32<1>(x0)),
                   pack_int2<T>(fs::i8_to_f32<0>(x1), fs::i8_to_f32<1>(x1)),
                   pack_int2<T>(fs::i8_to_f32<2>(x0), fs::i8_to_f32<3>(x0)),
                   pack_int2<T>(fs::i8_to_f32<2>(x1), fs::i8_to_f32<3>(x1)),
                   qb[4 * c + i][0], qb[4 * c + i][1]);
        }
      }
      const bool v0 = pb + g < end, v1 = pb + g + 8 < end;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[e] = v0 ? sc[e] * sk[r0] : -INFINITY;
        sc[2 + e] = v1 ? sc[2 + e] * sk[r1] : -INFINITY;
      }
      // per head, the tile's max over its 16 positions (the 8 row groups)
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mt = fmaxf(sc[e], sc[2 + e]);
        mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(fs::kFullMask, mt, 16));
        const float m_new = fmaxf(m[e], mt);  // finite: position pb is valid
        const float a = exp2f(m[e] - m_new);
        m[e] = m_new;
        l[e] *= a;
#pragma unroll
        for (int t2 = 0; t2 < MT; ++t2) {
          acc[t2][e] *= a;
          acc[t2][2 + e] *= a;
        }
        p[e] = exp2f(sc[e] - m_new);
        p[2 + e] = exp2f(sc[2 + e] - m_new);
        l[e] += p[e] + p[2 + e];
      }
      // B of O^T: p * vs as hi (+ lo) T terms, positions x heads, rows
      // r0 / r1 of S transposed to heads x positions
      const float w[4] = {p[0] * sv[r0], p[1] * sv[r0], p[2] * sv[r1], p[3] * sv[r1]};
      const uint32_t h0 = E::pack(w[0], w[1]);
      const uint32_t h1 = E::pack(w[2], w[3]);
      const uint32_t o0 = E::pack(w[0] - E::lo(h0), w[1] - E::hi(h0));
      const uint32_t o1 = E::pack(w[2] - E::lo(h1), w[3] - E::hi(h1));
      const uint32_t bhi0 = transpose8x8(h0);
      const uint32_t bhi1 = transpose8x8(h1);
      uint32_t blo0 = 0u, blo1 = 0u;
      if (KV8_PV_TERMS == 2) {
        blo0 = transpose8x8(o0);
        blo1 = transpose8x8(o1);
      }
      // V rows t 16 + {2 qd, 2 qd + 1, 2 qd + 8, 2 qd + 9}, bytes
      // [g D/8, (g + 1) D/8) of each; rows past the slice count as 0
      uint32_t vw[4][NV / 4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = t * 16 + 2 * qd + (h & 1) + 8 * (h >> 1);
        const bool valid = pb + (r - t * 16) < end;
        if constexpr (D == 128) {
          const uint4 x = *reinterpret_cast<const uint4*>(vst + kv8_off<D>(r, g));
          vw[h][0] = x.x; vw[h][1] = x.y; vw[h][2] = x.z; vw[h][3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(vst + r * D + g * NV);
          vw[h][0] = x.x; vw[h][1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < NV / 4; ++i)  // byte 0x80 is int8 0 after the ^
          vw[h][i] = valid ? vw[h][i] ^ 0x80808080u : 0x80808080u;
      }
      // O^T (D x heads) += V^T (D x 16 positions) P (16 positions x heads):
      // word i of a row holds d (D/8) g + 4 i .. + 3, M tiles 2 i and 2 i + 1
#pragma unroll
      for (int i = 0; i < NV / 4; ++i) {
        float f[4][4];  // [row][byte]
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          f[h][0] = fs::i8_to_f32<0>(vw[h][i]); f[h][1] = fs::i8_to_f32<1>(vw[h][i]);
          f[h][2] = fs::i8_to_f32<2>(vw[h][i]); f[h][3] = fs::i8_to_f32<3>(vw[h][i]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const uint32_t a0 = pack_int2<T>(f[0][2 * mm], f[1][2 * mm]);
          const uint32_t a1 = pack_int2<T>(f[0][2 * mm + 1], f[1][2 * mm + 1]);
          const uint32_t a2 = pack_int2<T>(f[2][2 * mm], f[3][2 * mm]);
          const uint32_t a3 = pack_int2<T>(f[2][2 * mm + 1], f[3][2 * mm + 1]);
          mma16<T>(acc[2 * i + mm], a0, a1, a2, a3, bhi0, bhi1);
          if (KV8_PV_TERMS == 2)
            mma16<T>(acc[2 * i + mm], a0, a1, a2, a3, blo0, blo1);
        }
      }
    }
    if (sub + 1 < n_sub) keep(sub + 1);
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0 && sub + n_stages < n_sub) issue(slot, sub + n_stages);
  }
  // the row groups of head 2 qd + e hold parts of its sum
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(fs::kFullMask, l[e], 4);
    l[e] += __shfl_xor_sync(fs::kFullMask, l[e], 8);
    l[e] += __shfl_xor_sync(fs::kFullMask, l[e], 16);
  }
  // the warps' states go where the ring was (every stage has been read)
  float* sm_m = reinterpret_cast<float*>(ring);
  float* sm_l = sm_m + TW * MAXG;
  float* sm_acc = sm_l + TW * MAXG;
  if (g == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sm_m[warp * MAXG + 2 * qd + e] = m[e];
      sm_l[warp * MAXG + 2 * qd + e] = l[e];
    }
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm_acc[(warp * MAXG + 2 * qd + (e & 1)) * AS + NV * g + 2 * t + (e >> 1)] = acc[t][e];
  __syncthreads();
  block_finish<T, D, TW, MAXG, AS>(sm_m, sm_l, sm_acc, out_bh,
                                   work + bh * gridDim.z * (ML + n_group * D),
                                   counters + bh, n_group, first, n_active);
}

// ---------------------------------------------------------------------------
// fp32 q (the tiny fp32 models): CUDA cores. Each of CW warps takes UNROLL
// positions at a time of the block's slice; a lane holds D/32 values of a
// row (one at the tiny model's D = 32: only its slow cache is ever int8), a
// warp sum per score and head; the warps' states merge as above.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(CW * 32)
    decode_kv8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                      const __nv_bfloat16* __restrict__ ks,
                      const int8_t* __restrict__ v,
                      const __nv_bfloat16* __restrict__ vs,
                      const int* __restrict__ lengths,
                      const int* __restrict__ starts, float* __restrict__ out,
                      float* __restrict__ work, int* __restrict__ counters,
                      int s_len, int n_kv, int n_group, float scale_log2) {
  constexpr int EPL = D / 32;
  static_assert(EPL >= 1 && EPL * 32 == D, "a row is whole values per lane");
  __shared__ float sm_m[CW * MAXG];
  __shared__ float sm_l[CW * MAXG];
  __shared__ float sm_acc[CW * MAXG * D];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = (size_t)b * n_kv + hk;
  float* out_bh = out + bh * n_group * D;
  int start, end, first, n_active;
  if (!block_slice<float, D>(lengths, starts, out_bh, s_len, n_group, start,
                             end, first, n_active))
    return;
  float qr[MAXG][EPL], m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < n_group ? q[(bh * n_group + g) * D + lane * EPL + e] : 0.f;
    }
  }
  for (int j0 = start + warp * UNROLL; j0 < end; j0 += CW * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL], ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      const size_t row = ((size_t)b * s_len + j) * n_kv + hk;
      const bool valid = j < end;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = valid ? (float)k[row * D + lane * EPL + e] : 0.f;
        vr[u][e] = valid ? (float)v[row * D + lane * EPL + e] : 0.f;
      }
      ksc[u] = valid ? __bfloat162float(ks[row]) * scale_log2 : 0.f;
      vsc[u] = valid ? __bfloat162float(vs[row]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u >= end) break;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= n_group) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[u][e], s);
        s = fs::warp_sum(s) * ksc[u];
        const float m_new = fmaxf(m[g], s);
        const float a = exp2f(m[g] - m_new);
        const float p = exp2f(s - m_new);
        const float pv = p * vsc[u];
        l[g] = l[g] * a + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv, vr[u][e], acc[g][e] * a);
        m[g] = m_new;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      sm_m[warp * MAXG + g] = m[g];
      sm_l[warp * MAXG + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * MAXG + g) * D + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  block_finish<float, D, CW, MAXG>(sm_m, sm_l, sm_acc, out_bh,
                                   work + bh * gridDim.z * (ML + n_group * D),
                                   counters + bh, n_group, first, n_active);
}

// The TMA map of one layer of the int8 cache, (B, S, Hkv, D) read as D x
// Hkv x (B * S) bytes in boxes of D x 1 head x SP positions.
template <int D>
int kv8_map(CUtensorMap* map, const void* base, int batch, int s_len, int n_kv) {
  constexpr int SP = stage_positions<int8_t, D>();
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n_kv,
                              (cuuint64_t)batch * s_len};
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)n_kv * D};
  const cuuint32_t box[3] = {D, 1, SP};
  return fs::tma::encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, base, dims,
                         strides, box,
                         D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int D>
int launch_decode_kv8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const int* lengths,
                      const int* starts, void* out, float* work,
                      int* counters, int batch, int s_len, int n_kv,
                      int n_group, int n_split, float scale,
                      cudaStream_t stream) {
  constexpr float kLog2e = 1.4426950408889634f;
  const dim3 grid(n_kv, batch, n_split);
  const auto* kst = static_cast<const __nv_bfloat16*>(ks);
  const auto* vst = static_cast<const __nv_bfloat16*>(vs);
  if constexpr (!std::is_same<T, float>::value) {
    // the ring, or the warps' states that take its place at the end
    const size_t smem =
        1024 + std::max((size_t)ring_stages<int8_t, D>(s_len, n_split) * STAGE_BYTES,
                        sizeof(float) * TW * MAXG * (3 + D));
    static bool sized = false;  // one attribute call: up to STAGES stages
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_kv8_mma_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          1024 + STAGES * STAGE_BYTES);
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    CUtensorMap kmap, vmap;
    int rc = kv8_map<D>(&kmap, k, batch, s_len, n_kv);
    if (rc == 0) rc = kv8_map<D>(&vmap, v, batch, s_len, n_kv);
    if (rc != 0) return rc;
    decode_kv8_mma_kernel<D, T><<<grid, TW * 32, smem, stream>>>(
        kmap, vmap, static_cast<const T*>(q), kst, vst, lengths, starts,
        static_cast<T*>(out), work, counters, s_len, n_kv, n_group,
        scale * kLog2e);
  } else {
    decode_kv8_kernel<D><<<grid, CW * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k), kst,
        static_cast<const int8_t*>(v), vst, lengths, starts,
        static_cast<float*>(out),
        work, counters, s_len, n_kv, n_group, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// k_layer / v_layer point at one layer of the stacked cache: (B, S, Hkv, D);
// q and out are (B, Hkv, G, D). Row b attends positions [starts[b],
// lengths[b]) (from 0 where `starts` is null). work holds B * Hkv * n_split
// * (16 + G * D) fp32 partials and counters B * Hkv int32s, all 0 on entry
// (the kernel leaves them 0). q, k_layer and v_layer start on 16-byte
// boundaries.
extern "C" int fs_flash_decode(const void* q, const void* k_layer,
                               const void* v_layer, const void* lengths,
                               const void* starts, void* out, void* work,
                               void* counters, int batch, int s_len,
                               int n_kv, int n_group, int head_dim,
                               int dtype, int n_split, float scale,
                               void* stream) {
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_group < 1 || n_group > MAXG ||
      n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  const int* sts = static_cast<const int*>(starts);
  float* wk = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FS_DEC(T, D)                                                         \
  return launch_decode<T, D>(q, k_layer, v_layer, lens, sts, out, wk, cnt, \
                             batch, s_len, n_kv, n_group, n_split, scale, s)
  if (dtype == fs::kBFloat16 && head_dim == 128) FS_DEC(__nv_bfloat16, 128);
  if (dtype == fs::kBFloat16 && head_dim == 64) FS_DEC(__nv_bfloat16, 64);
  if (dtype == fs::kFloat16 && head_dim == 128) FS_DEC(__half, 128);
  if (dtype == fs::kFloat16 && head_dim == 64) FS_DEC(__half, 64);
  if (dtype == fs::kFloat32 && head_dim == 128) FS_DEC(float, 128);
  if (dtype == fs::kFloat32 && head_dim == 64) FS_DEC(float, 64);
  if (dtype == fs::kFloat32 && head_dim == 32) FS_DEC(float, 32);  // tiny slow stack
  if (dtype == fs::kFloat32 && head_dim == 16) FS_DEC(float, 16);  // tiny fast stack
#undef FS_DEC
  return (int)cudaErrorInvalidValue;
}

// int8 K/V: k_layer / v_layer (B, S, Hkv, D) int8 and ks_layer / vs_layer
// (B, S, Hkv) bf16 point at one layer of the stacked cache; q and out are
// `dtype` (B, Hkv, G, D); starts, work and counters as fs_flash_decode's.
// q, k_layer and v_layer start on 16-byte boundaries.
extern "C" int fs_flash_decode_kv8(const void* q, const void* k_layer,
                                   const void* ks_layer, const void* v_layer,
                                   const void* vs_layer, const void* lengths,
                                   const void* starts, void* out, void* work,
                                   void* counters, int batch, int s_len,
                                   int n_kv, int n_group, int head_dim,
                                   int dtype, int n_split, float scale,
                                   void* stream) {
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_group < 1 || n_group > MAXG ||
      n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  const int* sts = static_cast<const int*>(starts);
  float* wk = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FS_KV8(T, D)                                                        \
  return launch_decode_kv8<T, D>(q, k_layer, ks_layer, v_layer, vs_layer,   \
                                 lens, sts, out, wk, cnt, batch, s_len,     \
                                 n_kv, n_group, n_split, scale, s)
  if (dtype == fs::kBFloat16 && head_dim == 128) FS_KV8(__nv_bfloat16, 128);
  if (dtype == fs::kBFloat16 && head_dim == 64) FS_KV8(__nv_bfloat16, 64);
  if (dtype == fs::kFloat16 && head_dim == 128) FS_KV8(__half, 128);
  if (dtype == fs::kFloat16 && head_dim == 64) FS_KV8(__half, 64);
  if (dtype == fs::kFloat32 && head_dim == 128) FS_KV8(float, 128);
  if (dtype == fs::kFloat32 && head_dim == 64) FS_KV8(float, 64);
  if (dtype == fs::kFloat32 && head_dim == 32) FS_KV8(float, 32);  // tiny slow stack
#undef FS_KV8
  return (int)cudaErrorInvalidValue;
}
