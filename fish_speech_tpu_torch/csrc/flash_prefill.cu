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
// Two routes, one per dtype (fs_flash_prefill dispatches on it; the
// wrapper's `ops/flash_prefill.py:_route` names the route it counts):
//  * "wgmma", bf16 (every served model): `prefill_wgmma_kernel`, the
//    tensor-core mainloop of attn_wgmma.cuh (whose note gives its design)
//    with the offset mask;
//  * "cuda_cores", fp32 (the small fp32 reference models):
//    `prefill_kernel`, one block of 256 threads per (query tile of BQ=64
//    rows, head, batch row), products on the CUDA cores in float32 from
//    shared memory, tiles past the causal limit of the block skipped.
//
// fs_flash_suffix runs the same two kernels in their suffix form (a
// prefix-cache hit's suffix prefill, dual_ar.prefill_suffix; JAX runs an
// einsum over the cache there, fish_speech_tpu/models/dual_ar.py:
// prefill_suffix): query i sits at position start + i, with start read
// from device memory, K/V come from one layer of the stacked cache (row
// stride S), key j is visible iff j <= start + i, and only keys
// [0, start + T) are read. Four entry points, {bf16, fp32} x {bf16 (or
// fp32) cache, int8 cache}: `suffix_wgmma_kernel<D, KV8>` (the
// tensor-core mainloop, attn_wgmma.cuh) and `prefill_kernel` with SUFFIX
// set. Under the int8 cache K/V go to float exactly, ks scales the score
// columns and vs the probability columns before P V, l summing the
// unscaled p (fish_speech_tpu/ops/attention.py:gqa_attention_kv8). What
// bounds the suffix on the H100: 4 * D operations per visible (query, key)
// pair and head against the cache's K/V bytes, which the G = H / Hkv heads
// of a KV head and the query tiles read again: at start 951, T 64, 36
// layers the K/V of a layer is 4 MB, ~0.06 operations a byte over the
// card's bf16 ratio, so the bytes bound it.

#include "attn_wgmma.cuh"
#include "common.cuh"

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
  constexpr int NC = D / 32;  // output columns per thread

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

template <int D>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    prefill_wgmma_kernel(const fs::attn::Args a) {
  fs::attn::attn_fwd_wgmma<fs::attn::Mask::kOffset, D>(a);
}

template <int D, bool KV8>
__global__ void __launch_bounds__(fs::attn::THREADS, 1)
    suffix_wgmma_kernel(const fs::attn::Args a) {
  fs::attn::attn_fwd_wgmma<fs::attn::Mask::kSuffix, D, KV8>(a);
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
  if (dtype == fs::kBFloat16) {  // "wgmma"
    fs::attn::Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.mask = off;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.lse = nullptr;
    a.t_len = t_len;
    a.n_head = n_head;
    a.n_kv = n_kv;
    a.scale = scale;
    if (head_dim == 128)
      return fs::attn::launch<128>(prefill_wgmma_kernel<128>, a, batch, s);
    if (head_dim == 64)
      return fs::attn::launch<64>(prefill_wgmma_kernel<64>, a, batch, s);
  }
  if (dtype == fs::kFloat32 && head_dim == 128)  // "cuda_cores"
    return launch_prefill<float, float, 128, false, false>(
        q, k, v, nullptr, nullptr, off, out, batch, t_len, t_len, n_head, n_kv,
        scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_prefill<float, float, 64, false, false>(
        q, k, v, nullptr, nullptr, off, out, batch, t_len, t_len, n_head, n_kv,
        scale, s);
  return (int)cudaErrorInvalidValue;
}

// q (B, T, H, D); k/v one layer of the stacked cache, (B, seq, Hkv, D) of
// q's dtype or int8 (kv8, with ks/vs (B, seq, Hkv) bf16); start (1,) int32
// on the device; out (B, T, H, D). The caller keeps start + T <= seq.
extern "C" int fs_flash_suffix(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* start,
                               void* out, int batch, int t_len, int n_head,
                               int n_kv, int head_dim, int seq, int dtype,
                               int kv8, float scale, void* stream) {
  if (batch < 1 || t_len < 1 || n_kv < 1 || n_head % n_kv != 0 || seq < t_len)
    return (int)cudaErrorInvalidValue;
  if (kv8 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16) {  // "suffix_wgmma", "suffix_kv8_wgmma"
    fs::attn::Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.k8 = static_cast<const int8_t*>(k);
    a.v8 = static_cast<const int8_t*>(v);
    a.ks = static_cast<const __nv_bfloat16*>(ks);
    a.vs = static_cast<const __nv_bfloat16*>(vs);
    a.mask = st;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.lse = nullptr;
    a.t_len = t_len;
    a.n_head = n_head;
    a.n_kv = n_kv;
    a.scale = scale;
    a.kv_seq = seq;
    if (head_dim == 128)
      return kv8 ? fs::attn::launch<128, true>(suffix_wgmma_kernel<128, true>, a, batch, s)
                 : fs::attn::launch<128>(suffix_wgmma_kernel<128, false>, a, batch, s);
    if (head_dim == 64)
      return kv8 ? fs::attn::launch<64, true>(suffix_wgmma_kernel<64, true>, a, batch, s)
                 : fs::attn::launch<64>(suffix_wgmma_kernel<64, false>, a, batch, s);
  }
  if (dtype == fs::kFloat32 && head_dim == 128)  // "suffix_cuda_cores", "suffix_kv8_..."
    return launch_suffix_fp32<128>(q, k, v, ks, vs, st, out, batch, t_len, seq,
                                   n_head, n_kv, kv8 != 0, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_suffix_fp32<64>(q, k, v, ks, vs, st, out, batch, t_len, seq,
                                  n_head, n_kv, kv8 != 0, scale, s);
  return (int)cudaErrorInvalidValue;
}
