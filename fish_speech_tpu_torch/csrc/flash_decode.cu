// Attention of one query position over one layer of a stacked KV cache.
//
// Replaces the Pallas TPU kernel fish_speech_tpu/ops/pallas_decode.py
// (_decode_kernel / flash_decode_attention): row b attends its first
// lengths[b] cache positions with a float32 online softmax. The G query
// heads that share a KV head are served together, so each K/V row is read
// from device memory once per step, not once per query head.
//
// What bounds it on the H100: decode attention does 2*G multiply-adds per
// K/V element it reads, far below the ~295 operations per byte at which the
// card stops being memory-bound, so its time is bytes moved: 2 * len * Hkv *
// D * 2 bytes per layer in bf16. It reads only the first lengths[b]
// positions, so no fixed-length buckets are needed.
//
// Design (first, simple version): one block of 8 warps per (KV head, batch
// row), as the issue's slice asks; each warp walks every 8th position,
// reading a K and a V row with one coalesced load per lane (D/32 elements),
// reducing the G dot products with warp shuffles and keeping its own
// running max / sum / accumulator. The 8 partial softmax states are merged
// through shared memory at the end. With B*Hkv blocks the card is far from
// full at batch 1: splitting S across blocks (flash-decoding) is later work.
//
// The int8-KV variant (fs_flash_decode_kv8) serves the slow stack under the
// int8 KV cache, where the JAX package ran the einsum of
// fish_speech_tpu/ops/attention.py:66-104 (gqa_attention_kv8; no Pallas
// kernel). It reads int8 K/V rows and their bf16 per-(position, head)
// scales and folds the scales in as that einsum does: score = (q . k_i8) *
// ks * 1/sqrt(d), online fp32 softmax, accumulator += p * vs * v_i8. Half
// the bytes of the bf16 cache (plus 4 bytes of scales per row and head).
// It splits the positions into chunks of `chunk` over a third grid axis
// (flash-decoding), so batch 1 gets Hkv x ceil(S / chunk) blocks instead of
// Hkv; a second kernel merges the chunks' (max, sum, accumulator) states.

#include "common.cuh"

namespace {

constexpr int NW = 8;         // warps per block
constexpr int MAXG = 8;       // query heads per KV head served by one block
constexpr int UNROLL = 4;     // positions per warp iteration (loads in flight)

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ out, int s_len, int n_kv, int n_group,
                  float scale) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), s_len);

  float qr[MAXG][EPL];
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < n_group
                     ? fs::to_float(q[(((size_t)b * n_kv + hk) * n_group + g) * D +
                                      lane * EPL + e])
                     : 0.f;
    }
  }

  for (int j0 = warp * UNROLL; j0 < len; j0 += NW * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      const size_t base = (((size_t)b * s_len + j) * n_kv + hk) * D + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = j < len ? fs::to_float(k[base + e]) : 0.f;
        vr[u][e] = j < len ? fs::to_float(v[base + e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u >= len) break;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= n_group) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[u][e], s);
        s = fs::warp_sum(s) * scale;
        const float m_new = fmaxf(m[g], s);
        const float a = expf(m[g] - m_new);  // 0 on a warp's first position
        const float p = expf(s - m_new);
        l[g] = l[g] * a + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e] * a);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= n_group) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n_group * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float tot = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w][g];
      if (mw == -INFINITY) continue;  // warp saw no position
      const float f = expf(mw - mx);
      tot += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    fs::store(out + (((size_t)b * n_kv + hk) * n_group + g) * D + d,
              tot > 0.f ? o / tot : 0.f);
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, void* out, int batch, int s_len,
                  int n_kv, int n_group, float scale, cudaStream_t stream) {
  dim3 grid(n_kv, batch);
  decode_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), s_len, n_kv,
      n_group, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// int8 K/V with bf16 per-(position, head) scales, positions split in chunks
// ---------------------------------------------------------------------------

template <int EPL>
__device__ __forceinline__ void load_i8(const int8_t* p, float* out) {
  if constexpr (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = (float)c.x; out[1] = (float)c.y; out[2] = (float)c.z; out[3] = (float)c.w;
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = (float)p[e];
  }
}

// part: (B, Hkv, n_split, G, D + 2) fp32 -- per chunk the unnormalised
// accumulator, then its running max and sum
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
    decode_kv8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                      const __nv_bfloat16* __restrict__ ks,
                      const int8_t* __restrict__ v,
                      const __nv_bfloat16* __restrict__ vs,
                      const int* __restrict__ lengths, float* __restrict__ part,
                      int s_len, int n_kv, int n_group, int chunk, float scale) {
  constexpr int EPL = D / 32;
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), s_len);
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  float qr[MAXG][EPL];
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < n_group
                     ? fs::to_float(q[(((size_t)b * n_kv + hk) * n_group + g) * D +
                                      lane * EPL + e])
                     : 0.f;
    }
  }

  for (int j0 = start + warp * UNROLL; j0 < end; j0 += NW * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL], ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      const size_t row = ((size_t)b * s_len + j) * n_kv + hk;
      if (j < end) {
        load_i8<EPL>(k + row * D + lane * EPL, kr[u]);
        load_i8<EPL>(v + row * D + lane * EPL, vr[u]);
        ksc[u] = __bfloat162float(ks[row]) * scale;
        vsc[u] = __bfloat162float(vs[row]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
        ksc[u] = vsc[u] = 0.f;
      }
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
        const float a = expf(m[g] - m_new);
        const float p = expf(s - m_new);
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
    if (g >= n_group) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  float* out = part + (((size_t)b * n_kv + hk) * n_split + split) * n_group * (D + 2);
  for (int idx = threadIdx.x; idx < n_group * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float tot = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w][g];
      if (mw == -INFINITY) continue;  // warp saw no position
      const float f = expf(mw - mx);
      tot += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    out[g * (D + 2) + d] = o;
    if (d == 0) {
      out[g * (D + 2) + D] = mx;
      out[g * (D + 2) + D + 1] = tot;
    }
  }
}

template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, int n_kv, int n_group,
                                    int n_split) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const float* base = part + ((size_t)b * n_kv + hk) * n_split * n_group * (D + 2);
  for (int idx = threadIdx.x; idx < n_group * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, base[(s * n_group + g) * (D + 2) + D]);
    float tot = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* st = base + (s * n_group + g) * (D + 2);
      if (st[D] == -INFINITY) continue;  // chunk past the length
      const float f = expf(st[D] - mx);
      tot += st[D + 1] * f;
      o += st[d] * f;
    }
    fs::store(out + (((size_t)b * n_kv + hk) * n_group + g) * D + d,
              tot > 0.f ? o / tot : 0.f);
  }
}

template <typename T, int D>
int launch_decode_kv8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const int* lengths,
                      float* part, void* out, int batch, int s_len, int n_kv,
                      int n_group, int chunk, float scale, cudaStream_t stream) {
  const int n_split = (s_len + chunk - 1) / chunk;
  dim3 grid(n_kv, batch, n_split);
  decode_kv8_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(v),
      static_cast<const __nv_bfloat16*>(vs), lengths, part, s_len, n_kv,
      n_group, chunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T, D><<<dim3(n_kv, batch), 256, 0, stream>>>(
      part, static_cast<T*>(out), n_kv, n_group, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// k_layer / v_layer point at one layer of the stacked cache: (B, S, Hkv, D).
extern "C" int fs_flash_decode(const void* q, const void* k_layer,
                               const void* v_layer, const void* lengths,
                               void* out, int batch, int s_len, int n_kv,
                               int n_group, int head_dim, int dtype,
                               float scale, void* stream) {
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_group < 1 || n_group > MAXG)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16 && head_dim == 128)
    return launch_decode<__nv_bfloat16, 128>(q, k_layer, v_layer, lens, out,
                                             batch, s_len, n_kv, n_group,
                                             scale, s);
  if (dtype == fs::kBFloat16 && head_dim == 64)
    return launch_decode<__nv_bfloat16, 64>(q, k_layer, v_layer, lens, out,
                                            batch, s_len, n_kv, n_group, scale,
                                            s);
  if (dtype == fs::kFloat32 && head_dim == 128)
    return launch_decode<float, 128>(q, k_layer, v_layer, lens, out, batch,
                                     s_len, n_kv, n_group, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_decode<float, 64>(q, k_layer, v_layer, lens, out, batch,
                                    s_len, n_kv, n_group, scale, s);
  return (int)cudaErrorInvalidValue;
}

// int8 K/V: k_layer / v_layer (B, S, Hkv, D) int8 and ks_layer / vs_layer
// (B, S, Hkv) bf16 point at one layer of the stacked cache; part is
// (B, Hkv, ceil(S / chunk), G, D + 2) fp32 partials; q and out are `dtype`.
extern "C" int fs_flash_decode_kv8(const void* q, const void* k_layer,
                                   const void* ks_layer, const void* v_layer,
                                   const void* vs_layer, const void* lengths,
                                   void* part, void* out, int batch, int s_len,
                                   int n_kv, int n_group, int head_dim,
                                   int dtype, int chunk, float scale,
                                   void* stream) {
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_group < 1 || n_group > MAXG ||
      chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FS_KV8(T, D)                                                          \
  return launch_decode_kv8<T, D>(q, k_layer, ks_layer, v_layer, vs_layer,     \
                                 lens, pt, out, batch, s_len, n_kv, n_group,  \
                                 chunk, scale, s)
  if (dtype == fs::kBFloat16 && head_dim == 128) FS_KV8(__nv_bfloat16, 128);
  if (dtype == fs::kBFloat16 && head_dim == 64) FS_KV8(__nv_bfloat16, 64);
  if (dtype == fs::kFloat32 && head_dim == 128) FS_KV8(float, 128);
  if (dtype == fs::kFloat32 && head_dim == 64) FS_KV8(float, 64);
#undef FS_KV8
  return (int)cudaErrorInvalidValue;
}
