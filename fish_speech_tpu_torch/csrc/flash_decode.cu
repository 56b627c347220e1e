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
