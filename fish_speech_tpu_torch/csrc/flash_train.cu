// Training self-attention, forward and backward: causal GQA with a
// key-valid mask.
//
// Replaces the Pallas TPU kernels fish_speech_tpu/ops/pallas_attention_train.py
// (_fwd_kernel and _bwd_kernel behind flash_train_attention). Key j is
// visible to query i iff j <= i and kvalid[b, j] != 0. Masked scores are the
// finite -1e30 in the forward; the backward gives masked pairs probability
// exactly 0. A query row with no visible key arises only at left padding
// (the collator pads on the right): its output is finite and its cotangent
// is zero in training, as the TPU kernel's contract states.
//
// What bounds it on the H100: at the flagship's fine-tune shapes (B=2,
// T=1024, H=32, Hkv=8, D=128) each direction is ~B*H*T^2*D multiply-adds
// per layer with every K/V (and Q/dO) tile reused by 64 rows, so it is
// compute-bound. The TPU kernels kept a head's whole K/V in VMEM (~2 MB at
// T=4096); a Hopper block has at most 227 KB of shared memory, so these
// kernels stream 64-row tiles through shared memory and never store a T x T
// tensor in device memory:
//
//  * forward, two routes, one per dtype (fs_flash_train_fwd dispatches on
//    it; the wrapper's `ops/flash_train.py:_route` names the route it
//    counts):
//      - "wgmma", bf16: `train_fwd_wgmma_kernel`, the tensor-core mainloop
//        of attn_wgmma.cuh (whose note gives its design) with the
//        key-valid mask; writes O and lse;
//      - "cuda_cores", fp32 (the small fp32 reference models):
//        `train_fwd_kernel`, one block per (64-query tile, head, batch
//        row), products on the CUDA cores in float32 from shared memory,
//        an online (running max / running sum) softmax in float32 per
//        row, causal tiles past the block's last row skipped; writes O
//        and lse = m + log(l).
//  * backward, FlashAttention-2 style recompute from lse, in two kernels so
//    that every output is written once by one block (deterministic, no
//    atomics, as the TPU kernel's revisit-accumulate was), two routes, one
//    per dtype (fs_flash_train_bwd dispatches on it):
//      - "wgmma", bf16: `train_bwd_dkdv_wgmma_kernel` and
//        `train_bwd_dq_wgmma_kernel`, the tensor-core kernels of
//        attn_bwd_wgmma.cuh (whose note gives their design); P and dS are
//        rounded to bf16 as the products' operands, as the TPU kernel does;
//      - "cuda_cores", fp32: `train_bwd_dkdv_kernel`, one block per (64-key
//        tile, KV head, batch row) walking the G query heads of its group
//        and the query tiles from its own tile to T, recomputing P =
//        exp(S - lse) and dS = P * (dO V^T - delta) * scale and summing
//        dV += P^T dO and dK += dS^T Q in float32 registers; then
//        `train_bwd_dq_kernel`, one block per (64-query tile, head, batch
//        row) walking the key tiles up to the causal limit, dQ += dS K.
//        Products on the CUDA cores in float32 from shared memory, P and dS
//        kept in float32.
//    delta = rowsum(dO * O) comes in from the wrapper (a plain reduction, as
//    the JAX package computes it outside its kernel).

#include "attn_bwd_wgmma.cuh"
#include "attn_wgmma.cuh"
#include "common.cuh"

namespace {

constexpr int TB = 64;       // rows per tile (queries and keys alike)
constexpr int TNT = 256;     // threads per block
constexpr int TPS = TB + 1;  // padded row stride of a 64x64 score tile

// Copies rows [r0, r0 + TB) of head `hx` of a (B, T, Hx, D) tensor into a
// float32 shared tile with row stride D + 1; rows past T read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int hx, int t_len,
                                          int n_hx) {
  for (int idx = threadIdx.x; idx < TB * D; idx += TNT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    float x = 0.f;
    if (row < t_len) x = fs::to_float(src[(((size_t)b * t_len + row) * n_hx + hx) * D + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// s[r][c] += sum_d a[(sr*4+r)][d] * bm[(sc+16c)][d] over two pairs of tiles
// at once: (a0, b0) and (a1, b1). Thread (sr, sc) owns a 4x4 micro-tile.
template <int D>
__device__ __forceinline__ void scores2(const float* a0, const float* b0,
                                        const float* a1, const float* b1,
                                        float s0[4][4], float s1[4][4]) {
  constexpr int P = D + 1;
  const int sr = threadIdx.x >> 4;
  const int sc = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s0[r][c] = s1[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x0[4], y0[4], x1[4], y1[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0[r] = a0[(sr * 4 + r) * P + d];
      x1[r] = a1[(sr * 4 + r) * P + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y0[c] = b0[(sc + 16 * c) * P + d];
      y1[c] = b1[(sc + 16 * c) * P + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s0[r][c] = fmaf(x0[r], y0[c], s0[r][c]);
        s1[r][c] = fmaf(x1[r], y1[c], s1[r][c]);
      }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  // qs, ks [TB][D+1]; vs [TB][D]; ps [TB][TPS]; 3 row vectors; kvalid tile
  return sizeof(float) * (2 * TB * (D + 1) + TB * D + TB * TPS + 3 * TB) +
         sizeof(int) * TB;
}

template <typename T, int D>
__global__ void __launch_bounds__(TNT)
    train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kvalid,
                     T* __restrict__ out, float* __restrict__ lse, int t_len,
                     int n_head, int n_kv, float scale) {
  constexpr int P = D + 1;
  constexpr int NC = D / 32;  // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;               // [TB][P]
  float* ks = qs + TB * P;        // [TB][P]
  float* vs = ks + TB * P;        // [TB][D]
  float* ps = vs + TB * D;        // [TB][TPS]
  float* row_m = ps + TB * TPS;   // running max per query row
  float* row_l = row_m + TB;      // running sum per query row
  float* row_a = row_l + TB;      // rescale factor of the current tile
  int* kv_s = reinterpret_cast<int*>(row_a + TB);  // kvalid of the key tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_head / n_kv);

  load_rows<T, D>(qs, q, b, q0, h, t_len, n_head);
  if (tid < TB) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  const int last_q = min(q0 + TB, t_len) - 1;
  const int n_tiles = last_q / TB + 1;  // causal limit of the block's last row

  const int sr = tid >> 4;  // score rows sr*4..sr*4+3
  const int sc = tid & 15;  // score columns sc + 16*c
  // output rows warp*8..warp*8+7, columns lane + 32*c; the same warp runs the
  // softmax of these rows, so a warp barrier separates it from P.V
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TB;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < TB * D; idx += TNT) {
      const int r = idx / D, c = idx % D;
      const int j = k0 + r;
      float kx = 0.f, vx = 0.f;  // zero rows past T keep 0 * x finite
      if (j < t_len) {
        const size_t g = (((size_t)b * t_len + j) * n_kv + hk) * D + c;
        kx = fs::to_float(k[g]);
        vx = fs::to_float(v[g]);
      }
      ks[r * P + c] = kx;
      vs[r * D + c] = vx;
    }
    if (tid < TB) kv_s[tid] = (k0 + tid < t_len) ? kvalid[(size_t)b * t_len + k0 + tid] : 0;
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
      for (int r = 0; r < 4; ++r) qa[r] = qs[(sr * 4 + r) * P + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[(sc + 16 * c) * P + d];
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
        const int jj = sc + 16 * c;
        const int j = k0 + jj;
        float x;
        if (j >= t_len) {
          x = -INFINITY;  // no such key: weight exactly 0
        } else if (j <= i && kv_s[jj] != 0) {
          x = s[r][c] * scale;
        } else {
          x = fs::kMaskedScore;
        }
        ps[(sr * 4 + r) * TPS + jj] = x;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two columns per lane
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x0 = ps[r * TPS + lane];
      const float x1 = ps[r * TPS + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, fs::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      ps[r * TPS + lane] = p0;
      ps[r * TPS + lane + 32] = p1;
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
    for (int j = 0; j < TB; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = ps[(warp * 8 + r) * TPS + j];
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
    const float l = row_l[warp * 8 + r];
    const float inv = 1.f / l;
    T* o = out + (((size_t)b * t_len + i) * n_head + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) fs::store(o + lane + 32 * c, acc[r][c] * inv);
    if (lane == 0) lse[((size_t)b * n_head + h) * t_len + i] = row_m[warp * 8 + r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Recomputes one 64x64 tile of P and dS from the shared Q/K/dO/V tiles:
// P = exp(S*scale - lse) where visible, else 0; dS = P * (dP - delta) * scale.
// Writes dS (and P when ps != nullptr) to shared memory.
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* qs, const float* ks,
                                          const float* dos, const float* vs,
                                          const float* lse_s, const float* dlt_s,
                                          const int* kv_s, int q0, int k0,
                                          int t_len, float scale, float* ps,
                                          float* dss) {
  float s[4][4], dp[4][4];
  scores2<D>(qs, ks, dos, vs, s, dp);
  const int sr = threadIdx.x >> 4;
  const int sc = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ri = sr * 4 + r;
    const int i = q0 + ri;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = sc + 16 * c;
      const int j = k0 + jj;
      const bool visible = i < t_len && j < t_len && j <= i && kv_s[jj] != 0;
      const float p = visible ? expf(s[r][c] * scale - lse_s[ri]) : 0.f;
      if (ps != nullptr) ps[ri * TPS + jj] = p;
      dss[ri * TPS + jj] = p * (dp[r][c] - dlt_s[ri]) * scale;
    }
  }
}

// lse and delta of query rows [q0, q0 + TB) of head h, 0 past T
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dlt_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int h, int q0, int t_len,
                                               int n_head) {
  const int tid = threadIdx.x;
  if (tid < TB) {
    const int i = q0 + tid;
    const size_t g = ((size_t)b * n_head + h) * t_len + i;
    lse_s[tid] = i < t_len ? lse[g] : 0.f;
    dlt_s[tid] = i < t_len ? delta[g] : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // ks, vs, qs, dos [TB][D+1]; ps, dss [TB][TPS]; lse, delta; kvalid tile
  return sizeof(float) * (4 * TB * (D + 1) + 2 * TB * TPS + 2 * TB) +
         sizeof(int) * TB;
}

template <typename T, int D>
__global__ void __launch_bounds__(TNT)
    train_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kvalid,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int t_len, int n_head, int n_kv,
                          float scale) {
  constexpr int P = D + 1;
  constexpr int NC = D / 32;

  extern __shared__ float smem[];
  float* ks = smem;              // [TB][P]
  float* vs = ks + TB * P;       // [TB][P]
  float* qs = vs + TB * P;       // [TB][P]
  float* dos = qs + TB * P;      // [TB][P]
  float* ps = dos + TB * P;      // [TB][TPS]
  float* dss = ps + TB * TPS;    // [TB][TPS]
  float* lse_s = dss + TB * TPS; // [TB]
  float* dlt_s = lse_s + TB;     // [TB]
  int* kv_s = reinterpret_cast<int*>(dlt_s + TB);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt = blockIdx.x;
  const int k0 = kt * TB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_head / n_kv;
  const int n_qt = (t_len + TB - 1) / TB;

  load_rows<T, D>(ks, k, b, k0, hk, t_len, n_kv);
  load_rows<T, D>(vs, v, b, k0, hk, t_len, n_kv);
  if (tid < TB) kv_s[tid] = (k0 + tid < t_len) ? kvalid[(size_t)b * t_len + k0 + tid] : 0;

  // this thread's keys: warp*8..warp*8+7 of the tile, columns lane + 32*c
  float acc_dk[8][NC], acc_dv[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = kt; qt < n_qt; ++qt) {  // earlier query tiles see no key here
      const int q0 = qt * TB;
      __syncthreads();  // the previous tiles are no longer read
      load_rows<T, D>(qs, q, b, q0, h, t_len, n_head);
      load_rows<T, D>(dos, dout, b, q0, h, t_len, n_head);
      load_row_stats(lse_s, dlt_s, lse, delta, b, h, q0, t_len, n_head);
      __syncthreads();
      p_ds_tile<D>(qs, ks, dos, vs, lse_s, dlt_s, kv_s, q0, k0, t_len, scale,
                   ps, dss);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < TB; ++i) {
        float o_[NC], q_[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o_[c] = dos[i * P + lane + 32 * c];
          q_[c] = qs[i * P + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float p = ps[i * TPS + warp * 8 + r];
          const float ds = dss[i * TPS + warp * 8 + r];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_dv[r][c] = fmaf(p, o_[c], acc_dv[r][c]);
            acc_dk[r][c] = fmaf(ds, q_[c], acc_dk[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = k0 + warp * 8 + r;
    if (j >= t_len) continue;
    const size_t g = (((size_t)b * t_len + j) * n_kv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fs::store(dk + g + lane + 32 * c, acc_dk[r][c]);
      fs::store(dv + g + lane + 32 * c, acc_dv[r][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // qs, dos, ks, vs [TB][D+1]; dss [TB][TPS]; lse, delta; kvalid tile
  return sizeof(float) * (4 * TB * (D + 1) + TB * TPS + 2 * TB) +
         sizeof(int) * TB;
}

template <typename T, int D>
__global__ void __launch_bounds__(TNT)
    train_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kvalid,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t_len, int n_head, int n_kv, float scale) {
  constexpr int P = D + 1;
  constexpr int NC = D / 32;

  extern __shared__ float smem[];
  float* qs = smem;              // [TB][P]
  float* dos = qs + TB * P;      // [TB][P]
  float* ks = dos + TB * P;      // [TB][P]
  float* vs = ks + TB * P;       // [TB][P]
  float* dss = vs + TB * P;      // [TB][TPS]
  float* lse_s = dss + TB * TPS; // [TB]
  float* dlt_s = lse_s + TB;     // [TB]
  int* kv_s = reinterpret_cast<int*>(dlt_s + TB);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_head / n_kv);

  load_rows<T, D>(qs, q, b, q0, h, t_len, n_head);
  load_rows<T, D>(dos, dout, b, q0, h, t_len, n_head);
  load_row_stats(lse_s, dlt_s, lse, delta, b, h, q0, t_len, n_head);

  float acc[8][NC];  // rows warp*8..warp*8+7, columns lane + 32*c
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int last_q = min(q0 + TB, t_len) - 1;
  const int n_tiles = last_q / TB + 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TB;
    __syncthreads();  // the previous K/V/dS tiles are no longer read
    load_rows<T, D>(ks, k, b, k0, hk, t_len, n_kv);
    load_rows<T, D>(vs, v, b, k0, hk, t_len, n_kv);
    if (tid < TB) kv_s[tid] = (k0 + tid < t_len) ? kvalid[(size_t)b * t_len + k0 + tid] : 0;
    __syncthreads();
    p_ds_tile<D>(qs, ks, dos, vs, lse_s, dlt_s, kv_s, q0, k0, t_len, scale,
                 nullptr, dss);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TB; ++j) {
      float kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = ks[j * P + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float ds = dss[(warp * 8 + r) * TPS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ds, kk[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = q0 + warp * 8 + r;
    if (i >= t_len) continue;
    T* o = dq + (((size_t)b * t_len + i) * n_head + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) fs::store(o + lane + 32 * c, acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* kvalid,
               void* out, float* lse, int batch, int t_len, int n_head,
               int n_kv, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = train_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + TB - 1) / TB, n_head, batch);
  kernel<<<grid, TNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvalid, static_cast<T*>(out), lse, t_len,
      n_head, n_kv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd_cuda_cores(const void* q, const void* k, const void* v,
                          const int* kvalid, const void* dout, const float* lse,
                          const float* delta, void* dq, void* dk, void* dv,
                          int batch, int t_len, int n_head, int n_kv,
                          float scale, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  constexpr size_t smem_q = dq_smem_bytes<D>();
  auto kv_kernel = train_bwd_dkdv_kernel<T, D>;
  auto q_kernel = train_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kv_kernel, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(q_kernel, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (t_len + TB - 1) / TB;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  kv_kernel<<<dim3(n_tiles, n_kv, batch), TNT, smem_kv, stream>>>(
      qp, kp, vp, kvalid, dop, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), t_len, n_head, n_kv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(n_tiles, n_head, batch), TNT, smem_q, stream>>>(
      qp, kp, vp, kvalid, dop, lse, delta, static_cast<T*>(dq), t_len, n_head,
      n_kv, scale);
  return (int)cudaGetLastError();
}

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
  if (dtype == fs::kFloat32 && head_dim == 128)  // "cuda_cores"
    return launch_fwd<float, 128>(q, k, v, kv, out, l, batch, t_len, n_head,
                                  n_kv, scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_fwd<float, 64>(q, k, v, kv, out, l, batch, t_len, n_head,
                                 n_kv, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fs_flash_train_bwd(const void* q, const void* k, const void* v,
                                  const void* kvalid, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  void* dk, void* dv, int batch, int t_len,
                                  int n_head, int n_kv, int head_dim,
                                  int dtype, float scale, void* stream) {
  if (bad_shape(batch, t_len, n_head, n_kv)) return (int)cudaErrorInvalidValue;
  const int* kv = static_cast<const int*>(kvalid);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16) {  // "wgmma"
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
  }
  // "cuda_cores"
  if (dtype == fs::kFloat32 && head_dim == 128)
    return launch_bwd_cuda_cores<float, 128>(q, k, v, kv, dout, l, dl, dq, dk,
                                             dv, batch, t_len, n_head, n_kv,
                                             scale, s);
  if (dtype == fs::kFloat32 && head_dim == 64)
    return launch_bwd_cuda_cores<float, 64>(q, k, v, kv, dout, l, dl, dq, dk,
                                            dv, batch, t_len, n_head, n_kv,
                                            scale, s);
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
