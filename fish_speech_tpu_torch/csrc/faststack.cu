// The fast-stack probe: STEPS x NL layers of int8 weight-only matvecs in
// one persistent cooperative kernel.
//
// Replaces the Pallas TPU probe fish_speech_tpu/ops/pallas_faststack.py
// (make_probe, kernel :144, call :312). Per layer, on x (DF) fp32:
//   u = x @ Wqkv                       (DF -> DQKV)
//   y = u[:DF] * (1 + 1e-3 * sum(u[DF:]))   (mock attention)
//   x = x + y @ Wo                     (DF -> DF)
//   f = rms(x) @ W13                   (DF -> 2*INTER)
//   x = rms(x + (silu(f[:INTER]) * f[INTER:]) @ W2)   (INTER -> DF)
// with int8 weights and fp32 per-column scales. Each layer reads its own
// weights: the TPU kernel's prefetch of piece t+2 into the slot being read
// (consume, :180-189) is a race this kernel does not copy.
//
// Variants: "bf16" rounds the activation to bf16 and multiplies the int8
// weight (exact in fp32) with fp32 accumulation, as _dot_bf16 does; "w8a8"
// quantizes the activation per matvec to int8 with its absmax (quant_x,
// :191-196) and sums int8 x int8 products in int32 with __dp4a, then
// scales by x_scale * column scale, as _dot_w8a8 does.
//
// What bounds it on the H100: every matvec does 2 operations per weight
// byte, so a frame moves STEPS * NL * 34.6 MB of int8 weight at flagship
// dims (4.15 GB) for ~8.3 GFLOP: bytes, 1.24 ms at 3.35 TB/s.
//
// Design: one cooperative launch runs the whole frame, so the ~480 kernel
// launches of an eager fast stack become one; stages that depend on each
// other are separated by grid.sync(). A stage's matvec is cut into units of
// 512 columns (a warp reads one 16-byte vector of 16 int8 columns per lane
// and row) by a chunk of rows sized so that the units cover the grid; the
// 8 warps of a block share the rows and reduce through shared memory, and
// each unit adds its column sums into a global fp32 (bf16) or int32 (w8a8,
// exact) accumulator with atomics. The small vector work between matvecs
// (residual, rms, the mock-attention sum, silu * gate, the activation
// absmax) is done by every block from the global vectors after the sync,
// in the same order in every block, so all blocks agree bit for bit.
// "Resident" layers cannot live in shared memory (132 x 227 KB < one 34.6
// MB layer): the first R layers are read through an L2 persisting
// access-policy window (50 MB of L2) and the streamed ones with
// evict-first loads; R changes where the bytes come from, never the math.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int UCOLS = 512;      // columns per unit: 32 lanes x 16
constexpr float kRmsEps = 1e-5f;

struct Probe {
  const int8_t* w;    // (NL, layer_bytes): Wqkv | Wo | W13 | W2, each (I, O)
  const float* sc;    // (NL, DQKV + DF + 2 INTER + DF) column scales, same order
  const float* x0;    // (DF) input
  float* out;         // (DF) output
  float* ws;          // workspace, see the offsets below
  int df, dqkv, inter, n_layer, steps, r_resident;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? fs::warp_max(v) : fs::warp_sum(v);
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NWARP; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Activation prepared in shared memory for one matvec: bf16-rounded
// floats (act_f) or int8 with its scale (act_q, returned).
template <bool W8A8>
__device__ float prepare_act(float* act_f, int8_t* act_q, int n, float* red) {
  if (!W8A8) {
    for (int i = threadIdx.x; i < n; i += NT) act_f[i] = bf16_round(act_f[i]);
    __syncthreads();
    return 1.f;
  }
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) m = fmaxf(m, fabsf(act_f[i]));
  const float xs = block_reduce(m, red, true) / 127.f;
  const float inv = fmaxf(xs, 1e-12f);
  for (int i = threadIdx.x; i < n; i += NT)
    act_q[i] = (int8_t)fminf(fmaxf(rintf(act_f[i] / inv), -127.f), 127.f);
  __syncthreads();
  return xs;
}

__device__ __forceinline__ uint4 load16(const int8_t* p, bool resident) {
  const int4 v = resident ? __ldg(reinterpret_cast<const int4*>(p))
                          : __ldcs(reinterpret_cast<const int4*>(p));
  return make_uint4((unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w);
}

// acc[O] += act[I] @ W[I, O] (int8), over the whole grid.
template <bool W8A8>
__device__ void matvec(const int8_t* __restrict__ W, int in_dim, int out_dim,
                       const float* act_f, const int8_t* act_q, float* acc,
                       float* red_cols, bool resident) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_ct = (out_dim + UCOLS - 1) / UCOLS;
  // rows per unit: a multiple of 4 * NWARP, enough units to cover the grid
  int rc = (int)(((long long)in_dim * n_ct + gridDim.x - 1) / gridDim.x);
  rc = max(4 * NWARP, (rc + 4 * NWARP - 1) / (4 * NWARP) * (4 * NWARP));
  const int n_rt = (in_dim + rc - 1) / rc;
  for (int unit = blockIdx.x; unit < n_ct * n_rt; unit += gridDim.x) {
    const int ct = unit % n_ct, rt = unit / n_ct;
    const int col = ct * UCOLS + lane * 16;
    const bool valid = col < out_dim;
    const int r_end = min(in_dim, (rt + 1) * rc);
    float facc[16];
    int iacc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) facc[c] = 0.f, iacc[c] = 0;
    if (valid) {
      for (int r = rt * rc + warp * 4; r < r_end; r += NWARP * 4) {
        uint4 rows[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          rows[t] = load16(W + (size_t)(r + t) * out_dim + col, resident);
        if (W8A8) {
          const int xp = *reinterpret_cast<const int*>(act_q + r);
          const unsigned* a0 = &rows[0].x;
          const unsigned* a1 = &rows[1].x;
          const unsigned* a2 = &rows[2].x;
          const unsigned* a3 = &rows[3].x;
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            // 4 x 4 byte transpose: column 4*wd + j gets byte j of rows 0..3
            const unsigned t0 = __byte_perm(a0[wd], a1[wd], 0x5140);
            const unsigned t1 = __byte_perm(a2[wd], a3[wd], 0x5140);
            const unsigned t2 = __byte_perm(a0[wd], a1[wd], 0x7362);
            const unsigned t3 = __byte_perm(a2[wd], a3[wd], 0x7362);
            iacc[4 * wd + 0] = __dp4a((int)__byte_perm(t0, t1, 0x5410), xp, iacc[4 * wd + 0]);
            iacc[4 * wd + 1] = __dp4a((int)__byte_perm(t0, t1, 0x7632), xp, iacc[4 * wd + 1]);
            iacc[4 * wd + 2] = __dp4a((int)__byte_perm(t2, t3, 0x5410), xp, iacc[4 * wd + 2]);
            iacc[4 * wd + 3] = __dp4a((int)__byte_perm(t2, t3, 0x7632), xp, iacc[4 * wd + 3]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float xv = act_f[r + t];
            const int8_t* b = reinterpret_cast<const int8_t*>(&rows[t]);
#pragma unroll
            for (int c = 0; c < 16; ++c) facc[c] = fmaf(xv, (float)b[c], facc[c]);
          }
        }
      }
    }
    // reduce the 8 warps' column sums, then one atomic per column
#pragma unroll
    for (int c = 0; c < 16; ++c)
      red_cols[warp * UCOLS + lane * 16 + c] = W8A8 ? __int_as_float(iacc[c]) : facc[c];
    __syncthreads();
    for (int cc = threadIdx.x; cc < UCOLS; cc += NT) {
      const int o = ct * UCOLS + cc;
      if (o >= out_dim) continue;
      if (W8A8) {
        int s = 0;
        for (int w2 = 0; w2 < NWARP; ++w2) s += __float_as_int(red_cols[w2 * UCOLS + cc]);
        atomicAdd(reinterpret_cast<int*>(acc) + o, s);
      } else {
        float s = 0.f;
        for (int w2 = 0; w2 < NWARP; ++w2) s += red_cols[w2 * UCOLS + cc];
        atomicAdd(acc + o, s);
      }
    }
    __syncthreads();
  }
}

// The column-scaled value of accumulator entry o.
template <bool W8A8>
__device__ __forceinline__ float scaled(const float* acc, int o, const float* s,
                                        float xs) {
  if (W8A8) return (float)reinterpret_cast<const int*>(acc)[o] * (xs * s[o]);
  return acc[o] * s[o];
}

__device__ void zero(float* p, int n, const cg::grid_group& grid) {
  for (int i = (int)grid.thread_rank(); i < n; i += (int)grid.size()) p[i] = 0.f;
}

template <bool W8A8>
__global__ void __launch_bounds__(NT) faststack_kernel(Probe a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int DF = a.df, DQKV = a.dqkv, INTER = a.inter;
  const int amax = max(DF, INTER);
  float* act_f = smem;                                         // [amax]
  float* red_cols = act_f + amax;                              // [NWARP * UCOLS]
  float* red = red_cols + NWARP * UCOLS;                       // [32]
  int8_t* act_q = reinterpret_cast<int8_t*>(red + 32);         // [amax]

  float* x_in = a.ws;               // the layer's input
  float* x_mid = x_in + DF;         // after the attention residual
  float* acc_qkv = x_mid + DF;
  float* acc_o = acc_qkv + DQKV;
  float* acc_f = acc_o + DF;
  float* acc_2 = acc_f + 2 * INTER;

  const size_t o_wo = (size_t)DF * DQKV;
  const size_t o_w13 = o_wo + (size_t)DF * DF;
  const size_t o_w2 = o_w13 + (size_t)DF * 2 * INTER;
  const size_t layer_bytes = o_w2 + (size_t)INTER * DF;
  const int sc_len = DQKV + DF + 2 * INTER + DF;

  zero(acc_qkv, DQKV, grid);
  grid.sync();

  float xs_prev_w2 = 1.f;  // activation scale of the previous layer's W2 input
  const float* s_prev_w2 = nullptr;
  const int total = a.steps * a.n_layer;
  for (int it = 0; it < total; ++it) {
    const int l = it % a.n_layer;
    const bool resident = l < a.r_resident;
    const int8_t* W = a.w + (size_t)l * layer_bytes;
    const float* s_qkv = a.sc + (size_t)l * sc_len;
    const float* s_wo = s_qkv + DQKV;
    const float* s_w13 = s_wo + DF;
    const float* s_w2 = s_w13 + 2 * INTER;

    // A: the layer input (the previous layer's rms output), then x @ Wqkv
    if (it == 0) {
      for (int i = threadIdx.x; i < DF; i += NT) act_f[i] = a.x0[i];
    } else {
      float ss = 0.f;
      for (int i = threadIdx.x; i < DF; i += NT) {
        const float v = x_mid[i] + scaled<W8A8>(acc_2, i, s_prev_w2, xs_prev_w2);
        act_f[i] = v;
        ss += v * v;
      }
      const float r = rsqrtf(block_reduce(ss, red, false) / DF + kRmsEps);
      for (int i = threadIdx.x; i < DF; i += NT) act_f[i] *= r;
    }
    __syncthreads();
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < DF; i += NT) x_in[i] = act_f[i];
    zero(acc_o, DF, grid);
    float xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(W, DF, DQKV, act_f, act_q, acc_qkv, red_cols, resident);
    grid.sync();

    // B: mock attention, then y @ Wo
    float kv = 0.f;
    for (int i = DF + threadIdx.x; i < DQKV; i += NT)
      kv += scaled<W8A8>(acc_qkv, i, s_qkv, xs);
    const float mix = 1.f + block_reduce(kv, red, false) * 1e-3f;
    for (int i = threadIdx.x; i < DF; i += NT)
      act_f[i] = scaled<W8A8>(acc_qkv, i, s_qkv, xs) * mix;
    __syncthreads();
    zero(acc_f, 2 * INTER, grid);
    xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(W + o_wo, DF, DF, act_f, act_q, acc_o, red_cols, resident);
    grid.sync();

    // C: attention residual, rms, then h @ W13
    float ss = 0.f;
    for (int i = threadIdx.x; i < DF; i += NT) {
      const float v = x_in[i] + scaled<W8A8>(acc_o, i, s_wo, xs);
      act_f[i] = v;
      ss += v * v;
    }
    __syncthreads();
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < DF; i += NT) x_mid[i] = act_f[i];
    const float r = rsqrtf(block_reduce(ss, red, false) / DF + kRmsEps);
    for (int i = threadIdx.x; i < DF; i += NT) act_f[i] *= r;
    __syncthreads();
    zero(acc_2, DF, grid);
    xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(W + o_w13, DF, 2 * INTER, act_f, act_q, acc_f, red_cols, resident);
    grid.sync();

    // D: silu(gate) * up, then g @ W2
    for (int i = threadIdx.x; i < INTER; i += NT) {
      const float f1 = scaled<W8A8>(acc_f, i, s_w13, xs);
      const float f3 = scaled<W8A8>(acc_f, INTER + i, s_w13, xs);
      act_f[i] = f1 / (1.f + expf(-f1)) * f3;
    }
    __syncthreads();
    zero(acc_qkv, DQKV, grid);
    xs_prev_w2 = prepare_act<W8A8>(act_f, act_q, INTER, red);
    s_prev_w2 = s_w2;
    matvec<W8A8>(W + o_w2, INTER, DF, act_f, act_q, acc_2, red_cols, resident);
    grid.sync();
  }

  // the last layer's rms output
  float ss = 0.f;
  for (int i = threadIdx.x; i < DF; i += NT) {
    const float v = x_mid[i] + scaled<W8A8>(acc_2, i, s_prev_w2, xs_prev_w2);
    act_f[i] = v;
    ss += v * v;
  }
  const float r = rsqrtf(block_reduce(ss, red, false) / DF + kRmsEps);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < DF; i += NT) a.out[i] = act_f[i] * r;
}

size_t smem_bytes(int df, int inter) {
  const int amax = df > inter ? df : inter;
  return sizeof(float) * ((size_t)amax + NWARP * UCOLS + 32) + amax;
}

constexpr int kBlocksPerSm = 2;  // cooperative grid: at most this many per SM

// Launches the frame on a grid of min(occupancy, kBlocksPerSm) blocks per
// SM, all co-resident as grid.sync() requires.
template <bool W8A8>
cudaError_t launch(Probe a, cudaStream_t s) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(a.df, a.inter);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(faststack_kernel<W8A8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, faststack_kernel<W8A8>,
                                                      NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm) * n_sm;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((void*)faststack_kernel<W8A8>, blocks, NT,
                                     args, smem, s);
}

}  // namespace

// One frame: w (NL, layer_bytes) int8, sc (NL, DQKV + DF + 2 INTER + DF)
// fp32, x0/out (DF) fp32, ws (2 DF + DQKV + DF + 2 INTER + DF) fp32.
// With r_resident > 0 the first r_resident layers are read through an L2
// persisting access-policy window set on `stream` for this launch.
extern "C" int fs_faststack_probe(const void* w, const void* sc, const void* x0,
                                  void* out, void* ws, int df, int dqkv,
                                  int inter, int n_layer, int steps,
                                  int r_resident, int w8a8, void* stream) {
  if (df % 16 || dqkv % 16 || inter % 16 || dqkv <= df || n_layer < 1 ||
      steps < 1 || r_resident < 0 || r_resident >= n_layer)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Probe a{static_cast<const int8_t*>(w), static_cast<const float*>(sc),
          static_cast<const float*>(x0), static_cast<float*>(out),
          static_cast<float*>(ws), df, dqkv, inter, n_layer, steps, r_resident};
  cudaError_t e;
  if (r_resident > 0) {
    int dev = 0, max_persist = 0, max_window = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    const size_t layer_bytes = (size_t)df * dqkv + (size_t)df * df +
                               (size_t)df * 2 * inter + (size_t)inter * df;
    size_t window = layer_bytes * r_resident;
    if (window > (size_t)max_window) window = (size_t)max_window;
    const size_t persist = window < (size_t)max_persist ? window : (size_t)max_persist;
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, persist);
    if (e != cudaSuccess) return (int)e;
    cudaStreamAttrValue attr = {};
    attr.accessPolicyWindow.base_ptr = const_cast<void*>(w);
    attr.accessPolicyWindow.num_bytes = window;
    attr.accessPolicyWindow.hitRatio = window ? (float)persist / (float)window : 0.f;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    e = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    if (e != cudaSuccess) return (int)e;
  }
  e = w8a8 ? launch<true>(a, s) : launch<false>(a, s);
  if (r_resident > 0) {
    cudaStreamAttrValue attr = {};  // num_bytes 0: no window for later work
    const cudaError_t e2 =
        cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

// Return persisting L2 lines to normal and give the L2 set-aside back.
extern "C" int fs_l2_persistence_reset() {
  cudaError_t e = cudaCtxResetPersistingL2Cache();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
}
