// int4 group-wise weight-only matmul, y (B, O) = x (B, I) @ W (I, O).
//
// Replaces the Pallas TPU kernel fish_speech_tpu/ops/pallas_int4.py
// (_int4_mm_kernel / int4_matmul). W is stored packed two values per byte
// in the half-split layout: byte p[r, o] holds W[r, o] in its low nibble and
// W[r + I/2, o] in its high nibble, each biased by 8; gs[I/g, O] are fp32
// scales per group of g original rows, and no group straddles the half split
// ((I/2) % g == 0).
//
// What bounds it on the H100: at B = 1 (decode) it is a matrix-vector
// product that reads I/2 * O bytes of packed weight plus 4 * (I/g) * O
// bytes of scales for 2 * I * O operations, far below the ~295 operations
// per byte where the card stops being memory-bound, so its time is those
// bytes over 3.35 TB/s. At B = 1024 (prefill) the operations dominate.
//
// Design (first, simple version):
// * B <= 8: split-K matrix-vector kernel. A block owns 256 output columns
//   (64 column threads x 4 columns, one 4-byte coalesced load per packed
//   row) and one group of g packed rows, so both nibbles of every byte it
//   reads belong to one group each (rows r and r + I/2): the block sums
//   x * nibble for the two groups in fp32 and applies the two scales once.
//   Four row slices share the rows and are summed through shared memory.
//   The grid is (O/256) x (I/2g) blocks (e.g. 12 x 10 for 2560 -> 6144 at
//   g = 128), so most of the 132 SMs get work where a column split alone
//   would give 6-76 blocks. Each block writes its fp32 partial sums; a
//   second kernel adds the I/2g partials per output in a fixed order
//   (deterministic, no atomics) and writes x's dtype.
// * B > 8: tiled product on the CUDA cores. A block computes a 128 x 128
//   output tile; per step it stages 8 packed rows (16 logical rows) of W,
//   unpacked and dequantized in fp32 with their group scales, and the
//   matching 16 columns of x in shared memory; each thread accumulates an
//   8 x 8 sub-tile in fp32 registers. Tensor cores (wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_COLS = 256;   // output columns per block (64 threads x 4)
constexpr int GV_SLICES = 4;   // row slices per block
constexpr int GV_MAXB = 8;     // rows of x the matvec kernel takes

__device__ __forceinline__ void load4(const uint8_t* row, int col0, int out_dim,
                                      bool vec, uint8_t w[4]) {
  if (vec) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(row + col0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = col0 + c < out_dim ? row[col0 + c] : 0x88;
  }
}

template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ gs, float* __restrict__ part,
                     int batch, int in_dim, int out_dim, int group) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [batch][2 * group]
  float* red = smem + batch * 2 * group;         // [SLICES-1][batch][COLS]
  const int half = in_dim / 2;
  const int k = blockIdx.y;  // packed rows [k*g, (k+1)*g): groups k and k + half/g
  const int r0 = k * group;
  const int ct = threadIdx.x % (GV_COLS / 4);
  const int slice = threadIdx.x / (GV_COLS / 4);
  const int col0 = blockIdx.x * GV_COLS + ct * 4;

  for (int idx = threadIdx.x; idx < batch * 2 * group; idx += GV_THREADS) {
    const int b = idx / (2 * group), j = idx % (2 * group);
    const int row = j < group ? r0 + j : half + r0 + (j - group);
    xs[idx] = fs::to_float(x[(size_t)b * in_dim + row]);
  }
  __syncthreads();

  float lo_acc[GV_MAXB][4], hi_acc[GV_MAXB][4];
#pragma unroll
  for (int b = 0; b < GV_MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) lo_acc[b][c] = hi_acc[b][c] = 0.f;

  const bool vec = (out_dim % 4 == 0) && (col0 + 4 <= out_dim);
  if (col0 < out_dim) {
    for (int j = slice; j < group; j += GV_SLICES) {
      uint8_t w[4];
      load4(p + (size_t)(r0 + j) * out_dim, col0, out_dim, vec, w);
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = (float)((int)(w[c] & 0xF) - 8);
        hi[c] = (float)((int)(w[c] >> 4) - 8);
      }
#pragma unroll
      for (int b = 0; b < GV_MAXB; ++b) {
        if (b >= batch) break;
        const float xl = xs[b * 2 * group + j];
        const float xh = xs[b * 2 * group + group + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo_acc[b][c] = fmaf(xl, lo[c], lo_acc[b][c]);
          hi_acc[b][c] = fmaf(xh, hi[c], hi_acc[b][c]);
        }
      }
    }
  }

  // y = s_lo * sum(x * lo) + s_hi * sum(x * hi), per output column
  float s_lo[4], s_hi[4];
  const int g_hi = k + half / group;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = col0 + c;
    s_lo[c] = col < out_dim ? gs[(size_t)k * out_dim + col] : 0.f;
    s_hi[c] = col < out_dim ? gs[(size_t)g_hi * out_dim + col] : 0.f;
  }
  if (slice > 0) {
#pragma unroll
    for (int b = 0; b < GV_MAXB; ++b) {
      if (b >= batch) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((slice - 1) * batch + b) * GV_COLS + ct * 4 + c] =
            s_lo[c] * lo_acc[b][c] + s_hi[c] * hi_acc[b][c];
    }
  }
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int b = 0; b < GV_MAXB; ++b) {
      if (b >= batch) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + c;
        if (col >= out_dim) continue;
        float y = s_lo[c] * lo_acc[b][c] + s_hi[c] * hi_acc[b][c];
#pragma unroll
        for (int s = 0; s < GV_SLICES - 1; ++s)
          y += red[(s * batch + b) * GV_COLS + ct * 4 + c];
        part[((size_t)k * batch + b) * out_dim + col] = y;
      }
    }
  }
}

template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   T* __restrict__ out, int n_split, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float y = 0.f;
  for (int k = 0; k < n_split; ++k) y += part[(size_t)k * n + idx];
  fs::store(out + idx, y);
}

constexpr int BM = 128, BN = 128, KP = 8;  // tile rows, tile columns, packed rows per step
constexpr int KL = 2 * KP;                 // logical rows per step
constexpr int APAD = 4;                    // padding of the x tile against bank conflicts

template <typename T>
__global__ void __launch_bounds__(256)
    int4_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ gs, T* __restrict__ out,
                     int batch, int in_dim, int out_dim, int group) {
  __shared__ float As[KL][BM + APAD];  // x tile, k-major
  __shared__ float Bs[KL][BN];         // dequantized W tile
  const int half = in_dim / 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int bj = threadIdx.x / 32;        // packed row of the W tile this thread loads
  const int bc = (threadIdx.x % 32) * 4;  // its 4 columns
  const bool bvec = (out_dim % 4 == 0) && (n0 + bc + 4 <= out_dim);

  for (int r0 = 0; r0 < half; r0 += KP) {
    for (int idx = threadIdx.x; idx < KL * BM; idx += 256) {
      const int m = idx / KL, kk = idx % KL;
      const int r = r0 + (kk % KP);
      const int row = kk < KP ? r : half + r;
      As[kk][m] = (m0 + m < batch && r < half)
                      ? fs::to_float(x[(size_t)(m0 + m) * in_dim + row])
                      : 0.f;
    }
    {
      const int r = r0 + bj;
      uint8_t w[4] = {0x88, 0x88, 0x88, 0x88};
      if (r < half) load4(p + (size_t)r * out_dim, n0 + bc, out_dim, bvec, w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + bc + c;
        float slo = 0.f, shi = 0.f;
        if (r < half && col < out_dim) {
          slo = gs[(size_t)(r / group) * out_dim + col];
          shi = gs[(size_t)((r + half) / group) * out_dim + col];
        }
        Bs[bj][bc + c] = (float)((int)(w[c] & 0xF) - 8) * slo;
        Bs[KP + bj][bc + c] = (float)((int)(w[c] >> 4) - 8) * shi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= batch) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < out_dim) fs::store(out + (size_t)m * out_dim + n, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const uint8_t* p, const float* gs, void* out,
           float* part, int batch, int in_dim, int out_dim, int group,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (batch <= GV_MAXB) {
    const int n_split = (in_dim / 2) / group;
    const size_t smem =
        sizeof(float) * ((size_t)batch * 2 * group + (GV_SLICES - 1) * batch * GV_COLS);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          int4_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((out_dim + GV_COLS - 1) / GV_COLS, n_split);
    int4_gemv_kernel<T><<<grid, GV_THREADS, smem, stream>>>(
        xt, p, gs, part, batch, in_dim, out_dim, group);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int n = batch * out_dim;
    int4_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(part, ot, n_split, n);
    return (int)cudaGetLastError();
  }
  dim3 grid((out_dim + BN - 1) / BN, (batch + BM - 1) / BM);
  int4_gemm_kernel<T><<<grid, 256, 0, stream>>>(xt, p, gs, ot, batch, in_dim,
                                                 out_dim, group);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, I) in `dtype`; p (I/2, O) uint8; gs (I/g, O) fp32; out (B, O) in
// `dtype`; part: (I/2g, B, O) fp32 when B <= 8, unused otherwise.
extern "C" int fs_int4_matmul(const void* x, const void* p, const void* gs,
                              void* out, void* part, int batch, int in_dim,
                              int out_dim, int group, int dtype, void* stream) {
  if (batch < 1 || in_dim < 2 || in_dim % 2 || out_dim < 1 || group < 1 ||
      (in_dim / 2) % group)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pp = static_cast<const uint8_t*>(p);
  const float* gp = static_cast<const float*>(gs);
  float* sp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16)
    return launch<__nv_bfloat16>(x, pp, gp, out, sp, batch, in_dim, out_dim,
                                 group, s);
  if (dtype == fs::kFloat32)
    return launch<float>(x, pp, gp, out, sp, batch, in_dim, out_dim, group, s);
  return (int)cudaErrorInvalidValue;
}
