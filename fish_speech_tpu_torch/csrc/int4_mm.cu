// int4 group-wise weight-only matmul: the C entry point and the fp32 x
// routes; the kernels and their design are in int4_mm.cuh, the 16-bit
// routes' launches in int4_mm_bf16.cu and int4_mm_f16.cu.

#include "int4_mm.cuh"

// x (B, I) in `dtype`; p (I/2, O) uint8; gs (I/g, O) fp32; out (B, O) in
// `dtype`. The "gemv" route splits the I/2 packed rows into n_split equal
// runs of whole groups (`ops/int4.py:gemv_split`); with n_split > 1 it needs
// work, n_split * B * O fp32 partials, and counters, ceil(O / 256) int32s,
// all 0 on entry (the kernel leaves them 0). The other routes take
// n_split = 1 and ignore work and counters.
extern "C" int fs_int4_matmul(const void* x, const void* p, const void* gs,
                              void* out, void* work, void* counters, int batch,
                              int in_dim, int out_dim, int group, int dtype,
                              int route, int n_split, void* stream) {
  if (batch < 1 || in_dim < 2 || in_dim % 2 || out_dim < 1 || group < 1 ||
      (in_dim / 2) % group || n_split < 1 || (in_dim / 2) % n_split ||
      (in_dim / 2 / n_split) % group)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pp = static_cast<const uint8_t*>(p);
  const float* gp = static_cast<const float*>(gs);
  float* wk = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fs::kBFloat16)  // "gemv", "wgmma"
    return fs::i4::run_bf16(batch, x, pp, gp, out, wk, cnt, in_dim, out_dim, group, route,
                            n_split, s);
  if (dtype == fs::kFloat16)  // "gemv_f16", "wgmma_f16"
    return fs::i4::run_f16(batch, x, pp, gp, out, wk, cnt, in_dim, out_dim, group, route,
                           n_split, s);
  if (dtype != fs::kFloat32) return (int)cudaErrorInvalidValue;
  if (route == kRouteGemv && batch <= GV_MAXB &&
      (n_split == 1 || (wk != nullptr && cnt != nullptr)))  // "gemv"
    return launch_gemv_rows<float>(batch, x, pp, gp, out, wk, cnt, in_dim, out_dim,
                                   group, n_split, s);
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  if (route == kRouteFp32Tiled) {  // "fp32_tiled"
    dim3 grid((out_dim + BN - 1) / BN, (batch + BM - 1) / BM);
    int4_gemm_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), pp, gp, static_cast<float*>(out), batch,
        in_dim, out_dim, group);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
