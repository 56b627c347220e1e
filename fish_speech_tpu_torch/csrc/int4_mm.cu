// int4 group-wise weight-only matmul: the C entry points and the fp32 x
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
  return (int)cudaErrorInvalidValue;  // fp32 x with B > 8: fs_int4_matmul_fp32
}

// The "fp32_tc" route (fp32 x, any B): y = x @ (q * s) on the tensor cores,
// `int4_tf32_kernel` in tile shape `tile` (0..3, `ops/int4.py:
// FP32_TC_TILES`) with the I/2g groups of a half cut into n_split runs
// (`ops/int4.py:fp32_tc_plan`; sizes differing by at most one); x (B, I), p (I/2, O), gs (I/g, O) fp32,
// out (B, O). With n_split > 1 it needs work, n_split * B * O floats, and
// counters, one int32 per output tile, 0 on entry (the kernel leaves them 0).
extern "C" int fs_int4_matmul_fp32(const void* x, const void* p, const void* gs,
                                   void* out, void* work, void* counters, int batch,
                                   int in_dim, int out_dim, int group, int tile,
                                   int n_split, void* stream) {
  if (batch < 1 || in_dim < 2 || in_dim % 2 || out_dim < 1 || group < 1 ||
      (in_dim / 2) % group || tile < 0 || tile >= tf::N_TILES || n_split < 1 ||
      n_split > in_dim / 2 / group ||
      (n_split > 1 && (work == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  tf::Args a;
  a.x = static_cast<const float*>(x);
  a.p = static_cast<const uint8_t*>(p);
  a.gs = static_cast<const float*>(gs);
  a.out = static_cast<float*>(out);
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.in_dim = in_dim;
  a.out_dim = out_dim;
  a.group = group;
  a.stages_per_pass = (group + tf::KP - 1) / tf::KP;
  a.n_groups = in_dim / 2 / group;
  a.xvec = in_dim % 4 == 0 && group % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.pvec = out_dim % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.svec = out_dim % 4 == 0 && reinterpret_cast<uintptr_t>(gs) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return tf::launch<tf::Tile0>(a, n_split, s);
    case 1: return tf::launch<tf::Tile1>(a, n_split, s);
    case 2: return tf::launch<tf::Tile2>(a, n_split, s);
    default: return tf::launch_wgmma(a, n_split, s);
  }
}

// blocks of tile shape `tile` resident on one SM (the wrapper's plan)
extern "C" int fs_int4_fp32_occupancy(int tile, int* blocks) {
  switch (tile) {
    case 0: return tf::occupancy<tf::Tile0>(blocks);
    case 1: return tf::occupancy<tf::Tile1>(blocks);
    case 2: return tf::occupancy<tf::Tile2>(blocks);
    case 3: return tf::occupancy_wgmma(blocks);
  }
  return (int)cudaErrorInvalidValue;
}
