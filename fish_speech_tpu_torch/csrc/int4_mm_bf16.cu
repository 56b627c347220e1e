// The int4 matmul's launches for bf16 x (routes "gemv" and "wgmma"),
// compiled apart from the other dtypes' (int4_mm.cuh).

#include "int4_mm.cuh"

int fs::i4::run_bf16(int batch, const void* x, const uint8_t* p, const float* gs,
                  void* out, float* work, int* counters, int in_dim, int out_dim,
                  int group, int route, int n_split, cudaStream_t s) {
  return run16<__nv_bfloat16>(batch, x, p, gs, out, work, counters, in_dim, out_dim, group, route,
                     n_split, s);
}
