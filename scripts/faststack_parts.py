#!/usr/bin/env python3
"""What a frame of the fast-stack probe is made of, timed on the card.

    python3 scripts/faststack_parts.py [OTHER_CHECKOUT]

At flagship dims (1536 / 2560 / 6144, 12 layers x 10 steps), for R in
{0, 1} and both variants, `_bench`'s best of 3 x 30 chained frames (CUDA
events) of:

  * this checkout's kernel: the frame (`ops/faststack.py:_bench`), its grid
    barriers alone and its weight stream alone (`part_ms`);
  * the earlier design, a cooperative kernel without a producer (two
    256-thread blocks per SM; after each of the frame's 480 `grid.sync()`s
    every block loads its units of 512 columns x a chunk of rows with
    synchronous 16-byte evict-first loads, 4 rows per warp at a time): its
    480 `grid.sync()`s alone, and its loads alone with no barrier and no
    math (each loaded word xor-ed into a sum that is kept), both from the
    kernels below, built by `nvcc` into `build/faststack_parts/`;
  * with OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`, a checkout of
    that design, whose `fs_faststack_probe` has its signature), that
    kernel's frame, its `csrc/` built into `build/faststack_parts/`.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "faststack_parts"

# the earlier design's grid and load loop, without its math (see above)
OLD_PARTS_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

constexpr int NT = 256, NWARP = NT / 32, UCOLS = 512;

__global__ void old_barriers(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__device__ unsigned old_matvec_loads(const int8_t* W, int in_dim, int out_dim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_ct = (out_dim + UCOLS - 1) / UCOLS;
  int rc = (int)(((long long)in_dim * n_ct + gridDim.x - 1) / gridDim.x);
  rc = max(4 * NWARP, (rc + 4 * NWARP - 1) / (4 * NWARP) * (4 * NWARP));
  const int n_rt = (in_dim + rc - 1) / rc;
  unsigned acc = 0;
  for (int unit = blockIdx.x; unit < n_ct * n_rt; unit += gridDim.x) {
    const int ct = unit % n_ct, rt = unit / n_ct;
    const int col = ct * UCOLS + lane * 16;
    if (col >= out_dim) continue;
    const int r_end = min(in_dim, (rt + 1) * rc);
    for (int r = rt * rc + warp * 4; r < r_end; r += NWARP * 4) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(
            W + (size_t)(r + t) * out_dim + col));
        acc ^= (unsigned)(v.x ^ v.y ^ v.z ^ v.w);
      }
    }
  }
  return acc;
}

__global__ void old_loads(const int8_t* w, int df, int dqkv, int inter,
                          int n_layer, int steps, unsigned* sink) {
  const size_t o_wo = (size_t)df * dqkv, o_w13 = o_wo + (size_t)df * df;
  const size_t o_w2 = o_w13 + (size_t)df * 2 * inter;
  const size_t layer_bytes = o_w2 + (size_t)inter * df;
  unsigned acc = 0;
  for (int it = 0; it < steps * n_layer; ++it) {
    const int8_t* W = w + (size_t)(it % n_layer) * layer_bytes;
    acc ^= old_matvec_loads(W, df, dqkv);
    acc ^= old_matvec_loads(W + o_wo, df, df);
    acc ^= old_matvec_loads(W + o_w13, df, 2 * inter);
    acc ^= old_matvec_loads(W + o_w2, inter, df);
  }
  if (acc == 0x9E3779B9u) *sink = acc;  // keeps the loads
}

static int grid_blocks(const void* fn) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
  return (per_sm < 2 ? per_sm : 2) * n_sm;
}

extern "C" int launch_old_barriers(int n, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((void*)old_barriers,
                                          grid_blocks((void*)old_barriers), NT,
                                          args, 0, (cudaStream_t)stream);
}

extern "C" int launch_old_loads(const void* w, int df, int dqkv, int inter,
                                int n_layer, int steps, void* sink, void* stream) {
  old_loads<<<grid_blocks((void*)old_loads), NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, df, dqkv, inter, n_layer, steps, (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""


def _old_parts_lib():
    from fish_speech_tpu_torch.ops import _kernels

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "old_parts.cu", OUT / "libold_parts.so"
    src.write_text(OLD_PARTS_CU)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.launch_old_barriers.argtypes = [i32, p]
    lib.launch_old_loads.argtypes = [p, i32, i32, i32, i32, i32, p, p]
    return lib


def _other_lib(tree):
    """The kernel library of another checkout, its `fs_faststack_probe`
    bound with the earlier design's signature."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = OUT / f"kernels-{_kernels.source_hash()}" / "libfs_kernels.so"
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_faststack_probe.argtypes = [p, p, p, p, p] + [i32] * 7 + [p]
    return lib


def _best_ms(launch, frames=30, repeats=3):
    import torch

    launch()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / frames)
    return best


def main():
    import torch

    from fish_speech_tpu_torch.ops import faststack
    from fish_speech_tpu_torch.ops._kernels import check_launch, stream_ptr

    if not torch.cuda.is_available():
        raise SystemExit("faststack_parts: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    dims = faststack.ProbeDims()
    weights = faststack.make_weights(dims, dev)
    x = torch.full((1, dims.df), 0.01, device=dev)
    stream = stream_ptr(x)
    old = _old_parts_lib()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    n_bar = 4 * dims.n_layer * dims.steps
    barriers = _best_ms(lambda: check_launch(
        old.launch_old_barriers(n_bar, stream), "old_barriers"))
    loads = _best_ms(lambda: check_launch(old.launch_old_loads(
        weights["w"].data_ptr(), dims.df, dims.dqkv, dims.inter, dims.n_layer,
        dims.steps, sink.data_ptr(), stream), "old_loads"))
    print(f"earlier design: {n_bar} grid.sync() alone {barriers:.4f} ms/frame, "
          f"loads alone {loads:.4f} ms/frame (R=0); {smi}", flush=True)
    other = _other_lib(sys.argv[1]) if len(sys.argv) > 1 else None
    for variant in ("bf16", "w8a8"):
        for r in (0, 1):
            new = faststack._bench(r, variant, dims=dims, weights=weights,
                                   device=dev)
            parts = {part: faststack.part_ms(part, r, variant, dims=dims,
                                             weights=weights, device=dev)
                     for part in ("barriers", "loads")}
            line = (f"R={r} {variant}: this kernel {new:.4f} ms/frame, its "
                    f"barriers alone {parts['barriers']:.4f}, its weight "
                    f"stream alone {parts['loads']:.4f}")
            if other is not None:
                out = torch.empty_like(x)
                ws = torch.empty(4 * dims.df + dims.dqkv + 2 * dims.inter,
                                 device=dev)
                ms = _best_ms(lambda: check_launch(other.fs_faststack_probe(
                    weights["w"].data_ptr(), weights["sc"].data_ptr(),
                    x.data_ptr(), out.data_ptr(), ws.data_ptr(), dims.df,
                    dims.dqkv, dims.inter, dims.n_layer, dims.steps, r,
                    int(variant == "w8a8"), stream), "other faststack"))
                line += f"; other checkout's kernel {ms:.4f} ms/frame"
            print(f"{line}; {smi}", flush=True)
    if other is not None:
        check_launch(other.fs_l2_persistence_reset(), "l2_persistence_reset")
    faststack.reset_l2_persistence()


if __name__ == "__main__":
    main()
