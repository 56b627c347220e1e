#!/usr/bin/env python3
"""The int8 matmul's bf16 kernels (`csrc/int8_mm.cu`) timed on one GPU.

    PYTHONPATH=. python3 scripts/int8_mm_bench.py [--variants product,stream,...]
        [--rows 1,4,16,32] [--shapes "slow wqkv,LM head"] [--runs auto|sweep]

Builds `csrc/int8_mm.cu` alone into one shared library per variant (`nvcc`
with the port's flags and the variant's -D flags, all started together,
under `build/int8_mm_bench/`), then for s2-pro's int8 decode shapes
(`chip_smoke.py:INT8_SHAPES`) and the given rows of x (bf16) times one call
in device time: a CUDA graph of calls walking copies of the weight over
twice the L2, best of three replays, as `chip_smoke.py`'s `device_ms`.

For each shape and row count it prints cuBLAS on the dequantized bf16 W,
the cluster kernel (`fs_int8_matmul_cluster`, route "gemv_cluster") at
`ops/int8.py:int8_gemv_plan`'s cluster size ("auto") or, with `--runs
sweep`, at every cluster size it takes, and then, in turns (mma, cluster,
cluster, mma), the 1-16-row kernel (`fs_int8_matmul`, route "gemv_mma":
runs from `int8_gemv_split`, partials merged through a global workspace)
against the cluster kernel at its plan. Variants of the cluster
kernel (the breakdown of its skeleton, `csrc/int8_mma.cuh`):

  product  the kernel as the port builds it (mma.sync products)
  stream   FS_INT8_PART=1: the W and x stream by TMA alone (each stage's
           words read and folded, no conversion, no product), with the
           cluster's merge
  convert  FS_INT8_PART=2: the stream and the int8 -> bf16 conversions,
           no products

The products' outputs are held to the plain version (2^-8 |y| +
1e-5 (|x| @ |q|) * s). Prints each time with its bytes bound and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {"product": [], "stream": ["-DFS_INT8_PART=1"],
            "convert": ["-DFS_INT8_PART=2"]}


def build(names):
    """{variant: ctypes library}, each built from csrc/int8_mm.cu alone."""
    from fish_speech_tpu_torch.ops import _kernels

    out_dir = ROOT / "build" / "int8_mm_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _kernels.CSRC / "int8_mm.cu"
    cmds = {n: [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *VARIANTS[n], "-shared",
                "-o", str(out_dir / f"{n}.so"), str(src)] for n in names}
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, c in cmds.items()}
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {n}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{n}.so"))
        lib.fs_int8_matmul.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.fs_int8_matmul.restype = i32
        lib.fs_int8_matmul_cluster.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.fs_int8_matmul_cluster.restype = i32
        libs[n] = lib
    return libs


def main():
    import torch

    from chip_smoke import (INT8_SHAPES, L2_COLD_BYTES, _bound, _device_ms,
                            _nvidia_smi)
    from fish_speech_tpu_torch.models.dual_ar import _rows_16_bytes_apart
    from fish_speech_tpu_torch.ops import int8 as int8_ops
    from fish_speech_tpu_torch.ops._kernels import check_launch, sm_count, stream_ptr
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="product,stream,convert")
    ap.add_argument("--rows", default="1,4,16,32")
    ap.add_argument("--shapes", default=",".join(n for n, _, _ in INT8_SHAPES))
    ap.add_argument("--runs", default="auto", choices=("auto", "sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_mm_bench: CUDA is not available")
    dev = torch.device("cuda:0")
    print(f"card: {_nvidia_smi()}")
    names = args.variants.split(",")
    if "product" not in names:
        names.insert(0, "product")
    libs = build(names)
    rows = [int(r) for r in args.rows.split(",")]
    wanted = args.shapes.split(",")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = sm_count(dev)
    for name, i, o in INT8_SHAPES:
        if name not in wanted:
            continue
        qw = quantize_int8(torch.randn((i, o), generator=gen, device=dev) * 0.02)
        q, s = _rows_16_bytes_apart(qw["q"]), qw["s"]
        del qw
        n_q = -(-L2_COLD_BYTES // (i * q.stride(0)))
        qs = [(q.clone() if o % 16 == 0 else _rows_16_bytes_apart(q), s.clone())
              for _ in range(n_q)]
        w_lib = (q.float() * s).to(torch.bfloat16)
        n_w = -(-L2_COLD_BYTES // (2 * i * o))
        ws = [w_lib.clone() for _ in range(n_w)]
        del w_lib
        for b in rows:
            x = torch.randn((b, i), generator=gen, device=dev).to(torch.bfloat16)
            auto = int8_ops.int8_gemv_plan(b, i, o, n_sm)
            plans = {auto}
            if args.runs == "sweep":
                stages = -(-i // int8_ops.CLUSTER_STAGE_ROWS)
                plans |= {(c, -(-stages // c) * int8_ops.CLUSTER_STAGE_ROWS)
                          for c in int8_ops.CLUSTERS if c <= stages}
            exact = (x.float() @ q.float()) * s
            scale = (x.float().abs() @ q.float().abs()) * s
            bound = _bound(2 * b * i * o, i * o + 4 * o + 2 * b * (i + o))
            iters = 20 if o > 100_000 else 100

            def check(got, label):
                err = (got.float() - exact).abs()
                if not bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all()):
                    raise SystemExit(f"{label} {name} B={b} disagrees")

            def line(label, ms, extra=""):
                print(f"{label:8s} {name} B={b} I={i} O={o}{extra}: device_ms={ms:.4f} "
                      f"({i * o / ms / 1e6:.0f} GB/s; bound {bound[0]:.4f} ms, "
                      f"{100 * bound[0] / ms:.1f}%)", flush=True)

            def cluster_call(lib, cluster, run):
                def call(k=0):
                    qk, sk = qs[k % n_q]
                    out = torch.empty((b, o), dtype=torch.bfloat16, device=dev)
                    check_launch(lib.fs_int8_matmul_cluster(
                        x.data_ptr(), qk.data_ptr(), sk.data_ptr(), out.data_ptr(), b, i,
                        o, qk.stride(0), cluster, run, stream_ptr(x)), "int8 cluster")
                    return out
                return call

            line("cuBLAS", _device_ms(lambda k=0: x @ ws[k % n_w], iters))
            for cluster, run in sorted(plans):
                for variant in names:
                    call = cluster_call(libs[variant], cluster, run)
                    if variant == "product":
                        check(call(), variant)
                    line(variant, _device_ms(call, iters),
                         f" cluster={cluster} run={run}"
                         + (" (auto)" if (cluster, run) == auto else ""))
            n_split, run = int8_ops.int8_gemv_split("gemv_mma", b, i, o, n_sm)
            work = torch.zeros(max(1, n_split * b * o), device=dev)
            counters = torch.zeros(-(-o // 128), dtype=torch.int32, device=dev)

            def mma(k=0):
                qk, sk = qs[k % n_q]
                out = torch.empty((b, o), dtype=torch.bfloat16, device=dev)
                check_launch(libs["product"].fs_int8_matmul(
                    x.data_ptr(), qk.data_ptr(), sk.data_ptr(), out.data_ptr(),
                    work.data_ptr(), counters.data_ptr(), b, i, o, qk.stride(0), 1, 0,
                    n_split, run, stream_ptr(x)), "int8 gemv_mma")
                return out

            check(mma(), "gemv_mma")
            cluster = cluster_call(libs["product"], *auto)
            t = [_device_ms(fn, iters) for fn in (mma, cluster, cluster, mma)]
            print(f"turns    {name} B={b}: gemv_mma {t[0]:.4f} / {t[3]:.4f} (n_split="
                  f"{n_split}), gemv_cluster {t[1]:.4f} / {t[2]:.4f} (cluster="
                  f"{auto[0]}); bound {bound[0]:.4f}", flush=True)
            del exact, scale
        del q, s, qs, ws
        torch.cuda.empty_cache()
    print(_nvidia_smi())


if __name__ == "__main__":
    main()
