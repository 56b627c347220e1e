#!/usr/bin/env python3
"""The int8 matmul kernel (`csrc/int8_mm.cu`) timed on one GPU, by variant.

    PYTHONPATH=. python3 scripts/int8_mm_bench.py [--variants product,stream,...]
        [--rows 1,32] [--shapes "slow wqkv,LM head"] [--runs auto|sweep]

Builds `csrc/int8_mm.cu` alone into one shared library per variant (`nvcc`
with the port's flags and the variant's -D flags, all started together,
under `build/int8_mm_bench/`), then for s2-pro's int8 decode shapes
(`chip_smoke.py:INT8_SHAPES`) and the given rows of x (bf16) times one
`fs_int8_matmul` call in device time: a CUDA graph of calls walking copies
of the weight over twice the L2, best of three replays, as `chip_smoke.py`'s
`device_ms`. The runs of I are `ops/int8.py:int8_gemv_split`'s ("auto"), or
with `--runs sweep` also every run of 1, 2, 4, 8, ... stages. Variants:

  product  the kernel as the port builds it
  stream   INT8_MM_PART=1: the weight stream alone (no conversion, no mma)
  convert  INT8_MM_PART=2: the stream and the int8 -> bf16 conversions
  stages2, stages8  INT8_MM_STAGES=2 / 8 stages in flight

The product variants' outputs are held to the plain version (2^-8 |y| +
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

VARIANTS = {"product": [], "stream": ["-DINT8_MM_PART=1"],
            "convert": ["-DINT8_MM_PART=2"], "stages2": ["-DINT8_MM_STAGES=2"],
            "stages8": ["-DINT8_MM_STAGES=8"]}


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
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {n}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{n}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fs_int8_matmul.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.fs_int8_matmul.restype = i32
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
    ap.add_argument("--rows", default="1,32")
    ap.add_argument("--shapes", default=",".join(n for n, _, _ in INT8_SHAPES))
    ap.add_argument("--runs", default="auto", choices=("auto", "sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_mm_bench: CUDA is not available")
    dev = torch.device("cuda:0")
    print(f"card: {_nvidia_smi()}")
    names = args.variants.split(",")
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
        for b in rows:
            x = torch.randn((b, i), generator=gen, device=dev).to(torch.bfloat16)
            auto = int8_ops.int8_gemv_split("gemv_mma", b, i, o, n_sm)
            splits = {auto}
            if args.runs == "sweep":
                stages = -(-i // int8_ops.STAGE_ROWS)
                per = 1
                while per <= stages:
                    run = per * int8_ops.STAGE_ROWS
                    splits.add((-(-i // run), run))
                    per *= 2
            exact = (x.float() @ q.float()) * s
            scale = (x.float().abs() @ q.float().abs()) * s
            bound = _bound(2 * b * i * o, i * o + 4 * o + 2 * b * (i + o))
            for n_split, run in sorted(splits):
                work = torch.zeros(max(1, n_split * b * o), device=dev)
                counters = torch.zeros(-(-o // 128), dtype=torch.int32, device=dev)
                for variant in names:
                    lib = libs[variant]

                    def call(k=0, lib=lib, work=work, counters=counters,
                             n_split=n_split, run=run):
                        qk, sk = qs[k % n_q]
                        out = torch.empty((b, o), dtype=torch.bfloat16, device=dev)
                        rc = lib.fs_int8_matmul(
                            x.data_ptr(), qk.data_ptr(), sk.data_ptr(), out.data_ptr(),
                            work.data_ptr(), counters.data_ptr(), b, i, o, qk.stride(0),
                            1, 0, n_split, run, stream_ptr(x))
                        check_launch(rc, f"int8 {variant}")
                        return out

                    got = call()
                    ok = ""
                    if variant in ("product", "stages2", "stages8"):
                        err = (got.float() - exact).abs()
                        good = bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all())
                        ok = f" ok={good}"
                        if not good:
                            raise SystemExit(f"{variant} {name} B={b} disagrees")
                    iters = 20 if o > 100_000 else 100
                    ms = _device_ms(call, iters)
                    gbs = (i * o) / ms / 1e6
                    print(f"{variant:8s} {name} B={b} I={i} O={o} n_split={n_split} "
                          f"run={run}{' (auto)' if (n_split, run) == auto else ''}: "
                          f"device_ms={ms:.4f} ({gbs:.0f} GB/s; bound {bound[0]:.4f} "
                          f"ms, {100 * bound[0] / ms:.1f}%){ok}", flush=True)
            del exact, scale
        del q, s, qs
        torch.cuda.empty_cache()
    print(_nvidia_smi())


if __name__ == "__main__":
    main()
