#!/usr/bin/env python3
"""Where the int4 tensor-core kernel's time goes, on one NVIDIA GPU.

    python3 scripts/int4_tc_breakdown.py

Builds variants of `fish_speech_tpu_torch/csrc/int4_mm.cu` in which one or
two phases of `int4_wgmma_kernel` are compiled out (the cp.async copies of
x, packed bytes and scales; the dequantization into A fragments; the
wgmmas), times each on the slow stack's prefill shapes (B=1024, g=128)
with CUDA events, best of 3 x 20 calls, and prints one line per variant
beside the card's name and power limit. A variant without a phase computes
nothing meaningful; only its time is read. The builds go to
`build/int4_tc_breakdown/`.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the function whose body each variant replaces, and with what: every
# 16-byte cp.async (the stage's other bookkeeping stays), the
# dequantization, the wgmmas (the fragments are folded into one
# accumulator instead, so the compiler keeps the dequantization)
PHASES = {
    "copies": ("cp_async16", "return;"),
    "dequant": ("dequant_stage", "return;"),
    "wgmma": ("issue_wgmmas",
              "uint32_t s = 0;\n#pragma unroll\n  for (int f = 0; f < 32; ++f) "
              "s ^= frag[f / 4][f % 4];\n  acc[0] += __uint_as_float(s & 1u);\n"
              "  return;"),
}
VARIANTS = {"full": (), "no copies": ("copies",), "no dequant": ("dequant",),
            "no wgmma": ("wgmma",), "copies only": ("dequant", "wgmma"),
            "dequant only": ("copies", "wgmma"), "wgmma only": ("copies", "dequant")}
SHAPES = [("slow wqkv", 2560, 6144), ("slow wo", 4096, 2560),
          ("slow w13", 2560, 19456), ("slow w2", 9728, 2560)]


def _source() -> str:
    """The kernel source with an early return, under a macro, at the top of
    each phase's function."""
    csrc = ROOT / "fish_speech_tpu_torch" / "csrc"
    src = (csrc / "int4_mm.cu").read_text().replace(
        '#include "common.cuh"', f'#include "{csrc / "common.cuh"}"')
    for phase, (fn, body) in PHASES.items():
        pattern = re.compile(r"(__device__[^;{]*\b" + fn + r"\([^;{]*\{)")
        if len(pattern.findall(src)) != 1:
            raise SystemExit(f"cannot find the definition of {fn} in int4_mm.cu")
        src = pattern.sub(lambda m: m.group(1) + f"\n#ifdef SKIP_{phase.upper()}\n"
                          f"  {body}\n#endif\n", src)
    return src


def _build(out_dir: Path) -> dict:
    from fish_speech_tpu_torch.ops._kernels import NVCC_FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "int4_mm_breakdown.cu"
    src.write_text(_source())
    procs = {}
    for name, skipped in VARIANTS.items():
        lib = out_dir / (name.replace(" ", "_") + ".so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(src),
               *(f"-DSKIP_{p.upper()}" for p in skipped)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def main():
    import torch

    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES
    from fish_speech_tpu_torch.ops.int4 import ROUTES
    from fish_speech_tpu_torch.ops.quant import quantize_int4

    if not torch.cuda.is_available():
        raise SystemExit("int4_tc_breakdown: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    libs = _build(ROOT / "build" / "int4_tc_breakdown")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).fs_int4_matmul
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    b, g = 1024, 128
    for shape, i, o in SHAPES:
        qw = quantize_int4(torch.randn(i, o, generator=gen, device=dev) * 0.02,
                           group_size=g)
        x = torch.randn(b, i, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty(b, o, device=dev, dtype=torch.bfloat16)
        args = (x.data_ptr(), qw["p"].data_ptr(), qw["gs"].data_ptr(),
                out.data_ptr(), None, None, b, i, o, g,
                DTYPE_CODES[torch.bfloat16], ROUTES.index("wgmma"), 1, stream)
        for name, fn in fns.items():
            if fn(*args) != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            best = float("inf")
            for _ in range(3):
                start.record()
                for _ in range(20):
                    fn(*args)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 20)
            print(f"{smi} | {shape} B={b} I={i} O={o}: {name:12s} {best:.4f} ms "
                  f"({2 * b * i * o / best / 1e9:.1f} TFLOP/s)")


if __name__ == "__main__":
    main()
