#!/usr/bin/env python3
"""The fused int8 FFN kernel (`csrc/int8_ffn.cu`) timed on one GPU, by plan.

    PYTHONPATH=. python3 scripts/int8_ffn_bench.py [--rows 1,32]
        [--shapes "slow FFN,fast FFN"] [--runs auto|sweep]

For s2-pro's int8 FFNs (`chip_smoke.py:INT8_FFN_SHAPES`) and the given rows
of x (bf16), times one `fs_int8_ffn` call of the port's build in device
time: a CUDA graph of calls walking copies of the weights over twice the
L2, best of three replays, as `chip_smoke.py`'s `device_ms`. The plan is
`ops/int8_ffn.py:int8_ffn_plan` for the blocks the card holds at once
("auto"); with `--runs sweep` also every plan with phase A's and phase B's
runs halved or doubled. Beside them, the route the kernel replaces (two
`int8_matmul` launches with torch's gate between) and cuBLAS on the
dequantized bf16 weights, timed alike.

Every output is held to the plain version (2 bf16 ulps of max |y|). Prints
each time with its bytes bound and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

def _plans(auto, d, i, sweep):
    """The auto plan and, with `sweep`, those with either phase's runs halved
    or doubled (runs of whole 64-row units)."""
    from fish_speech_tpu_torch.ops.int8_ffn import MAX_SPLIT, STAGE_ROWS

    plans = {auto}
    if not sweep:
        return plans
    for fa in (0.5, 1, 2):
        for fb in (0.5, 1, 2):
            ra = max(STAGE_ROWS, int(auto.run_a * fa) // STAGE_ROWS * STAGE_ROWS)
            rb = max(STAGE_ROWS, int(auto.run_b * fb) // STAGE_ROWS * STAGE_ROWS)
            n_a, n_b = -(-d // ra), -(-i // rb)
            if max(n_a, n_b) <= MAX_SPLIT:
                plans.add(dataclasses.replace(auto, n_a=n_a, run_a=ra, n_b=n_b, run_b=rb))
    return plans


def main():
    import torch
    import torch.nn.functional as F

    from chip_smoke import INT8_FFN_SHAPES, L2_COLD_BYTES, _bound, _device_ms, _nvidia_smi
    from fish_speech_tpu_torch.ops._kernels import check_launch, load_kernels, stream_ptr
    from fish_speech_tpu_torch.ops.int8 import int8_matmul
    from fish_speech_tpu_torch.ops.int8_ffn import (int8_ffn_plan, int8_ffn_reference,
                                                    workspace_floats)
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,32")
    ap.add_argument("--shapes", default=",".join(n for n, _, _ in INT8_FFN_SHAPES))
    ap.add_argument("--runs", default="auto", choices=("auto", "sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_ffn_bench: CUDA is not available")
    dev = torch.device("cuda:0")
    print(f"card: {_nvidia_smi()}")
    lib = load_kernels()
    rows = [int(r) for r in args.rows.split(",")]
    wanted = args.shapes.split(",")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, d, i in INT8_FFN_SHAPES:
        if name not in wanted:
            continue
        w1, w3, w2 = (quantize_int8(torch.randn(shape, generator=gen, device=dev) * 0.02)
                      for shape in ((d, i), (d, i), (i, d)))
        w13 = {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}
        del w1, w3
        nbytes = 3 * d * i + 4 * (2 * i + d)
        n_w = -(-L2_COLD_BYTES // nbytes)
        ws = [({k: v.clone() for k, v in w13.items()}, {k: v.clone() for k, v in w2.items()})
              for _ in range(n_w)]
        lib13 = (w13["q"].float() * w13["s"]).to(torch.bfloat16)
        lib2 = (w2["q"].float() * w2["s"]).to(torch.bfloat16)
        n_lib = -(-L2_COLD_BYTES // (6 * d * i))
        libw = [(lib13.clone(), lib2.clone()) for _ in range(n_lib)]
        del lib13, lib2
        for b in rows:
            x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
            want = int8_ffn_reference(x, w13, w2).float()
            ulp = 2.0 ** (float(torch.log2(want.abs().max()).floor()) - 7)
            bound = _bound(6 * b * d * i, nbytes + 4 * b * d)

            def replaced(k=0):
                a, c = ws[k % n_w]
                u = int8_matmul(x, a["q"], a["s"])
                return int8_matmul(F.silu(u[:, :i]) * u[:, i:], c["q"], c["s"])

            def library(k=0):
                a, c = libw[k % n_lib]
                u = x @ a
                return (F.silu(u[:, :i]) * u[:, i:]) @ c

            for label, fn in (("replaced", replaced), ("cuBLAS", library)):
                print(f"{label:9s} {name} B={b}: device_ms={_device_ms(fn, 100):.4f}",
                      flush=True)
            n = ctypes.c_int()
            check_launch(lib.fs_int8_ffn_blocks(0, b, ctypes.byref(n)), "blocks")
            auto = int8_ffn_plan("mma", b, d, i, n.value)
            for p in sorted(_plans(auto, d, i, args.runs == "sweep"),
                            key=lambda p: (p.run_a, p.run_b)):
                p = dataclasses.replace(p, grid=min(n.value, max(
                    p.tiles_a * p.n_a, p.tiles_b * p.n_b)))
                work = torch.zeros(workspace_floats(p, b, d, i, x.dtype), device=dev)
                bar = torch.zeros(1, dtype=torch.int32, device=dev)

                def call(k=0, p=p, work=work, bar=bar):
                    a, c = ws[k % n_w]
                    q13, s13 = a["q"], a["s"]
                    out = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
                    rc = lib.fs_int8_ffn(
                        x.data_ptr(), q13.data_ptr(), q13[:, i:].data_ptr(), 2 * i,
                        s13.data_ptr(), s13[i:].data_ptr(), c["q"].data_ptr(), d,
                        c["s"].data_ptr(), out.data_ptr(), work.data_ptr(),
                        bar.data_ptr(), b, d, i, 1, 0, p.n_a, p.run_a, p.n_b,
                        p.run_b, p.grid, stream_ptr(x))
                    check_launch(rc, "int8_ffn")
                    return out

                got = call().float()
                err = (got - want).abs().max().item()
                if not err <= 2 * ulp:
                    raise SystemExit(f"{name} B={b} {p}: {err} > 2 ulps")
                ms = _device_ms(call, 100)
                print(f"int8_ffn  {name} B={b} blocks={n.value} grid={p.grid} "
                      f"A {p.tiles_a}x{p.n_a} runs of {p.run_a}, B {p.tiles_b}x{p.n_b} "
                      f"runs of {p.run_b}{' (auto)' if p == auto else ''}: "
                      f"device_ms={ms:.4f} ({nbytes / ms / 1e6:.0f} GB/s; bound "
                      f"{bound[0]:.4f} ms, {100 * bound[0] / ms:.1f}%) ulps="
                      f"{err / ulp:.2f}", flush=True)
        del w13, w2, ws, libw
        torch.cuda.empty_cache()
    print(_nvidia_smi())


if __name__ == "__main__":
    main()
