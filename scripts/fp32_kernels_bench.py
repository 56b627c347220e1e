#!/usr/bin/env python3
"""The fp32 int4 GEMM and the fp32 prefill / suffix attention on the tensor
cores ("fp32_tc") against an earlier checkout's CUDA-core kernels, the
library call and their plain versions, timed on the card.

    python3 scripts/fp32_kernels_bench.py [OTHER_CHECKOUT] [--sweep] [--attn]

Shapes:
* the int4 matmul on fp32 x (`int4_tf32_kernel`): s2-pro's slow wqkv, wo,
  w13, w2 and fast w13 at B = 9, 128 and 1024 with g = 128, and JAX's tiny
  widths at B = 64 (`chip_smoke.py:FP32_TC_SHAPES`, `FP32_TC_TINY`); the
  library call is cuBLAS in fp32 (TF32 off) on the dequantized W;
* the prefill (`attn_tf32_kernel`): B=1 at T=256 and 1024 (H=32 Hkv=8
  D=128), T=128 (the parity tool's bucket), T=256 at H=4 Hkv=2 D=64, and
  JAX's tiny heads (H=2 Hkv=1 D=32) at T=64 and 256; SDPA in fp32 with
  `is_causal` beside it;
* the suffix over an fp32 and an int8 cache: L=2 S=264 start=140 Ts=64 at
  H=2 Hkv=1 D=32 and H=4 Hkv=2 D=64, and the serving cache's full width
  L=8 S=2176 start=951 Ts=64 H=32 Hkv=8 D=128 (each timed call reads the
  next layer); SDPA in fp32 under the suffix's mask (over the dequantized
  cache for int8) beside it.
Inputs are fp32 from N(0, 1) (int4 weights N(0, 0.02), int8 caches as
`chip_smoke.py:_suffix_cache` makes them). Each kernel is held to its plain
version (int4: 1e-5 of |x| @ |W|; attention: 1e-4) and timed in device time
(`chip_smoke.py:_device_ms`: the calls captured in one CUDA graph, best of
three replays) in turns with the other kernels of the row (in order, then
in reverse; the means of the two), beside its CUDA-event time (`ms`), the
plain version's and the bound (`chip_smoke.py:_tf32_bound`: the TF32
products the kernel issues, two a product for the int4 GEMM and the int8
cache, three for fp32 attention, at 495 TFLOP/s, or the bytes), with
`fp32_bound_ms` (`_bound` at fp32's 67 TFLOP/s on the CUDA cores) beside
it for comparison. The weights and caches are warm in
L2 where they fit. Every line carries the card's name and power limit; the
last line is all the numbers as one JSON object, which is also written to
`chiprun_out/fp32_kernels_bench.json`.

OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`) adds `old`: its `csrc/`
built into `build/fp32_kernels_bench/`, its `fs_int4_matmul` at route code
2 (its "fp32_tiled", `int4_gemm_kernel`), its `fs_flash_prefill` and
`fs_flash_suffix` on fp32 (its `prefill_kernel`, which takes no plan).

`--attn` times the attention rows alone (the prefill and the suffix): an
OTHER_CHECKOUT from after the int4 kernel's redesign has no "fp32_tiled"
route to time in turns.

`--sweep` times this checkout's int4 kernel at every tile shape
(`ops/int4.py:FP32_TC_TILES`) and split of the groups into 1-16 runs at
the s2-pro shapes: what `FP32_TC_RATE`, the plan's model of each shape's
rate, is set by.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (FP32_TC_ROWS, FP32_TC_SHAPES, FP32_TC_TINY, PEAK_FP32,  # noqa: E402
                        _bound, _device_ms, _nvidia_smi, _sdpa, _tf32_bound, _time_ms)

ITERS = 20

PREFILL = [(1, 256, 32, 8, 128), (1, 1024, 32, 8, 128), (1, 128, 32, 8, 128),
           (1, 256, 4, 2, 64), (1, 64, 2, 1, 32), (1, 256, 2, 1, 32)]
SUFFIX = [(2, 264, 2, 1, 32, 140, 64), (2, 264, 4, 2, 64, 140, 64),
          (8, 2176, 32, 8, 128, 951, 64)]


def _other(tree):
    """Another checkout's kernel library, its fp32 entry points bound."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = (ROOT / "build" / "fp32_kernels_bench" / f"kernels-{_kernels.source_hash()}"
               / "libfs_kernels.so")
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fs_int4_matmul.argtypes = [p] * 6 + [i32] * 7 + [p]
    lib.fs_int4_matmul.restype = i32
    lib.fs_flash_prefill.argtypes = [p] * 5 + [i32] * 6 + [f32, p]
    lib.fs_flash_prefill.restype = i32
    lib.fs_flash_suffix.argtypes = [p] * 9 + [i32] * 11 + [f32, p]
    lib.fs_flash_suffix.restype = i32
    return lib


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _check(rc, what):
    if rc:
        raise SystemExit(f"{what}: CUDA error {rc}")


def _in_turns(fns, iters):
    """Device ms of each of `fns` ({name: fn}), in turns: in order, then in
    reverse, the two means averaged."""
    order = list(fns)
    ms = {k: [] for k in order}
    for names in (order, order[::-1]):
        for k in names:
            ms[k].append(_device_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _line(row, smi):
    ms = " ".join(f"{k}={v:.5f}" for k, v in row["device_ms"].items())
    ratios = ""
    if "old" in row["device_ms"]:
        ratios = f" old/new={row['device_ms']['old'] / row['device_ms']['new']:.2f}"
    lib = next(k for k in row["device_ms"] if k not in ("new", "old"))
    ratios += f" new/{lib}={row['device_ms']['new'] / row['device_ms'][lib]:.2f}"
    extra = f" fp32_bound={row['fp32_bound_ms']:.5f}"
    return (f"{smi} | {row['kernel']} [{row['shape']}]: dev {ms}{ratios}; ms="
            f"{row['ms']:.5f} plain={row['plain_ms']:.4f} bound={row['bound_ms']:.5f} "
            f"({row['bound_by']}){extra} share={row['bound_ms'] / row['device_ms']['new']:.3f}"
            f" max_abs_err={row['max_abs_err']:.3e}")


def int4_rows(dev, old, smi):
    import torch

    from fish_speech_tpu_torch.ops.int4 import (FP32_TC_TILES, fp32_tc_plan,
                                                 fp32_tc_resident, int4_matmul,
                                                 int4_matmul_reference)
    from fish_speech_tpu_torch.ops._kernels import sm_count
    from fish_speech_tpu_torch.ops.quant import _int4_effective_weight, quantize_int4

    gen = torch.Generator(device=dev).manual_seed(31)
    rows = []
    shapes = ([(b, name, i, o, 128) for b in FP32_TC_ROWS for name, i, o in FP32_TC_SHAPES]
              + [(64, *t) for t in FP32_TC_TINY])
    for b, name, i, o, g in shapes:
        qw = quantize_int4(torch.randn(i, o, generator=gen, device=dev) * 0.02, group_size=g)
        p, gs = qw["p"], qw["gs"]
        x = torch.randn(b, i, generator=gen, device=dev)
        w = _int4_effective_weight(qw, torch.float32)
        want = int4_matmul_reference(x, p, gs)
        scale = x.abs() @ w.abs()
        got = int4_matmul(x, p, gs)
        err = (got - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), name
        iters = 10 if b >= 1024 else ITERS
        fns = {"new": lambda k=0: int4_matmul(x, p, gs), "cublas": lambda k=0: x @ w}
        if old is not None:
            out = torch.empty_like(got)

            def call(k=0):
                _check(old.fs_int4_matmul(x.data_ptr(), p.data_ptr(), gs.data_ptr(),
                                          out.data_ptr(), None, None, b, i, o, g, 0, 2, 1,
                                          _stream()), "old fs_int4_matmul")
                return out

            back = call()
            assert bool(((back - want).abs() <= 1e-5 * scale + 1e-6).all()), name
            fns["old"] = call
        dms = _in_turns(fns, iters)
        flops = 2 * b * i * o
        nbytes = i // 2 * o + 4 * (i // g) * o + 4 * b * (i + o)
        bound = _tf32_bound(flops, nbytes, 2)
        tile, n_split = fp32_tc_plan(b, i, o, g, sm_count(dev), fp32_tc_resident(dev))
        bm, bn = FP32_TC_TILES[tile]
        rows.append(dict(
            kernel="int4_tf32",
            shape=f"{name} B={b} I={i} O={o} g={g} tile {bm}x{bn} runs {n_split}",
            device_ms=dms, ms=_time_ms(fns["new"], iters),
            plain_ms=_time_ms(lambda k=0: int4_matmul_reference(x, p, gs), 5),
            bound_ms=bound[0], bound_by=bound[1],
            fp32_bound_ms=_bound(flops, nbytes, PEAK_FP32)[0],
            tflop_s=flops / dms["new"] / 1e9, max_abs_err=err.max().item()))
        print(_line(rows[-1], smi), flush=True)
        del qw, p, gs, x, w, want, scale, got
        torch.cuda.empty_cache()
    return rows


def prefill_rows(dev, old, smi):
    import torch

    from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                         flash_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(32)
    rows = []
    for b, t, h, hkv, d in PREFILL:
        q, k, v = (torch.randn(b, t, n, d, generator=gen, device=dev) for n in (h, hkv, hkv))
        off = torch.zeros(b, dtype=torch.int32, device=dev)
        want = flash_prefill_reference(q, k, v, off)
        got = flash_prefill_attention(q, k, v, off)
        err = (got - want).abs().max().item()
        assert err <= 1e-4, (t, d, err)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns = {"new": lambda i=0: flash_prefill_attention(q, k, v, off),
               "sdpa": lambda i=0: _sdpa(qt, kt, vt, None, True)}
        if old is not None:
            out = torch.empty_like(q)

            def call(i=0):
                _check(old.fs_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            off.data_ptr(), out.data_ptr(), b, t, h, hkv, d, 0,
                                            1.0 / math.sqrt(d), _stream()), "old prefill")
                return out

            assert (call() - want).abs().max().item() <= 1e-4
            fns["old"] = call
        dms = _in_turns(fns, ITERS)
        flops = 4 * h * d * b * t * (t + 1) // 2
        nbytes = 4 * b * t * d * 2 * (h + hkv)
        bound = _tf32_bound(flops, nbytes, 3)
        rows.append(dict(
            kernel="attn_tf32 prefill", shape=f"B={b} T={t} H={h} Hkv={hkv} D={d} fp32",
            device_ms=dms, ms=_time_ms(fns["new"], ITERS),
            plain_ms=_time_ms(lambda i=0: flash_prefill_reference(q, k, v, off), 5),
            bound_ms=bound[0], bound_by=bound[1],
            fp32_bound_ms=_bound(flops, nbytes, PEAK_FP32)[0],
            tflop_s=flops / dms["new"] / 1e9, max_abs_err=err))
        print(_line(rows[-1], smi), flush=True)
        del q, k, v, want, got
        torch.cuda.empty_cache()
    return rows


def suffix_rows(dev, old, smi):
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES  # noqa: F401
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_suffix_attention,
                                                         flash_suffix_reference)

    gen = torch.Generator(device=dev).manual_seed(33)
    rows = []
    for n_layer, s, h, hkv, d, start, ts in SUFFIX:
        for kv8 in (False, True):
            shape = (n_layer, 1, s, hkv, d)
            if kv8:
                cache = {}
                for n in ("k", "v"):
                    cache[n] = (torch.randn(shape, generator=gen, device=dev) * 40).clamp(
                        -127, 127).round().to(torch.int8)
                    cache[n + "s"] = ((1 + 0.1 * torch.randn(shape[:4], generator=gen,
                                                             device=dev).clamp(-1, 1)) / 40
                                      ).to(torch.bfloat16)
            else:
                cache = {n: torch.randn(shape, generator=gen, device=dev) for n in "kv"}
            q = torch.randn(1, ts, h, d, generator=gen, device=dev)
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            err = 0.0
            for layer in (0, n_layer - 1):
                err = max(err, (flash_suffix_attention(q, cache, layer, st)
                                - flash_suffix_reference(q, cache, layer, st)).abs().max().item())
            assert err <= 1e-4, (d, kv8, err)
            kv = start + ts
            i_, j_ = torch.arange(ts, device=dev), torch.arange(kv, device=dev)
            mask = (j_[None, :] <= start + i_[:, None])[None, None]
            if kv8:
                kl = [(cache["k"][i, :, :kv].float() * cache["ks"][i, :, :kv, :, None].float()
                       ).transpose(1, 2) for i in range(n_layer)]
                vl = [(cache["v"][i, :, :kv].float() * cache["vs"][i, :, :kv, :, None].float()
                       ).transpose(1, 2) for i in range(n_layer)]
            else:
                kl = [cache["k"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
                vl = [cache["v"][i, :, :kv].transpose(1, 2) for i in range(n_layer)]
            qt = q.transpose(1, 2)
            fns = {"new": lambda i=0: flash_suffix_attention(q, cache, i % n_layer, st),
                   "sdpa_mask": lambda i=0: F.scaled_dot_product_attention(
                       qt, kl[i % n_layer], vl[i % n_layer], attn_mask=mask, enable_gqa=True)}
            if old is not None:
                out = torch.empty_like(q)
                esz = 1 if kv8 else 4
                kv_layer, sc_layer = s * hkv * d * esz, s * hkv * 2

                def call(i=0):
                    lay = i % n_layer
                    _check(old.fs_flash_suffix(
                        q.data_ptr(), cache["k"].data_ptr() + lay * kv_layer,
                        cache["v"].data_ptr() + lay * kv_layer,
                        cache["ks"].data_ptr() + lay * sc_layer if kv8 else None,
                        cache["vs"].data_ptr() + lay * sc_layer if kv8 else None,
                        st.data_ptr(), out.data_ptr(), None, None, 1, ts, h, hkv, d, s, 0,
                        int(kv8), 64, 1, -(-s // 64), 1.0 / math.sqrt(d), _stream()),
                        "old suffix")
                    return out

                assert (call(1) - flash_suffix_reference(q, cache, 1, st)).abs().max() <= 1e-4
                fns["old"] = call
            dms = _in_turns(fns, ITERS)
            pairs = ts * start + ts * (ts + 1) // 2
            flops = 4 * d * h * pairs
            nbytes = 2 * 4 * q.numel() + kv * hkv * d * (1 if kv8 else 4) * 2 + (
                kv * hkv * 2 * 2 if kv8 else 0)
            bound = _tf32_bound(flops, nbytes, 2 if kv8 else 3)
            rows.append(dict(
                kernel="attn_tf32 suffix",
                shape=f"L={n_layer} S={s} H={h} Hkv={hkv} D={d} start={start} Ts={ts} "
                      f"{'int8' if kv8 else 'fp32'} cache",
                device_ms=dms, ms=_time_ms(fns["new"], ITERS),
                plain_ms=_time_ms(lambda i=0: flash_suffix_reference(q, cache, i % n_layer, st),
                                  5),
                bound_ms=bound[0], bound_by=bound[1],
                fp32_bound_ms=_bound(flops, nbytes, PEAK_FP32)[0], max_abs_err=err))
            print(_line(rows[-1], smi), flush=True)
            del cache, kl, vl
            torch.cuda.empty_cache()
    return rows


def sweep_rows(dev, smi):
    """This checkout's int4 kernel at every tile shape and split of the
    groups into runs, through its C entry point, at the s2-pro shapes."""
    import torch

    from fish_speech_tpu_torch.ops._kernels import load_kernels
    from fish_speech_tpu_torch.ops.int4 import FP32_TC_TILES, fp32_tc_resident
    from fish_speech_tpu_torch.ops.quant import quantize_int4

    lib = load_kernels()
    gen = torch.Generator(device=dev).manual_seed(34)
    rows = []
    print(f"{smi} | resident blocks an SM per tile shape {fp32_tc_resident(dev)}")
    work = torch.empty(16 * 1024 * 19456, device=dev)
    counters = torch.zeros(65536, dtype=torch.int32, device=dev)
    for b in FP32_TC_ROWS:
        for name, i, o in FP32_TC_SHAPES:
            qw = quantize_int4(torch.randn(i, o, generator=gen, device=dev) * 0.02)
            x = torch.randn(b, i, generator=gen, device=dev)
            out = torch.empty(b, o, device=dev)
            groups = i // 2 // 128
            ms = {}
            for tile in range(len(FP32_TC_TILES)):
                for n in (1, 2, 3, 4, 6, 8, 12, 16):
                    if n > groups or n * b * o > work.numel():
                        continue

                    def call(k=0, tile=tile, n=n):
                        _check(lib.fs_int4_matmul_fp32(
                            x.data_ptr(), qw["p"].data_ptr(), qw["gs"].data_ptr(),
                            out.data_ptr(), work.data_ptr(), counters.data_ptr(), b, i, o,
                            128, tile, n, _stream()), "sweep")
                        return out

                    key = "x".join(map(str, FP32_TC_TILES[tile])) + f"/{n}"
                    ms[key] = round(_device_ms(call, 10), 5)
            best = min(ms, key=ms.get)
            rows.append(dict(shape=f"{name} B={b} I={i} O={o}", best=best, device_ms=ms))
            print(f"{smi} | sweep {rows[-1]}", flush=True)
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fp32_kernels_bench: CUDA is not available")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    old = _other(args[0]) if args else None
    result = {"card": smi, "tf32": "off (torch.backends.cuda.matmul.allow_tf32 = False)"}
    if "--attn" not in sys.argv:
        result["int4"] = int4_rows(dev, old, smi)
    result["prefill"] = prefill_rows(dev, old, smi)
    result["suffix"] = suffix_rows(dev, old, smi)
    if "--sweep" in sys.argv:
        result["sweep"] = sweep_rows(dev, smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fp32_kernels_bench.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
