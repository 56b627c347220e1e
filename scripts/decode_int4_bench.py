#!/usr/bin/env python3
"""The decode attention (bf16 and int8 KV cache) and the int4 matvec against
their PyTorch yardsticks and against an earlier checkout, timed on the card.

    python3 scripts/decode_int4_bench.py [OTHER_CHECKOUT] [decode|kv8|int4 ...]

The names pick the benches (all three by default).

Device time of each call (`chip_smoke.py:_device_ms`: 100 calls captured in
one CUDA graph, best of three replays), so the wrappers' host cost is left
out; and host-inclusive time (`chip_smoke.py:_time_ms`, CUDA events around
a loop of Python calls, as `chip_smoke.py`'s `ms`). Each option is timed
twice, in turns (in order, then in reverse), and the two means averaged;
every line carries the card's name and power limit.

Decode attention (bf16, s2-pro's slow cache, 36 layers, Hkv=8 G=4 D=128, at
S = 4160 and the serving session's S = 2112, and the fast cache, 12 layers,
S = 10, Hkv=4 G=3; each call reads the next layer): the kernel through
`flash_decode_attention` against SDPA on the visible rows. Each kernel's
error against `flash_decode_reference` (fp32) is printed: max and mean abs
and the share of outputs equal to the reference rounded to bf16.

int8-KV decode (bf16 q, s2-pro's slow cache quantized as the int8 KV cache
holds it, at S = 2112 and S = 4160): the kernel through
`flash_decode_attention_kv8` against SDPA on K/V dequantized beforehand;
its error against the exact fp32 arithmetic (`flash_decode_kv8_reference`
on fp32 q, which keeps p * vs in fp32): max and mean abs and the share of
outputs equal to that reference rounded to bf16; the plain version on bf16
q (which rounds p * vs to bf16 once, as the JAX einsum) is scored the same.

int4 matvec (bf16 x, B = 1, s2-pro's eight shapes, g = 128): the kernel
through `int4_matmul` against cuBLAS on the bf16 W, both walking copies of
their weight over twice the L2, as in `chip_smoke.py`.

OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`), whose kernels have the
same C entry points as this checkout's, adds two columns per case:
`other_kernel`, its `csrc/` built into `build/decode_int4_bench/` and
called through this checkout's wrapper (device time and error), and
`other_wrapper`, its `ops/flash_decode.py` and `ops/int4.py` loaded on this
checkout's kernels (host-inclusive time: the wrappers' host cost alone
differs). For the int8-KV decode, whose C entry point changed when it
became one launch, a checkout of the two-kernel design (its wrapper still
has `KV8_CHUNK`) is timed whole, as `other_wrapper`: its own wrapper on
its own kernels (device time and host-inclusive, error); a later one as
`other_kernel`.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (INT4_SHAPES, L2_COLD_BYTES, _device_ms,  # noqa: E402
                        _time_ms)

DECODE = [(36, 4160, 8, 4, 1), (36, 4160, 8, 4, 257), (36, 4160, 8, 4, 4000),
          (36, 2112, 8, 4, 257), (36, 2112, 8, 4, 2048), (12, 10, 4, 3, 10)]
KV8 = [(36, 2112, 8, 4, (1, 257, 1100, 2048)), (36, 4160, 8, 4, (4000,))]
ITERS = 100


def _other_lib(tree):
    """The kernel library built from another checkout's `csrc/`, bound
    with this checkout's signatures."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = (ROOT / "build" / "decode_int4_bench"
               / f"kernels-{_kernels.source_hash()}" / "libfs_kernels.so")
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    mine = _kernels.load_kernels()
    for name in ("fs_flash_decode", "fs_flash_decode_kv8", "fs_int4_matmul"):
        getattr(lib, name).argtypes = getattr(mine, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _old_kv8(tree, lib_path):
    """The int8-KV wrapper of a checkout of the two-kernel design, bound
    to its own library (that design's C entry point)."""
    mod = _other_module(tree, "flash_decode")
    lib = ctypes.CDLL(lib_path)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_flash_decode_kv8.argtypes = [p] * 8 + [i32] * 7 + [ctypes.c_float, p]
    lib.fs_flash_decode_kv8.restype = i32
    mod.load_kernels = lambda: lib
    return mod


def _other_module(tree, name):
    """Another checkout's `ops/<name>.py`, loaded beside this one's: its
    wrapper on this checkout's `_kernels` (library, scratch, checks)."""
    path = Path(tree) / "fish_speech_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"other_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Lib:
    """`load_kernels` of a module pointed at another library for a call."""

    def __init__(self, mod, lib):
        self.mod, self.lib = mod, lib

    def __enter__(self):
        self.saved = self.mod.load_kernels
        self.mod.load_kernels = lambda: self.lib

    def __exit__(self, *exc):
        self.mod.load_kernels = self.saved


def _in_turns(fns, timer):
    """name -> fn(i): the timer's ms of each, in order then in reverse."""
    got = {name: [] for name in fns}
    for names in (list(fns), list(fns)[::-1]):
        for name in names:
            got[name].append(timer(fns[name], ITERS))
    return {name: sum(v) / len(v) for name, v in got.items()}


def _errors(name, got, want):
    """(max abs, mean abs, share equal to the reference rounded to bf16);
    exits where the kernel breaks chip_smoke's bounds (2e-2, 2e-3)."""
    err = (got.float() - want.float()).abs()
    equal = (got == want.to(got.dtype)).float().mean().item()
    if err.max().item() > 2e-2 or err.mean().item() > 2e-3:
        raise SystemExit(f"{name} disagrees with the plain version: max abs "
                         f"{err.max().item():.3e}")
    return err.max().item(), err.mean().item(), equal


def bench_decode(dev, other, smi):
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=dev).manual_seed(0)
    for n_layer, s, hkv, g, length in DECODE:
        q = torch.randn((1, hkv, g, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        kc, vc = (torch.randn((n_layer, 1, s, hkv, 128), generator=gen,
                              device=dev, dtype=torch.bfloat16) for _ in range(2))
        lens = torch.tensor([length], dtype=torch.int32, device=dev)

        def kept(i=0):
            return fd.flash_decode_attention(q, kc, vc, i % n_layer, lens)

        qs = q.reshape(1, hkv * g, 1, 128)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        want = fd.flash_decode_reference(q, kc, vc, 0, lens).float()
        errs = {"kept": _errors("decode", kept(0), want)}
        device = {"kept": kept, "sdpa": sdpa}
        host = {"kept": kept}
        if other is not None:
            lib, mod = other["lib"], other["flash_decode"]

            def other_kernel(i=0):
                with _Lib(fd, lib):
                    return kept(i)

            errs["other_kernel"] = _errors("other decode", other_kernel(0), want)
            device["other_kernel"] = other_kernel
            host["other_wrapper"] = lambda i=0: mod.flash_decode_attention(
                q, kc, vc, i % n_layer, lens)
        dev_ms = _in_turns(device, _device_ms)
        host_ms = _in_turns(host, _time_ms)
        bound = 2 * (2 * length * hkv * 128 + 2 * hkv * g * 128) / 3.35e12 * 1e3
        print(f"decode L={n_layer} S={s} Hkv={hkv} G={g} len={length}: device "
              + " ".join(f"{k}={v:.4f}" for k, v in dev_ms.items())
              + "; host-inclusive " + " ".join(f"{k}={v:.4f}" for k, v in host_ms.items())
              + "; errors " + " ".join(f"{k}={m:.3e}/{a:.3e}/{e:.4f}"
                                       for k, (m, a, e) in errs.items())
              + f"; bound={bound:.5f} ms; {smi}", flush=True)
        del kc, vc


def bench_kv8(dev, other, smi):
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=dev).manual_seed(0)
    for n_layer, s, hkv, g, lengths in KV8:
        kq, ks = _kv_quant(torch.randn((n_layer, 1, s, hkv, 128), generator=gen,
                                       device=dev, dtype=torch.bfloat16))
        vq, vs = _kv_quant(torch.randn((n_layer, 1, s, hkv, 128), generator=gen,
                                       device=dev, dtype=torch.bfloat16))
        for length in lengths:
            q = torch.randn((1, hkv, g, 128), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            lens = torch.tensor([length], dtype=torch.int32, device=dev)

            def kept(i=0):
                return fd.flash_decode_attention_kv8(q, kq, ks, vq, vs,
                                                     i % n_layer, lens)

            kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], torch.bfloat16)
            vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], torch.bfloat16)
            qs = q.reshape(1, hkv * g, 1, 128)

            def sdpa(i=0):
                return F.scaled_dot_product_attention(
                    qs, kd[i % n_layer].transpose(1, 2),
                    vd[i % n_layer].transpose(1, 2), enable_gqa=True)

            want = fd.flash_decode_kv8_reference(q.float(), kq, ks, vq, vs, 0,
                                                 lens)
            errs = {"kept": _errors("kv8", kept(0), want),
                    "plain": _errors("plain", fd.flash_decode_kv8_reference(
                        q, kq, ks, vq, vs, 0, lens), want)}
            device = {"kept": kept, "sdpa": sdpa}
            host = {"kept": kept}
            if other is not None and other["kv8_old"] is not None:
                mod = other["kv8_old"]

                def other_wrapper(i=0):
                    return mod.flash_decode_attention_kv8(q, kq, ks, vq, vs,
                                                          i % n_layer, lens)

                errs["other_wrapper"] = _errors("other kv8", other_wrapper(0), want)
                device["other_wrapper"] = host["other_wrapper"] = other_wrapper
            elif other is not None:
                lib = other["lib"]

                def other_kernel(i=0):
                    with _Lib(fd, lib):
                        return kept(i)

                errs["other_kernel"] = _errors("other kv8", other_kernel(0), want)
                device["other_kernel"] = other_kernel
            dev_ms = _in_turns(device, _device_ms)
            host_ms = _in_turns(host, _time_ms)
            bound = (2 * length * hkv * 128 + 4 * length * hkv
                     + 4 * hkv * g * 128) / 3.35e12 * 1e3
            print(f"kv8 L={n_layer} S={s} Hkv={hkv} G={g} len={length}: device "
                  + " ".join(f"{k}={v:.4f}" for k, v in dev_ms.items())
                  + "; host-inclusive " + " ".join(f"{k}={v:.4f}" for k, v in host_ms.items())
                  + "; errors vs fp32 " + " ".join(f"{k}={m:.3e}/{a:.3e}/{e:.4f}"
                                                   for k, (m, a, e) in errs.items())
                  + f"; bound={bound:.5f} ms; {smi}", flush=True)
            del kd, vd
        del kq, ks, vq, vs


def bench_int4(dev, other, smi):
    import torch

    from fish_speech_tpu_torch.ops import int4
    from fish_speech_tpu_torch.ops.quant import quantize_int4

    gen = torch.Generator(device=dev).manual_seed(0)
    g = 128
    for name, i, o in INT4_SHAPES:
        qw = quantize_int4(torch.randn((i, o), generator=gen, device=dev) * 0.02,
                           group_size=g)
        x = torch.randn((1, i), generator=gen, device=dev).to(torch.bfloat16)
        n_q = -(-L2_COLD_BYTES // (qw["p"].numel() + 4 * qw["gs"].numel()))
        qs = [(qw["p"].clone(), qw["gs"].clone()) for _ in range(n_q)]
        w = int4.int4_dequant_bf16(qw["p"], qw["gs"])
        n_w = -(-L2_COLD_BYTES // (2 * i * o))
        ws = [w.clone() for _ in range(n_w)]
        want = int4.int4_matmul_bf16w_reference(x, qw["p"], qw["gs"])

        def kept(k=0):
            return int4.int4_matmul(x, *qs[k % n_q])

        device = {"kept": kept, "cublas": lambda k=0: x @ ws[k % n_w]}
        host = {"kept": kept}
        errs = {"kept": _errors("int4", kept(0), want)}
        if other is not None:
            lib, mod = other["lib"], other["int4"]

            def other_kernel(k=0):
                with _Lib(int4, lib):
                    return kept(k)

            errs["other_kernel"] = _errors("other int4", other_kernel(0), want)
            device["other_kernel"] = other_kernel
            host["other_wrapper"] = lambda k=0: mod.int4_matmul(x, *qs[k % n_q])
        dev_ms = _in_turns(device, _device_ms)
        host_ms = _in_turns(host, _time_ms)
        bound = (i // 2 * o + 4 * (i // g) * o + 2 * (i + o)) / 3.35e12 * 1e3
        print(f"int4 {name} B=1 I={i} O={o} g={g}: device "
              + " ".join(f"{k}={v:.4f}" for k, v in dev_ms.items())
              + "; host-inclusive " + " ".join(f"{k}={v:.4f}" for k, v in host_ms.items())
              + "; errors " + " ".join(f"{k}={m:.3e}/{a:.3e}/{e:.4f}"
                                       for k, (m, a, e) in errs.items())
              + f"; bound={bound:.4f} ms; {smi}", flush=True)
        del qs, ws


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_int4_bench: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    benches = {"decode": bench_decode, "kv8": bench_kv8, "int4": bench_int4}
    picked = [a for a in sys.argv[1:] if a in benches] or list(benches)
    trees = [a for a in sys.argv[1:] if a not in benches]
    other = None
    if trees:
        other = {"lib": _other_lib(trees[0]),
                 "flash_decode": _other_module(trees[0], "flash_decode"),
                 "int4": _other_module(trees[0], "int4"), "kv8_old": None}
        if hasattr(other["flash_decode"], "KV8_CHUNK"):
            other["kv8_old"] = _old_kv8(trees[0], other["lib"]._name)
    for name in picked:
        benches[name](dev, other, smi)


if __name__ == "__main__":
    main()
