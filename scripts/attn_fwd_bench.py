#!/usr/bin/env python3
"""The tensor-core attention forwards against SDPA, on one NVIDIA GPU.

    python3 scripts/attn_fwd_bench.py [LABEL=path/to/attn_wgmma.cuh ...]

Builds the kernel library from the checkout's sources and, for each
LABEL=HEADER given, from a copy of them in which `csrc/attn_wgmma.cuh` is
replaced by HEADER (another version of the mainloop, for an A/B in one
process). Each build's training forward and prefill (bf16, the "wgmma"
route) are first held to their plain versions, at small shapes (D=64,
ragged T, padding, offsets) and at the timed ones, to `chip_smoke.py`'s
bounds. Then every build is timed at s2-pro's shapes (H=32, Hkv=8, D=128)
with CUDA events, 50 back-to-back calls of the C entry point (no Python
wrapper in the loop), best of 3, in turns (builds in order, then in
reverse, the two means averaged), beside one SDPA call on the same inputs:
`is_causal` where no key is padded and no offset is set (the same
function), else the mask tensor, and for a padded training batch
`is_causal` too (the same O on every row that is not padding). One line per
shape and build, each with the card's name and power limit. The builds go
to `build/attn_fwd_bench/`.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (kind, B, T, right padding of each row (training) or offsets (prefill))
TIMED = [("train", 2, 1024, [0, 100]), ("train", 2, 1024, [0, 0]),
         ("train", 1, 4096, [0]), ("prefill", 1, 1024, [0]),
         ("prefill", 2, 1024, [0, 0]), ("prefill", 1, 4096, [0]),
         ("prefill", 2, 600, [0, 129])]
# (kind, B, T, H, Hkv, D, padding or offsets): checked, not timed
SMALL = [("train", 2, 100, 4, 2, 64, [0, 7]), ("train", 1, 600, 8, 2, 64, [0]),
         ("train", 1, 130, 8, 2, 128, [3]), ("prefill", 2, 100, 4, 2, 64, [0, 7]),
         ("prefill", 2, 300, 4, 1, 64, [200, 0]), ("prefill", 1, 64, 32, 8, 128, [0])]


def _builds(variants, header_name="attn_wgmma.cuh", build="attn_fwd_bench"):
    """label -> csrc directory: the checkout's, then one copy per LABEL=HEADER
    variant in which `header_name` is replaced by HEADER, under
    `build/<build>/`."""
    from fish_speech_tpu_torch.ops import _kernels

    dirs = {"checkout": _kernels.CSRC}
    for spec in variants:
        label, header = spec.split("=", 1)
        out = ROOT / "build" / build / label / "csrc"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_kernels.CSRC, out)
        shutil.copy(header, out / header_name)
        dirs[label] = out
    return dirs


def _use(csrc):
    """Point the port's kernel loader at `csrc` and load its library."""
    from fish_speech_tpu_torch.ops import _kernels

    _kernels.CSRC = Path(csrc)
    _kernels.load_kernels.cache_clear()
    return _kernels.load_kernels()


def _inputs(kind, b, t, h, hkv, d, spec, gen, dev):
    import torch

    q, k, v = (torch.randn((b, t, n, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for n in (h, hkv, hkv))
    if kind == "train":
        mask = torch.ones((b, t), dtype=torch.int32, device=dev)
        for i, n in enumerate(spec):
            if n:
                mask[i, -n:] = 0
    else:
        mask = torch.tensor(spec, dtype=torch.int32, device=dev)
    return q, k, v, mask


def _check(kind, q, k, v, mask):
    """True if the build in use agrees with the plain version (chip_smoke's
    bounds: training O 2e-2 + 2^-7 |O| and 2e-3 mean, lse 1e-4; prefill 2e-2
    max and 2e-3 mean)."""
    from fish_speech_tpu_torch.ops import flash_prefill, flash_train

    if kind == "train":
        o, lse = flash_train.flash_train_forward(q, k, v, mask)
        want, want_lse = flash_train.flash_train_forward_reference(q, k, v, mask)
        err = (o.float() - want.float()).abs()
        return (bool((err <= 2e-2 + 2 ** -7 * want.float().abs()).all())
                and err.mean().item() <= 2e-3
                and (lse - want_lse).abs().max().item() <= 1e-4)
    o = flash_prefill.flash_prefill_attention(q, k, v, mask)
    err = (o.float() - flash_prefill.flash_prefill_reference(q, k, v, mask).float()).abs()
    return err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


def _best_ms(fn, iters=50, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _launcher(lib, kind, q, k, v, mask):
    """A call of the C entry point on preallocated outputs."""
    import torch

    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES

    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (b, t, h, k.shape[2], d, DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
              stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr())
    if kind == "train":
        fn, args = lib.fs_flash_train_fwd, (*ptrs, lse.data_ptr(), *common)
    else:
        fn, args = lib.fs_flash_prefill, (*ptrs, *common)

    def call():
        if fn(*args) != 0:
            raise SystemExit(f"{kind}: launch failed")
    return call, (out, lse)


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("attn_fwd_bench: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    libs = {}
    for label, csrc in _builds(sys.argv[1:]).items():
        libs[label] = _use(csrc)
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = SMALL + [(kind, b, t, 32, 8, 128, spec) for kind, b, t, spec in TIMED]
        for kind, b, t, h, hkv, d, spec in cases:
            ok = _check(kind, *_inputs(kind, b, t, h, hkv, d, spec, gen, dev))
            print(f"{label}: {kind} B={b} T={t} H={h} Hkv={hkv} D={d} {spec}: "
                  f"agrees with the plain version: {ok}")
            if not ok:
                raise SystemExit(f"{label} disagrees with the plain version")
        torch.cuda.empty_cache()

    order = list(libs) + list(libs)[::-1]
    for kind, b, t, spec in TIMED:
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v, mask = _inputs(kind, b, t, 32, 8, 128, spec, gen, dev)
        # (call, its outputs): the outputs live as long as the calls
        calls = {label: _launcher(lib, kind, q, k, v, mask)
                 for label, lib in libs.items()}
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(_best_ms(calls[label][0]))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = {"is_causal": _best_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))}
        if any(spec):
            i = torch.arange(t, device=dev)
            if kind == "train":
                keys = mask[:, None, :].bool()
            else:
                keys = i[None, None, :] >= mask[:, None, None]
            m = ((i[None, :] <= i[:, None])[None] & keys)[:, None]
            sdpa["mask"] = _best_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True))
        if kind == "train":
            pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in spec)
        else:
            pairs = sum((t - o) * (t - o + 1) // 2 for o in spec)
        flops = 4 * 32 * 128 * pairs
        lib_text = ", ".join(f"SDPA {n} {ms:.4f} ms" for n, ms in sdpa.items())
        for label, ts in times.items():
            ms = sum(ts) / len(ts)
            print(f"{smi} | {kind} B={b} T={t} H=32 Hkv=8 D=128 {spec}: {label} "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; turns "
                  f"{', '.join(f'{x:.4f}' for x in ts)}); {lib_text}")
        del q, k, v, mask, calls


if __name__ == "__main__":
    main()
