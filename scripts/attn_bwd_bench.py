#!/usr/bin/env python3
"""The tensor-core training-attention backward against SDPA, on one GPU.

    python3 scripts/attn_bwd_bench.py [LABEL=path/to/attn_bwd_wgmma.cuh ...]

Builds the kernel library from the checkout's sources and, for each
LABEL=HEADER given, from a copy of them in which `csrc/attn_bwd_wgmma.cuh`
is replaced by HEADER (another version of the two backward kernels, for an
A/B in one process; `scripts/attn_fwd_bench.py` builds the same way). Each
build's bf16 backward (the "wgmma" route) is first held to its plain
version on the plain forward's O and lse, at small shapes (D=64, ragged T,
padding, G = 1 and G = 8) and at the timed ones, to `chip_smoke.py`'s
bounds: 2e-2 of each of dQ/dK/dV's largest magnitude (max) and 1e-2 of its
mean magnitude (mean). Then every build is timed at s2-pro's shapes (H=32,
Hkv=8, D=128: B=2 T=1024 with row 1 right-padded by 100, B=1 T=4096, B=2
T=1000) with CUDA events, 20 back-to-back calls of the C entry point on
preallocated outputs (no Python wrapper, delta computed once), best of 3,
in turns (builds in order, then in reverse, the means averaged), beside
SDPA's forward+backward minus its forward on the same inputs: `is_causal`
where no key is padded, else the mask tensor, and `is_causal` too for the
padded batch. TFLOP/s count the minimal five products (S, dP, dV, dK, dQ)
of 2 D operations per visible pair and head, the bound `chip_smoke.py`
uses. One line per shape and build, each with the card's name and power
limit. The builds go to `build/attn_bwd_bench/`.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from attn_fwd_bench import _best_ms, _builds, _use  # noqa: E402

# (B, T, right padding of each row): timed
TIMED = [(2, 1024, [0, 100]), (1, 4096, [0]), (2, 1000, [0, 0])]
# (B, T, H, Hkv, D, padding): checked, not timed
SMALL = [(2, 100, 4, 2, 64, [0, 7]), (1, 130, 8, 2, 128, [3]),
         (2, 300, 4, 4, 128, [0, 20]), (1, 257, 16, 2, 64, [5]),
         (1, 600, 8, 1, 64, [0])]


def _inputs(b, t, h, hkv, d, pads, gen, dev):
    import torch

    q, k, v, do = (torch.randn((b, t, n, d), generator=gen, device=dev,
                               dtype=torch.bfloat16) for n in (h, hkv, hkv, h))
    kvalid = torch.ones((b, t), dtype=torch.int32, device=dev)
    for i, n in enumerate(pads):
        if n:
            kvalid[i, -n:] = 0
    do = do * kvalid[:, :, None, None].to(do.dtype)  # padded rows: zero
    return q, k, v, kvalid, do


def _check(q, k, v, kvalid, do):
    """True if the build in use agrees with the plain backward."""
    import torch

    from fish_speech_tpu_torch.ops import flash_train

    o, lse = flash_train.flash_train_forward_reference(q, k, v, kvalid)
    args = (q, k, v, kvalid, o, lse, do)
    got = flash_train.flash_train_backward(*args)
    want = flash_train.flash_train_backward_reference(*args)
    ok = True
    for g, w in zip(got, want):
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        ok &= bool(torch.isfinite(g.float()).all())
        ok &= (err.max().item() <= 2e-2 * ref.max().item()
               and err.mean().item() <= 1e-2 * ref.mean().item())
    return ok


def _launcher(lib, q, k, v, kvalid, do):
    """A call of the C entry point on preallocated outputs."""
    import torch

    from fish_speech_tpu_torch.ops import flash_train
    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES

    b, t, h, d = q.shape
    o, lse = flash_train.flash_train_forward_reference(q, k, v, kvalid)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = [torch.empty_like(x) for x in (q, k, v)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in grads), b, t, h, k.shape[2], d,
            DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)

    def call():
        if lib.fs_flash_train_bwd(*args) != 0:
            raise SystemExit("backward: launch failed")
    return call, (o, lse, delta, grads)


def _sdpa_bwd_ms(q, k, v, kvalid, do, causal):
    """SDPA forward+backward minus forward, best of 3 each."""
    import torch
    import torch.nn.functional as F

    t = q.shape[1]
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    i = torch.arange(t, device=q.device)
    mask = ((i[None, :] <= i[:, None])[None] & kvalid[:, None, :].bool())[:, None]
    kw = dict(is_causal=True) if causal else dict(attn_mask=mask)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)

    def fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **kw)
        return torch.autograd.grad(out, leaves, dot)

    return _best_ms(fwd_bwd, iters=20) - _best_ms(fwd, iters=20)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_bench: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    libs = {}
    builds = _builds(sys.argv[1:], "attn_bwd_wgmma.cuh", "attn_bwd_bench")
    for label, csrc in builds.items():
        libs[label] = _use(csrc)
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = SMALL + [(b, t, 32, 8, 128, pads) for b, t, pads in TIMED]
        for b, t, h, hkv, d, pads in cases:
            ok = _check(*_inputs(b, t, h, hkv, d, pads, gen, dev))
            print(f"{label}: backward B={b} T={t} H={h} Hkv={hkv} D={d} "
                  f"right_pad={pads}: agrees with the plain version: {ok}")
            if not ok:
                raise SystemExit(f"{label} disagrees with the plain version")
        torch.cuda.empty_cache()

    order = list(libs) + list(libs)[::-1]
    for b, t, pads in TIMED:
        gen = torch.Generator(device=dev).manual_seed(1)
        inputs = _inputs(b, t, 32, 8, 128, pads, gen, dev)
        calls = {label: _launcher(lib, *inputs) for label, lib in libs.items()}
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(_best_ms(calls[label][0], iters=20))
        sdpa = {"is_causal": _sdpa_bwd_ms(*inputs, causal=True)}
        if any(pads):
            sdpa["mask"] = _sdpa_bwd_ms(*inputs, causal=False)
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        flops = 10 * 32 * 128 * pairs
        nbytes = 2 * b * t * 128 * (4 * 32 + 4 * 8) + 4 * b * 32 * t + 4 * b * t
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        lib_text = ", ".join(f"SDPA {n} {ms:.4f} ms" for n, ms in sdpa.items())
        for label, ts in times.items():
            ms = sum(ts) / len(ts)
            print(f"{smi} | backward B={b} T={t} H=32 Hkv=8 D=128 right_pad={pads}: "
                  f"{label} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on five "
                  f"products; turns {', '.join(f'{x:.4f}' for x in ts)}); bound "
                  f"{bound:.4f} ms; {lib_text}")
        del inputs, calls


if __name__ == "__main__":
    main()
