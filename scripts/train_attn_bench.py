#!/usr/bin/env python3
"""The training attention's TF32 routes ("fp32_tc" and "bf16_tf32":
`attn_tf32_kernel` in its training mode, `train_bwd_tf32_kernel`) against
another checkout's kernels for the same routes, SDPA and their plain
versions, timed on the card.

    python3 scripts/train_attn_bench.py [OTHER_CHECKOUT]

Shapes: `chip_smoke.py` phase 2's four training rows on these routes (fp32
at JAX's tiny heads B=2 T=200 H=2 Hkv=1 D=32 with a row padded 37, at
s2-pro's heads B=2 T=256 H=32 Hkv=8 D=128 padded 30 and B=1 T=12 (the
parity tool's teacher-forced prompt); bf16 at the tiny heads B=2 T=256
padded 40, the train CLI's batch), then fp32 at H=4 Hkv=2 D=64 (B=1
T=256) and at the fine-tune shape B=2 T=1024 H=32 Hkv=8 D=128 padded 100.
Inputs are N(0, 1) in the route's dtype, dO zero on padded rows.

Each kernel is held to its plain version (fp32: O and lse to 1e-4, the
gradients to 1e-4 of each one's largest magnitude; bf16: the bounds of
`chip_smoke.py`'s bf16 cases) and timed in device time
(`chip_smoke.py:_device_ms`: the calls captured in one CUDA graph, best of
three replays) in turns with the other checkout's kernel (in order, then
in reverse; the means of the two). The forward is timed through the
wrapper (`flash_train_forward`) and the other checkout's C entry point on
the same output buffers; the backward through both C entry points on one
delta = rowsum(dO * O) computed beforehand (the new one with its plan and
workspace), and through the wrapper (`wrapper_ms`: with the delta's four
torch kernels). Beside them: CUDA-event times (`ms`), the plain version's,
SDPA's (the causal key-valid mask, and `is_causal`; the backward as
forward + backward minus forward) and the bound: the TF32 products the
kernels issue at 495 TFLOP/s (3 a product) or the bytes for fp32
(`chip_smoke.py:_tf32_bound`, with the 67 TFLOP/s fp32 bound beside it),
bf16's peak for bf16. Every line carries the card's name and power limit;
the last line is all the numbers as one JSON object, which is also written
to `chiprun_out/train_attn_bench.json`.

OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`) adds `old`: its
`csrc/` built into `build/train_attn_bench/`, its `fs_flash_train_fwd` and
its `fs_flash_train_bwd`: with this checkout's plan and workspace where
its `ops/flash_train.py` has `train_bwd_plan` (a copy of this tree with a
kernel changed times a design option), else the C signature before the
plan (q, k, v, kvalid, dO, lse, delta, dQ, dK, dV, B, T, H, Hkv, D, dtype,
scale, stream).
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (PEAK_FP32, _bound, _device_ms, _library_ms,  # noqa: E402
                        _nvidia_smi, _sdpa, _tf32_bound, _time_ms)

# (B, T, H, Hkv, D, right pads, dtype)
SHAPES = [(2, 200, 2, 1, 32, [0, 37], "float32"),
          (2, 256, 32, 8, 128, [0, 30], "float32"),
          (1, 12, 32, 8, 128, [0], "float32"),
          (2, 256, 2, 1, 32, [0, 40], "bfloat16"),
          (1, 256, 4, 2, 64, [0], "float32"),
          (2, 1024, 32, 8, 128, [0, 100], "float32")]


def _other(tree):
    """Another checkout's kernel library, its training entry points bound."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = (ROOT / "build" / "train_attn_bench" / f"kernels-{_kernels.source_hash()}"
               / "libfs_kernels.so")
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.planned = "train_bwd_plan" in (
        Path(tree) / "fish_speech_tpu_torch" / "ops" / "flash_train.py").read_text()
    lib.fs_flash_train_fwd.argtypes = [p] * 6 + [i32] * 6 + [f32, p]
    lib.fs_flash_train_fwd.restype = i32
    lib.fs_flash_train_bwd.argtypes = (
        [p] * 12 + [i32] * 8 + [f32, p] if lib.planned else [p] * 10 + [i32] * 6 + [f32, p])
    lib.fs_flash_train_bwd.restype = i32
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


def _grad_errors(got, want, fp32):
    """(max abs error, ok) of dQ, dK, dV against the plain version."""
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        ref = w.float().abs()
        worst = max(worst, err.max().item())
        ok &= bool(g.float().isfinite().all())
        if fp32:
            ok &= err.max().item() <= 1e-4 * max(1.0, ref.max().item())
        else:
            ok &= err.max().item() <= 2e-2 * ref.max().item() and \
                err.mean().item() <= 1e-2 * ref.mean().item()
    return worst, ok


def rows(dev, old, smi):
    import torch

    from fish_speech_tpu_torch.ops import flash_train as ft
    from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, load_kernels, scratch,
                                                    sm_count)

    lib = load_kernels()
    gen = torch.Generator(device=dev).manual_seed(25)
    out_rows = []
    for b, t, h, hkv, d, pads, dtype_name in SHAPES:
        dtype = getattr(torch, dtype_name)
        fp32 = dtype == torch.float32
        q, k, v = (torch.randn(b, t, n, d, generator=gen, device=dev).to(dtype)
                   for n in (h, hkv, hkv))
        kvalid = torch.ones(b, t, dtype=torch.int32, device=dev)
        for i, n in enumerate(pads):
            if n:
                kvalid[i, -n:] = 0
        do = (torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
              * kvalid[:, :, None, None].to(dtype))
        scale = 1.0 / math.sqrt(d)
        code = DTYPE_CODES[dtype]
        shape = (f"B={b} T={t} H={h} Hkv={hkv} D={d} right_pad={pads} {dtype_name} "
                 f"{ft._route(dtype, d)}")
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        io = q.element_size() * b * t * d * (h + hkv)
        fwd_bytes = 2 * io + 4 * b * h * t
        bwd_bytes = q.element_size() * b * t * d * (4 * h + 4 * hkv) + 4 * b * h * t + 4 * b * t
        i_ = torch.arange(t, device=dev)
        mask = ((i_[None, :] <= i_[:, None])[None] & kvalid[:, None, :].bool())[:, None]
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

        # forward
        want_o, want_lse = ft.flash_train_forward_reference(q, k, v, kvalid)
        o, lse = ft.flash_train_forward(q, k, v, kvalid)
        err = max((o.float() - want_o.float()).abs().max().item(),
                  (lse - want_lse).abs().max().item())
        fns = {"new": lambda i=0: ft.flash_train_forward(q, k, v, kvalid)}
        if old is not None:
            oo, ol = torch.empty_like(q), torch.empty_like(lse)

            def old_fwd(i=0):
                _check(old.fs_flash_train_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(),
                    oo.data_ptr(), ol.data_ptr(), b, t, h, hkv, d, code, scale,
                    _stream()), "old forward")
                return oo

            old_fwd()
            old_err = (oo.float() - want_o.float()).abs().max().item()
            fns["old"] = old_fwd
        dms = _in_turns(fns, 20)
        flops = 4 * h * d * pairs
        bound = _tf32_bound(flops, fwd_bytes, 3) if fp32 else _bound(flops, fwd_bytes)
        row = dict(kernel="forward", shape=shape, device_ms=dms,
                   ms=_time_ms(fns["new"], 20),
                   plain_ms=_time_ms(lambda i=0: ft.flash_train_forward_reference(
                       q, k, v, kvalid), 5),
                   sdpa_mask_ms=_library_ms(lambda i=0: _sdpa(qt, kt, vt, mask, False), 20),
                   sdpa_mask_device_ms=_device_ms(
                       lambda i=0: _sdpa(qt, kt, vt, mask, False), 20),
                   sdpa_causal_ms=_library_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 20),
                   bound_ms=bound[0], bound_by=bound[1],
                   fp32_bound_ms=_bound(flops, fwd_bytes, PEAK_FP32)[0],
                   max_abs_err=err, tflop_s=flops / dms["new"] / 1e9)
        if old is not None:
            row["old_max_abs_err"] = old_err
        out_rows.append(row)
        print(_line(row, smi), flush=True)

        # backward, on the plain forward's O and lse
        args = (q, k, v, kvalid, want_o, want_lse, do)
        want = ft.flash_train_backward_reference(*args)
        got = ft.flash_train_backward(*args)
        err, ok = _grad_errors(got, want, fp32)
        delta = (do.float() * want_o.float()).sum(-1).transpose(1, 2).contiguous()
        n_split, per = ft.train_bwd_plan(b, t, h, hkv, d, sm_count(dev))
        work = counters = None
        if n_split > 1:
            tiles = -(-t // ft.BWD_KEYS) * hkv * b
            w, c = scratch("flash_train_bwd", dev, tiles * n_split * 2 * ft.BWD_KEYS * d,
                           tiles)
            work, counters = w.data_ptr(), c.data_ptr()
        grads = [torch.empty_like(x) for x in (q, k, v)]

        def new_bwd(i=0):
            _check(lib.fs_flash_train_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(), do.data_ptr(),
                want_lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in grads),
                work, counters, n_split, per, b, t, h, hkv, d, code, scale, _stream()),
                "new backward")
            return grads

        fns = {"new": new_bwd}
        if old is not None:
            old_grads = [torch.empty_like(x) for x in (q, k, v)]

            plan = (work, counters, n_split, per) if old.planned else ()

            def old_bwd(i=0):
                _check(old.fs_flash_train_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(),
                    do.data_ptr(), want_lse.data_ptr(), delta.data_ptr(),
                    *(x.data_ptr() for x in old_grads), *plan, b, t, h, hkv, d, code,
                    scale, _stream()), "old backward")
                return old_grads

            old_err = _grad_errors(old_bwd(), want, fp32)[0]
            fns["old"] = old_bwd
        dms = _in_turns(fns, 10)
        flops = 10 * h * d * pairs
        bound = _tf32_bound(flops, bwd_bytes, 3) if fp32 else _bound(flops, bwd_bytes)

        def sdpa_fwd_bwd(i=0, causal=False):
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            out = _sdpa(*leaves, mask, causal)
            return torch.autograd.grad(out, leaves, dot)

        row = dict(kernel="backward", shape=shape + f" plan Z={n_split} per={per}",
                   device_ms=dms, ms=_time_ms(fns["new"], 10),
                   wrapper_ms=_time_ms(lambda i=0: ft.flash_train_backward(*args), 10),
                   wrapper_device_ms=_device_ms(lambda i=0: ft.flash_train_backward(*args), 10),
                   plain_ms=_time_ms(lambda i=0: ft.flash_train_backward_reference(*args), 5),
                   sdpa_mask_ms=_library_ms(sdpa_fwd_bwd, 10) - _library_ms(
                       lambda i=0: _sdpa(qt, kt, vt, mask, False), 10),
                   sdpa_causal_ms=_library_ms(lambda i=0: sdpa_fwd_bwd(causal=True), 10)
                   - _library_ms(lambda i=0: _sdpa(qt, kt, vt, None, True), 10),
                   bound_ms=bound[0], bound_by=bound[1],
                   fp32_bound_ms=_bound(flops, bwd_bytes, PEAK_FP32)[0],
                   max_abs_err=err, ok=ok, tflop_s=flops / dms["new"] / 1e9)
        if old is not None:
            row["old_max_abs_err"] = old_err
        out_rows.append(row)
        print(_line(row, smi), flush=True)
        if not ok:
            raise SystemExit(f"backward {shape}: beyond its bounds ({err})")
        del q, k, v, do, o, lse, want_o, want_lse, got, want, args, grads
        torch.cuda.empty_cache()
    return out_rows


def _line(row, smi):
    ms = " ".join(f"{k}={v:.5f}" for k, v in row["device_ms"].items())
    ratio = ""
    if "old" in row["device_ms"]:
        ratio = f" old/new={row['device_ms']['old'] / row['device_ms']['new']:.2f}"
    rest = " ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()
                    if k not in ("kernel", "shape", "device_ms"))
    return f"{smi} | train {row['kernel']} [{row['shape']}]: dev {ms}{ratio}; {rest}"


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_attn_bench: CUDA is not available")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    old = _other(args[0]) if args else None
    result = {"card": smi, "tf32": "off (torch.backends.cuda.matmul.allow_tf32 = False)",
              "rows": rows(dev, old, smi)}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_attn_bench.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
