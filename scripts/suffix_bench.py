#!/usr/bin/env python3
"""The prefix-cache suffix attention against SDPA and an earlier checkout,
timed on the card.

    python3 scripts/suffix_bench.py [OTHER_CHECKOUT]

Shapes: `chip_smoke.py`'s suffix cases, the serving cache (S = 2048 + 128,
H = 32, Hkv = 8, D = 128) at start 951, Ts 64 and 128 at one row and Ts 64
at 4 and 16 rows, 8 layers (each timed call reads the next), over a cache
of q's dtype and an int8 cache; bf16 q at every shape, fp16 q at Ts 64 and
one row. Each kernel is held to `flash_suffix_reference` (chip_smoke's
bounds: 2e-2 max, 2e-3 mean abs) and timed in device time
(`chip_smoke.py:_device_ms`: 20 calls captured in one CUDA graph, best of
three replays), in turns (in order, then in reverse; the two means
averaged), beside SDPA with the suffix's mask over keys [0, start + Ts)
(over the dequantized cache for int8) and the least time the card could
take (`chip_smoke.py`'s suffix bound). Every line carries the card's name
and power limit.

OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`) adds `old`: its
`csrc/` built into `build/suffix_bench/` and its `fs_flash_suffix` called
with the signature it had before the split over keys (q, k, v, ks, vs,
start, out, B, Ts, H, Hkv, D, S, dtype, kv8, scale, stream).

Then a sweep of the kernel's plans at each case (this checkout's C entry
called with each plan: 64 or 128 rows a block, Z slices of the S keys),
device ms each, beside the plan `suffix_plan` picks: what the plan's rule
is tuned by.
"""

from __future__ import annotations

import ctypes
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (SUFFIX_CASES, SUFFIX_S, SUFFIX_START,  # noqa: E402
                        _bound, _device_ms, _nvidia_smi, _suffix_cache)

N_LAYER, H, HKV, D = 8, 32, 8, 128
ITERS = 20


def _old_lib(tree):
    """Another checkout's kernel library, its suffix entry bound with the
    signature it had before the split over keys."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = (ROOT / "build" / "suffix_bench" / f"kernels-{_kernels.source_hash()}"
               / "libfs_kernels.so")
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_flash_suffix.argtypes = [p] * 7 + [i32] * 8 + [ctypes.c_float, p]
    lib.fs_flash_suffix.restype = i32
    return lib


def _old_call(lib, q, cache, layer, st, out):
    """The old kernel on one layer, into `out`."""
    import torch

    kv8 = "ks" in cache
    b, ts, h, d = q.shape
    s, hkv = cache["k"].shape[2], cache["k"].shape[3]
    kv_layer = b * s * hkv * d * cache["k"].element_size()
    sc_layer = b * s * hkv * 2
    code = {torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    rc = lib.fs_flash_suffix(
        q.data_ptr(), cache["k"].data_ptr() + layer * kv_layer,
        cache["v"].data_ptr() + layer * kv_layer,
        cache["ks"].data_ptr() + layer * sc_layer if kv8 else 0,
        cache["vs"].data_ptr() + layer * sc_layer if kv8 else 0, st.data_ptr(),
        out.data_ptr(), b, ts, h, hkv, d, s, code, int(kv8), 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"the other checkout's suffix kernel failed: CUDA error {rc}")
    return out


SWEEP_Z = (1, 2, 3, 4, 5, 6, 9, 12, 16)


def _plan_call(lib, q, cache, layer, st, out, plan, work, counters):
    """This checkout's kernel on one layer with an explicit plan (rows a
    block, Z, tiles a slice), into `out`."""
    import torch

    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES

    kv8 = "ks" in cache
    b, ts, h, d = q.shape
    s, hkv = cache["k"].shape[2], cache["k"].shape[3]
    kv_layer = b * s * hkv * d * cache["k"].element_size()
    sc_layer = b * s * hkv * 2
    rc = lib.fs_flash_suffix(
        q.data_ptr(), cache["k"].data_ptr() + layer * kv_layer,
        cache["v"].data_ptr() + layer * kv_layer,
        cache["ks"].data_ptr() + layer * sc_layer if kv8 else 0,
        cache["vs"].data_ptr() + layer * sc_layer if kv8 else 0, st.data_ptr(),
        out.data_ptr(), work.data_ptr(), counters.data_ptr(), b, ts, h, hkv, d, s,
        DTYPE_CODES[q.dtype], int(kv8), *plan, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"plan {plan} failed: CUDA error {rc}")
    return out


def _sweep(lib, q, cache, st, want):
    """Device ms of every plan at this case: ({plan: ms}, the fastest)."""
    import torch

    from fish_speech_tpu_torch.ops.flash_prefill import SUFFIX_KEYS, suffix_row_tiles

    b, ts, h, d = q.shape
    s, hkv = cache["k"].shape[2], cache["k"].shape[3]
    tiles = -(-s // SUFFIX_KEYS)
    plans = set()
    for rows in (64, 128):
        for z in SWEEP_Z:
            per = -(-tiles // z)
            plans.add((rows, -(-tiles // per), per))
    out = {}
    for plan in sorted(plans):
        n = b * hkv * suffix_row_tiles(ts, h // hkv, plan[0])
        work = torch.empty(max(1, plan[1] * n * plan[0] * (2 + d)),
                           dtype=torch.float32, device=q.device)
        counters = torch.zeros(n, dtype=torch.int32, device=q.device)
        outs = [torch.empty_like(q) for _ in range(N_LAYER)]
        _errors(f"plan {plan}", _plan_call(lib, q, cache, 1, st, outs[1], plan, work,
                                           counters), want)
        out[plan] = _device_ms(lambda i=0: _plan_call(lib, q, cache, i % N_LAYER, st,
                                                      outs[i % N_LAYER], plan, work,
                                                      counters), ITERS)
    best = min(out, key=out.get)
    return out, best


def _errors(name, got, want):
    err = (got.float() - want.float()).abs()
    if err.max().item() > 2e-2 or err.mean().item() > 2e-3:
        raise SystemExit(f"{name} disagrees with the plain version: max abs "
                         f"{err.max().item():.3e}")
    return err.max().item(), err.mean().item()


def main():
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant
    from fish_speech_tpu_torch.ops._kernels import load_kernels, sm_count
    from fish_speech_tpu_torch.ops.flash_prefill import (flash_suffix_attention,
                                                         flash_suffix_reference,
                                                         suffix_plan)

    if not torch.cuda.is_available():
        raise SystemExit("suffix_bench: CUDA is not available")
    dev = torch.device("cuda:0")
    smi = _nvidia_smi()
    old = _old_lib(sys.argv[1]) if len(sys.argv) > 1 else None
    gen = torch.Generator(device=dev).manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    cases = [(b, ts, torch.bfloat16) for b, ts in SUFFIX_CASES] + [(1, 64, torch.float16)]
    st = torch.tensor([SUFFIX_START], dtype=torch.int32, device=dev)
    for b, ts, dtype in cases:
        for kv8 in (False, True):
            cache = _suffix_cache(dev, randn, N_LAYER, b, SUFFIX_S, HKV, D, kv8, dtype)
            q = randn(b, ts, H, D).to(dtype)
            want = flash_suffix_reference(q, cache, 1, st)
            errs = {"new": _errors("new", flash_suffix_attention(q, cache, 1, st), want)}
            fns = {"new": lambda i=0: flash_suffix_attention(q, cache, i % N_LAYER, st)}
            if old is not None:
                outs = [torch.empty_like(q) for _ in range(N_LAYER)]
                errs["old"] = _errors("old", _old_call(old, q, cache, 1, st, outs[1]), want)
                fns["old"] = lambda i=0: _old_call(old, q, cache, i % N_LAYER, st,
                                                   outs[i % N_LAYER])
            kv = SUFFIX_START + ts
            i_, j_ = torch.arange(ts, device=dev), torch.arange(kv, device=dev)
            mask = (j_[None, :] <= SUFFIX_START + i_[:, None])[None, None]
            if kv8:
                kl = [_kv_dequant(cache["k"][i, :, :kv], cache["ks"][i, :, :kv], dtype
                                  ).transpose(1, 2) for i in range(N_LAYER)]
                vl = [_kv_dequant(cache["v"][i, :, :kv], cache["vs"][i, :, :kv], dtype
                                  ).transpose(1, 2) for i in range(N_LAYER)]
            else:
                kl = [cache["k"][i, :, :kv].transpose(1, 2) for i in range(N_LAYER)]
                vl = [cache["v"][i, :, :kv].transpose(1, 2) for i in range(N_LAYER)]
            qt = q.transpose(1, 2)
            fns["sdpa"] = lambda i=0: F.scaled_dot_product_attention(
                qt, kl[i % N_LAYER], vl[i % N_LAYER], attn_mask=mask, enable_gqa=True)
            got = {name: [] for name in fns}
            for names in (list(fns), list(fns)[::-1]):
                for name in names:
                    got[name].append(_device_ms(fns[name], ITERS))
            ms = {name: sum(v) / len(v) for name, v in got.items()}
            pairs = b * (ts * SUFFIX_START + ts * (ts + 1) // 2)
            nbytes = (2 * q.numel() * 2 + b * kv * HKV * D * (1 if kv8 else 2) * 2
                      + (b * kv * HKV * 2 * 2 if kv8 else 0))
            bound = _bound(4 * D * H * pairs, nbytes)
            plan = suffix_plan(SUFFIX_S, HKV, b, ts, H // HKV, sm_count(dev))
            label = (f"suffix B={b} Ts={ts} {str(dtype)[6:]} q, "
                     f"{'int8' if kv8 else str(dtype)[6:]} cache (L={N_LAYER} S={SUFFIX_S} "
                     f"start={SUFFIX_START}")
            print(f"{label}; plan {plan[0]} rows, {plan[1]} x {plan[2]} tiles): dev ms "
                  + " ".join(f"{n}={v:.4f}" for n, v in ms.items())
                  + f" bound={bound[0]:.4f} ({bound[1]}) share of bound "
                  + " ".join(f"{n}={bound[0] / ms[n]:.3f}" for n in ms if n != "sdpa")
                  + " errors " + " ".join(f"{n}={e[0]:.3e}/{e[1]:.3e}"
                                          for n, e in errs.items())
                  + f"; {smi}", flush=True)
            swept, best = _sweep(load_kernels(), q, cache, st, want)
            print(f"{label}) plan sweep, dev ms (rows, Z, tiles a slice): "
                  + " ".join(f"{p}={ms:.4f}" for p, ms in swept.items())
                  + f"; best {best} {swept[best]:.4f}, the plan {tuple(plan)} "
                  f"{swept.get(tuple(plan), float('nan')):.4f}; {smi}", flush=True)
            del cache, kl, vl


if __name__ == "__main__":
    main()
