#!/usr/bin/env python3
"""The fp32 int8 matvec and fused FFN against cuBLAS and an earlier
checkout's kernels, timed on the card.

    python3 scripts/int8_fp32_bench.py [OTHER_CHECKOUT] [--sweep]

Shapes: the fp32 int8 products of JAX's tiny model as `--tiny --int8`
serves it (`chip_smoke.py:INT8_TINY_SHAPES`: slow wqkv 64->128, wo 64->64,
w13 64->256, w2 128->64; fast wqkv 32->64, wo 32->32, w13 32->128, w2
64->32; the semantic head 64->4097 with rows 16 bytes apart; the fast head
32->4096) and its FFNs (`INT8_FFN_TINY`: slow (64, 128), fast (32, 64)),
at B = 1 and 4; then s2-pro's slow w13 (2560->19456) and slow FFN (2560,
9728) at B = 1, where the weight's bytes bound them (those two walk copies
of their weights over twice the L2, as `chip_smoke.py` does; the tiny
ones stay in L2, as the tiny model's weights all do). Each kernel is held
to its plain version (1e-5 of (|x| @ |q|) * s, or of max |y|) and timed in
device time (`chip_smoke.py:_device_ms`: 200 calls captured in one CUDA
graph, best of three replays), beside cuBLAS on the dequantized fp32
weights (`x @ W`, and for the FFN torch's silu * mul between), the plain
version and the bound (`chip_smoke.py:_bound`). Every line carries the
card's name and power limit; the last line is all the numbers as one JSON
object.

OTHER_CHECKOUT (`git archive REV | tar -x -C DIR`) adds `old`: its `csrc/`
built into `build/int8_fp32_bench/`, its `fs_int8_matmul` (route "gemv")
and `fs_int8_ffn` (route "cuda_cores") called with the plans its own
`ops/int8.py:int8_gemv_split` and `ops/int8_ffn.py:int8_ffn_plan` give
(its C entry points take the same arguments as this checkout's), timed in
turns with this checkout's kernels (old, new, new, old; the means of the
two).

`--sweep` times this checkout's kernels at s2-pro's two shapes over other
split targets (`FP32_BLOCKS_PER_SM` of the matvec, the FFN's items a
resident block): what the plans' constants are set by.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (INT8_FFN_TINY, INT8_FFN_WIDE, INT8_FP32_ROWS,  # noqa: E402
                        INT8_FP32_WIDE, INT8_TINY_SHAPES, L2_COLD_BYTES, PEAK_FP32,
                        _bound, _device_ms, _nvidia_smi, _time_ms)

ITERS = 200


def _other(tree):
    """Another checkout's kernel library and its int8 plan modules."""
    from fish_speech_tpu_torch.ops import _kernels

    here = _kernels.CSRC
    _kernels.CSRC = (Path(tree) / "fish_speech_tpu_torch" / "csrc").resolve()
    try:
        out = (ROOT / "build" / "int8_fp32_bench" / f"kernels-{_kernels.source_hash()}"
               / "libfs_kernels.so")
        if not out.exists():
            _kernels._build(out)
    finally:
        _kernels.CSRC = here
    lib = ctypes.CDLL(str(out))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_int8_matmul.argtypes = [p] * 6 + [i32] * 8 + [p]
    lib.fs_int8_matmul.restype = i32
    lib.fs_int8_ffn.argtypes = [p, p, p, i32, p, p, p, i32, p, p, p, p] + [i32] * 10 + [p]
    lib.fs_int8_ffn.restype = i32
    lib.fs_int8_ffn_blocks.argtypes = [i32, i32, p]
    lib.fs_int8_ffn_blocks.restype = i32
    mods = {}
    for name in ("int8", "int8_ffn"):
        path = Path(tree) / "fish_speech_tpu_torch" / "ops" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"other_{name}", path)
        mods[name] = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return lib, mods


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


class OldMatvec:
    """The other checkout's fp32 matvec on (x, q, s) with its own plan."""

    def __init__(self, lib, mods, x, q, s, n_sm):
        import torch

        b, i = x.shape
        o = q.shape[1]
        m = mods["int8"]
        self.n, self.run = m.int8_gemv_split("gemv", b, i, o, n_sm)
        cols = m.ROUTE_COLS["gemv"]
        self.work = torch.empty(max(1, self.n * b * o), dtype=torch.float32, device=x.device)
        self.counters = torch.zeros(-(-o // cols), dtype=torch.int32, device=x.device)
        self.lib, self.shape = lib, (b, i, o)

    def __call__(self, x, q, s, out):
        b, i, o = self.shape
        rc = self.lib.fs_int8_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                     out.data_ptr(), self.work.data_ptr(),
                                     self.counters.data_ptr(), b, i, o, q.stride(0), 0,
                                     1, self.n, self.run, _stream())
        if rc:
            raise SystemExit(f"the other checkout's fp32 matvec failed: CUDA error {rc}")
        return out


class OldFfn:
    """The other checkout's fp32 fused FFN with its own plan."""

    def __init__(self, lib, mods, x, w13, w2):
        import torch

        b, d = x.shape
        i = w2["q"].shape[0]
        n = ctypes.c_int()
        rc = lib.fs_int8_ffn_blocks(1, b, ctypes.byref(n))
        if rc:
            raise SystemExit(f"the other checkout's occupancy query failed: {rc}")
        m = mods["int8_ffn"]
        self.plan = m.int8_ffn_plan("cuda_cores", b, d, i, n.value)
        self.work = torch.empty(m.workspace_floats(self.plan, b, d, i, torch.float32) + 4,
                                dtype=torch.float32, device=x.device)
        self.bar = torch.zeros(1, dtype=torch.int32, device=x.device)
        self.lib, self.shape = lib, (b, d, i)

    def __call__(self, x, w13, w2, out):
        b, d, i = self.shape
        q, s = w13["q"], w13["s"]
        p = self.plan
        rc = self.lib.fs_int8_ffn(
            x.data_ptr(), q.data_ptr(), q[:, i:].data_ptr(), q.stride(0), s.data_ptr(),
            s[i:].data_ptr(), w2["q"].data_ptr(), d, w2["s"].data_ptr(), out.data_ptr(),
            self.work.data_ptr(), self.bar.data_ptr(), b, d, i, 0, 1, p.n_a, p.run_a,
            p.n_b, p.run_b, p.grid, _stream())
        if rc:
            raise SystemExit(f"the other checkout's fp32 FFN failed: CUDA error {rc}")
        return out


def _in_turns(fns):
    """Device ms of each of `fns` ({name: fn}), in turns: in order, then in
    reverse, the two means averaged."""
    order = list(fns)
    ms = {k: [] for k in order}
    for names in (order, order[::-1]):
        for k in names:
            ms[k].append(_device_ms(fns[k], ITERS))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _copies(n, make):
    return [make() for _ in range(n)]


def matvec_rows(dev, old, smi):
    import torch

    from fish_speech_tpu_torch.models.dual_ar import _rows_16_bytes_apart
    from fish_speech_tpu_torch.ops._kernels import sm_count
    from fish_speech_tpu_torch.ops.int8 import int8_matmul, int8_matmul_reference
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    cases = [(n, i, o, b) for n, i, o in INT8_TINY_SHAPES for b in INT8_FP32_ROWS]
    for name, i, o, b in cases + [(*INT8_FP32_WIDE, 1)]:
        qw = quantize_int8(torch.randn(i, o, generator=gen, device=dev) * 0.02)
        q, s = _rows_16_bytes_apart(qw["q"]), qw["s"]
        x = torch.randn(b, i, generator=gen, device=dev)
        w = q.float() * s
        wide = i * o > L2_COLD_BYTES // 4
        n_q = -(-L2_COLD_BYTES // (i * q.stride(0))) if wide else 1
        n_w = -(-L2_COLD_BYTES // (4 * i * o)) if wide else 1
        qs = [(q, s)] + _copies(n_q - 1, lambda: (_rows_16_bytes_apart(q.contiguous()),
                                                  s.clone()))
        ws = [w] + _copies(n_w - 1, w.clone)
        exact = x @ w
        scale = x.abs() @ w.abs()
        got = int8_matmul(x, q, s)
        assert bool(((got - exact).abs() <= 1e-5 * scale + 1e-6).all()), name
        fns = {"new": lambda k=0: int8_matmul(x, *qs[k % n_q]),
               "cublas": lambda k=0: x @ ws[k % n_w]}
        plan = {}
        if old is not None:
            call = OldMatvec(*old, x, q, s, sm_count(dev))
            outs = [torch.empty_like(got) for _ in range(n_q)]
            back = call(x, q, s, outs[0])
            assert bool(((back - exact).abs() <= 1e-5 * scale + 1e-6).all()), name
            fns["old"] = lambda k=0: call(x, *qs[k % n_q], outs[k % n_q])
            plan["old_plan"] = [call.n, call.run]
        ms = _in_turns(fns)
        plain_ms = _time_ms(lambda k=0: int8_matmul_reference(x, q, s), ITERS)
        bound = _bound(2 * b * i * o, i * o + 4 * o + 4 * b * (i + o), PEAK_FP32)
        rows.append(dict(kernel="int8_gemv_fp32", shape=f"{name} B={b} I={i} O={o}",
                         ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], weight_copies=[n_q, n_w], **plan))
        print(_line(rows[-1], smi))
        del q, s, qs, ws, w, x
        torch.cuda.empty_cache()
    return rows


def ffn_rows(dev, old, smi):
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn, int8_ffn_reference
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    cases = [(n, d, i, b) for n, d, i in INT8_FFN_TINY for b in INT8_FP32_ROWS]
    for name, d, i, b in cases + [(*INT8_FFN_WIDE, 1)]:
        w1, w3, w2 = (quantize_int8(torch.randn(*sh, generator=gen, device=dev) * 0.02)
                      for sh in ((d, i), (d, i), (i, d)))
        w13 = {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}
        x = torch.randn(b, d, generator=gen, device=dev)
        nbytes = 3 * d * i + 4 * (2 * i + d)
        wide = nbytes > L2_COLD_BYTES // 4
        n_w = -(-L2_COLD_BYTES // nbytes) if wide else 1
        n_lib = -(-L2_COLD_BYTES // (12 * d * i)) if wide else 1
        ws = [(w13, w2)] + _copies(n_w - 1, lambda: (
            {k: v.clone() for k, v in w13.items()}, {k: v.clone() for k, v in w2.items()}))
        lib13, lib2 = w13["q"].float() * w13["s"], w2["q"].float() * w2["s"]
        libs = [(lib13, lib2)] + _copies(n_lib - 1, lambda: (lib13.clone(), lib2.clone()))
        want = int8_ffn_reference(x, w13, w2)
        top = want.abs().max().item()
        got = int8_ffn(x, w13, w2)
        assert (got - want).abs().max().item() <= 1e-5 * top, name

        def cublas(k=0):
            a, c = libs[k % n_lib]
            u = x @ a
            return (F.silu(u[:, :i]) * u[:, i:]) @ c

        fns = {"new": lambda k=0: int8_ffn(x, *ws[k % n_w]), "cublas": cublas}
        plan = {}
        if old is not None:
            call = OldFfn(*old, x, w13, w2)
            outs = [torch.empty_like(got) for _ in range(n_w)]
            back = call(x, w13, w2, outs[0])
            assert (back - want).abs().max().item() <= 1e-5 * top, name
            fns["old"] = lambda k=0: call(x, *ws[k % n_w], outs[k % n_w])
            plan["old_plan"] = list(call.plan.__dict__.values())
        ms = _in_turns(fns)
        plain_ms = _time_ms(lambda k=0: int8_ffn_reference(x, w13, w2), ITERS)
        bound = _bound(6 * b * d * i, nbytes + 8 * b * d, PEAK_FP32)
        rows.append(dict(kernel="int8_ffn_fp32", shape=f"{name} B={b} D={d} I={i}",
                         ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], weight_copies=[n_w, n_lib], **plan))
        print(_line(rows[-1], smi))
        del w1, w3, w2, w13, ws, libs, lib13, lib2, x
        torch.cuda.empty_cache()
    return rows


def sweep_rows(dev, smi):
    """This checkout's kernels at s2-pro's two shapes with other split
    targets, through the C entry points."""
    import torch

    from fish_speech_tpu_torch.ops import int8 as tint8
    from fish_speech_tpu_torch.ops import int8_ffn as tffn
    from fish_speech_tpu_torch.ops._kernels import load_kernels, sm_count, stream_ptr
    from fish_speech_tpu_torch.ops.quant import quantize_int8

    lib, n_sm = load_kernels(), sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    rows = []
    _, i, o = INT8_FP32_WIDE
    qw = quantize_int8(torch.randn(i, o, generator=gen, device=dev) * 0.02)
    q, s = qw["q"], qw["s"]
    x = torch.randn(1, i, generator=gen, device=dev)
    n_q = -(-L2_COLD_BYTES // (i * o))
    qs = [q] + [q.clone() for _ in range(n_q - 1)]
    out = torch.empty(1, o, device=dev)
    for per_sm in (1, 2, 3, 4, 8):
        n, run = tint8.fp32_split(-(-o // 128), i, 1, per_sm * n_sm)
        work = torch.empty(n * o, device=dev)
        counters = torch.zeros(-(-o // 128), dtype=torch.int32, device=dev)

        def call(k=0, n=n, run=run, work=work, counters=counters):
            rc = lib.fs_int8_matmul(x.data_ptr(), qs[k % n_q].data_ptr(), s.data_ptr(),
                                    out.data_ptr(), work.data_ptr(), counters.data_ptr(),
                                    1, i, o, o, 0, 1, n, run, stream_ptr(x))
            if rc:
                raise SystemExit(f"sweep: CUDA error {rc}")
            return out

        rows.append(dict(kernel="int8_gemv_fp32", shape=f"slow w13 B=1 per_sm={per_sm}",
                         plan=[n, run], ms=_device_ms(call, ITERS)))
        print(f"sweep {rows[-1]} [{smi}]")
    del qs
    _, d, i = INT8_FFN_WIDE
    w1, w3, w2 = (quantize_int8(torch.randn(*sh, generator=gen, device=dev) * 0.02)
                  for sh in ((d, i), (d, i), (i, d)))
    w13 = {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}
    xf = torch.randn(1, d, generator=gen, device=dev)
    blocks = tffn.resident_blocks("cuda_cores", 1, dev)
    y = torch.empty(1, d, device=dev)
    cols_a, cols_b = tffn.ITEM_COLS["cuda_cores"]
    tiles_a, tiles_b = -(-i // cols_a), -(-d // cols_b)
    for div in (1, 2, 4, 8):
        want = max(1, blocks // div)
        n_a, run_a = tint8.fp32_split(tiles_a, d, 1, want)
        n_b, run_b = tint8.fp32_split(tiles_b, i, 1, want)
        plan = tffn.FfnPlan(tiles_a, n_a, run_a, tiles_b, n_b, run_b,
                            min(blocks, max(tiles_a * n_a, tiles_b * n_b)))
        work = torch.empty(tffn.workspace_floats(plan, 1, d, i, torch.float32), device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)

        def call(k=0, p=plan, work=work, bar=bar):
            rc = lib.fs_int8_ffn(
                xf.data_ptr(), w13["q"].data_ptr(), w13["q"][:, i:].data_ptr(), 2 * i,
                w13["s"].data_ptr(), w13["s"][i:].data_ptr(), w2["q"].data_ptr(), d,
                w2["s"].data_ptr(), y.data_ptr(), work.data_ptr(), bar.data_ptr(), 1, d, i,
                0, 1, p.n_a, p.run_a, p.n_b, p.run_b, p.grid, stream_ptr(xf))
            if rc:
                raise SystemExit(f"sweep: CUDA error {rc}")
            return y

        rows.append(dict(kernel="int8_ffn_fp32", shape=f"slow FFN B=1 items={want}",
                         plan=[n_a, run_a, n_b, run_b, plan.grid],
                         ms=_device_ms(call, ITERS)))
        print(f"sweep {rows[-1]} [{smi}]")
    return rows


def _line(r, smi):
    ms = r["ms"]
    parts = " ".join(f"{k}_device_ms={v:.5f}" for k, v in ms.items())
    ratio = f" new/cublas={ms['new'] / ms['cublas']:.2f}"
    if "old" in ms:
        ratio += f" old/new={ms['old'] / ms['new']:.2f}"
    return (f"{r['kernel']} [{r['shape']}]: {parts}{ratio} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"new/bound={ms['new'] / r['bound_ms']:.2f} [{smi}]")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_fp32_bench: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = _nvidia_smi()
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    old = _other(args[0]) if args else None
    rows = matvec_rows(dev, old, smi) + ffn_rows(dev, old, smi)
    if "--sweep" in sys.argv[1:]:
        rows += sweep_rows(dev, smi)
    print(json.dumps({"card": smi, "other": args[0] if args else None, "rows": rows}))


if __name__ == "__main__":
    main()
