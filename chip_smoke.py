#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`fish_speech_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions,
   and the build of the CUDA kernels from `fish_speech_tpu_torch/csrc/`;
2. each kernel against its plain PyTorch version at the main paths' shapes,
   in bf16 from N(0,1) inputs (pass: max abs error <= 2e-2, mean <= 2e-3,
   the bound of bf16 rounding of P before P.V in the plain version; the
   training forward's O also gets one bf16 step of the value, 2^-7 |O|;
   the training backward's dQ/dK/dV, 2e-2 of the tensor's largest
   magnitude and 1e-2 of its mean magnitude), timed with CUDA events in
   turns (plain, kernel, kernel, plain). The training kernels run at B=2
   T=1024 with a right-padded row, B=1 T=4096 and a ragged B=2 T=1000.
   The int4 matmul runs at s2-pro's eight decode shapes (B=1) and two
   prefill shapes (B=1024), held to one bf16 rounding of W and y, 2^-8
   (|x| @ |W| + |y|) elementwise; the int8-KV decode kernel at the slow
   cache (S = 2048 + 64) to kernel 2's bounds. Each case also reports its
   bound (the larger of its bytes over 3.35 TB/s and its operations over
   989 TFLOP/s, H100 SXM) and, where one PyTorch call computes the same
   function, that call's time (SDPA; cuBLAS on the dequantized weight);
3. a small-input reference: a tiny fp32 model runs the same greedy request
   through the kernels on the card and through the plain versions on the
   CPU; token columns must be identical and prefill logits within 1e-4;
3b. a small training reference: a tiny fp32 LoRA model takes two
   `make_train_step` steps through the training kernels on the card and the
   plain versions on the CPU; losses and LoRA leaves must agree to 1e-5;
3c. a small quantized reference: phase 3's tiny fp32 model quantized
   `mixed` (slow int8, fast int4, heads int8) with the int8 KV cache, card
   kernels against CPU plain versions: identical greedy token columns,
   prefill logits within 1e-4;
4. the serving slice: the full-width `dual_ar_s2_pro` LM (bf16, random
   weights from a seed, max_seq_len 2048) and the `dac_s2_pro` codec answer
   streamed requests through `TTSInferenceEngine`, one of them with a
   prompt over 512 tokens. The audio must be finite and in whole frames,
   both kernels' launch counts must be > 0, and a repeated request with the
   same seed must give identical codes;
5. the training slice: the serving model is freed, then `Trainer.fit` runs
   8 LoRA steps (r=8, alpha=16, attention/mlp/embeddings/output, remat on)
   of the full-width `dual_ar_s2_pro` (bf16, random weights, max_seq_len
   1024) on one B=2 x T=1024 batch of the shared data pipeline, repeated.
   Every loss must be finite and the last below the first, sampled frozen
   base tensors bitwise unchanged, every LoRA B leaf nonzero, both training
   kernels launched, and the checkpoint must restore;
6. quantized serving: the training model is freed, full-width s2-pro (bf16,
   seed 0, max_seq_len 2048) is quantized `mixed` (`quantize_dual_ar_lowmem
   (mode="int8", fast_mode="int4")`) and served with the int8 KV cache
   (`kv_quant=True`) to phase 4's short request and its repeat: finite
   whole frames, identical codes on the repeated seed, and `int4_mm`,
   `flash_decode_kv8` and `flash_prefill` launched. Then the model is
   rebuilt and quantized `int4` (every layer int4, heads int8) and serves
   the 700-byte request (prefill bucket 1024: `int4_mm` at prefill shapes).
   TTFA, frames/s, weight bytes and peak memory for both, and the fast
   stack's time per frame on the serving path;
7. the fast-stack probe at flagship dims (12 layers x 10 steps, 1536 /
   2560 / 6144): R in {0, 1} x {bf16, w8a8}, each against its plain version
   on one and on two codebook steps (12 and 24 layers at full width, the
   second step re-reading every layer; outputs of rms 1): w8a8 to 1e-5
   (int8 products summed exactly in int32 on both sides), bf16 to 5e-2
   (fp32 sums in another order move a few activations across a bf16
   rounding boundary, a 2^-8 jump each, compounding over the layers).
   Faulty weights in the plain chain (one layer's w2, or one 128-column
   tile of it, from the next layer) must score above each bound. The whole
   120-layer frame is chaotic under such jumps: its error and the kernel's
   run-to-run spread are printed, not held. Then ms per frame and
   effective GB/s through the probe's own `_bench`.

Each phase sets the kernels' launch counts to 0 before it drives its path
and reads them after. The line before the last is a JSON object with each
kernel's numbers; the last line is `{"ok": true, "device": {...}}`. No
result is printed when CUDA is unavailable or when the port's package is
not beside this script.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(plain, kernel, iters):
    """Times (plain, kernel, kernel, plain); returns the two means in ms."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, dense bf16 and int8
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12


def _bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def kernel_cases(dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_reference)
    from fish_speech_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    cases = {"flash_prefill": [], "flash_decode": []}
    # prefill: flagship heads (H=32, Hkv=8, D=128), prompt buckets
    for b, t, offsets in [(1, 64, [0]), (1, 1024, [0]), (2, 600, [0, 129])]:
        q, k, v = randn(b, t, 32, 128), randn(b, t, 8, 128), randn(b, t, 8, 128)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        got = flash_prefill_attention(q, k, v, off)
        want = flash_prefill_reference(q, k, v, off)
        mx, mean = _errors(got, want)
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off),
                                 20)
        pairs = sum((t - o) * (t - o + 1) // 2 for o in offsets)
        bound = _bound(4 * 32 * 128 * pairs, 2 * b * t * 128 * 2 * (32 + 8))
        # SDPA with the same causal, offset mask (GQA heads expanded by SDPA)
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] >= off[:, None, None]))[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = _time_ms(lambda i=0: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        cases["flash_prefill"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 offsets={offsets}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib))
    # decode: slow cache (36 layers, S = 2048 + 64 is the slice's; 4160 the
    # 4096-context one) and fast cache (12 layers, S = 10 codebooks). Each
    # timed launch reads the next layer, as the decode loop does, so the
    # cache is not served from L2.
    for n_layer, s, hkv, g, length in [(36, 4160, 8, 4, 1), (36, 4160, 8, 4, 257),
                                       (36, 4160, 8, 4, 4000), (12, 10, 4, 3, 10)]:
        q = randn(1, hkv, g, 128)
        kc, vc = randn(n_layer, 1, s, hkv, 128), randn(n_layer, 1, s, hkv, 128)
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            got = flash_decode_attention(q, kc, vc, layer, lens)
            want = flash_decode_reference(q, kc, vc, layer, lens)
            e = _errors(got, want)
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens),
            100)
        bound = _bound(4 * hkv * g * 128 * length,
                       2 * (2 * length * hkv * 128 + 2 * hkv * g * 128))
        qs = q.reshape(1, hkv * g, 1, 128)
        lib = _time_ms(lambda i=0: F.scaled_dot_product_attention(
            qs, kc[i % n_layer, :, :length].transpose(1, 2),
            vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True), 100)
        cases["flash_decode"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D=128 len={length}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib))
        del kc, vc
    cases.update(train_kernel_cases(dev, randn))
    cases.update(quant_kernel_cases(dev, randn))
    torch.cuda.synchronize()
    for name, rows in cases.items():
        for r in rows:
            lib = r.get("library_ms")
            print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
                  f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}) library_ms="
                  + ("null" if lib is None else f"{lib:.4f}")
                  + "".join(f" {k}={v[0]:.3e}/{v[1]:.3e}"
                            for k, v in r.get("outputs", {}).items()))
            ok = r.get("ok", r["max_abs_err"] <= 2e-2 and r["mean_abs_err"] <= 2e-3)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version at "
                                 f"{r['shape']}")
    return cases


def _within_bf16_step(got, want):
    want = want.float()
    return bool(((got.float() - want).abs() <= 2e-2 + 2 ** -7 * want.abs()).all())


def train_kernel_cases(dev, randn):
    """The training attention's forward and backward kernels against their
    plain versions on the same inputs (the backward on the plain forward's
    O and lse). Bounds, bf16 from N(0,1): O to 2e-2 plus one bf16 step of
    the value (2^-7 |O|) elementwise and 2e-3 mean abs (the kernel keeps P
    in fp32, the plain version rounds it to bf16; rows with few visible
    keys have |O| above 2, where the two roundings can land one step
    apart); lse, fp32 on both sides, to 1e-4; dQ, dK and dV, which are not convex
    combinations, to 2e-2 of the tensor's largest magnitude (max) and 1e-2
    of its mean magnitude (mean): one bf16 rounding of the output, plus the
    plain version's bf16 rounding of P and dS."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_train import (
        flash_train_backward, flash_train_backward_reference, flash_train_forward,
        flash_train_forward_reference)

    cases = {"flash_train_fwd": [], "flash_train_bwd": []}
    # the fine-tune shape with a right-padded row, the default max_length,
    # and a ragged T (not a multiple of the 64-row tile)
    for b, t, pads in [(2, 1024, [0, 100]), (1, 4096, [0]), (2, 1000, [0, 0])]:
        q, k, v = randn(b, t, 32, 128), randn(b, t, 8, 128), randn(b, t, 8, 128)
        kvalid = torch.ones((b, t), dtype=torch.int32, device=dev)
        for i, n in enumerate(pads):
            if n:
                kvalid[i, -n:] = 0
        do = randn(b, t, 32, 128) * kvalid[:, :, None, None].to(torch.bfloat16)
        shape = f"B={b} T={t} H=32 Hkv=8 D=128 right_pad={pads}"

        o, lse = flash_train_forward(q, k, v, kvalid)
        want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
        e_o, e_lse = _errors(o, want_o), _errors(lse, want_lse)
        ms, plain_ms = _in_turns(
            lambda i=0: flash_train_forward_reference(q, k, v, kvalid),
            lambda i=0: flash_train_forward(q, k, v, kvalid), 10)
        # visible (query, key) pairs: causal and key-valid
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        io_bytes = 2 * b * t * 128 * (32 + 8)  # q, o | k, v: bf16
        fwd_bound = _bound(4 * 32 * 128 * pairs, 2 * io_bytes + 4 * b * 32 * t)
        bwd_bound = _bound(10 * 32 * 128 * pairs,
                           2 * io_bytes + 2 * b * t * 32 * 128 * 2 + 4 * b * 32 * t)
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & kvalid[:, None, :].bool())[:, None]
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

        def sdpa_fwd(i=0):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd(i=0):
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, leaves, dot)

        lib_fwd = _time_ms(sdpa_fwd, 10)
        lib_bwd = _time_ms(sdpa_fwd_bwd, 5) - lib_fwd
        cases["flash_train_fwd"].append(dict(
            shape=shape, max_abs_err=max(e_o[0], e_lse[0]),
            mean_abs_err=max(e_o[1], e_lse[1]), ms=ms, plain_ms=plain_ms,
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
            outputs={"O": e_o, "lse": e_lse},
            ok=_within_bf16_step(o, want_o) and e_o[1] <= 2e-3
            and e_lse[0] <= 1e-4))

        args = (q, k, v, kvalid, want_o, want_lse, do)
        got = flash_train_backward(*args)
        want = flash_train_backward_reference(*args)
        errs, ok = {}, True
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            errs[name] = _errors(g, w)
            ref = w.float().abs()
            ok &= bool(torch.isfinite(g.float()).all())
            ok &= (errs[name][0] <= 2e-2 * ref.max().item()
                   and errs[name][1] <= 1e-2 * ref.mean().item())
        ms, plain_ms = _in_turns(lambda i=0: flash_train_backward_reference(*args),
                                 lambda i=0: flash_train_backward(*args), 5)
        cases["flash_train_bwd"].append(dict(
            shape=shape, max_abs_err=max(e[0] for e in errs.values()),
            mean_abs_err=max(e[1] for e in errs.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=lib_bwd, outputs=errs, ok=ok))
        del q, k, v, do, o, lse, want_o, want_lse, got, want, args
    torch.cuda.empty_cache()
    return cases


# s2-pro's int4 weights, I -> O (w13 fused): slow stack, then fast stack
INT4_SHAPES = [("slow wqkv", 2560, 6144), ("slow wo", 4096, 2560),
               ("slow w13", 2560, 19456), ("slow w2", 9728, 2560),
               ("fast wqkv", 1536, 2560), ("fast wo", 1536, 1536),
               ("fast w13", 1536, 12288), ("fast w2", 6144, 1536)]


def quant_kernel_cases(dev, randn):
    """The int4 matmul and the int8-KV decode kernel against their plain
    versions at the quantized serving path's shapes."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention_kv8, flash_decode_kv8_reference)
    from fish_speech_tpu_torch.ops.int4 import (int4_matmul,
                                                 int4_matmul_reference)
    from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight,
                                                 quantize_int4)

    cases = {"int4_mm": [], "flash_decode_kv8": []}
    g = 128
    shapes = [(1, *s) for s in INT4_SHAPES] + [(1024, *INT4_SHAPES[0]),
                                               (1024, *INT4_SHAPES[2])]
    for b, name, i, o in shapes:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=g)
        x = randn(b, i)
        got = int4_matmul(x, qw["p"], qw["gs"])
        want = int4_matmul_reference(x, qw["p"], qw["gs"]).float()
        w_eff = _int4_effective_weight(qw, torch.float32)
        bound_err = 2.0 ** -8 * (x.float().abs() @ w_eff.abs() + want.abs())
        err = (got.float() - want).abs()
        ok = bool((err <= bound_err).all())
        w_bf16 = w_eff.to(torch.bfloat16)
        del w_eff
        iters = 200 if b == 1 else 10
        ms, plain_ms = _in_turns(
            lambda k=0: int4_matmul_reference(x, qw["p"], qw["gs"]),
            lambda k=0: int4_matmul(x, qw["p"], qw["gs"]), iters)
        lib = _time_ms(lambda k=0: x @ w_bf16, iters)
        bound = _bound(2 * b * i * o, i // 2 * o + 4 * (i // g) * o
                       + 2 * b * (i + o))
        cases["int4_mm"].append(dict(
            shape=f"{name} B={b} I={i} O={o} g={g}", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib, ok=ok))
        del qw, x, w_bf16, got, want, bound_err, err
    # the slow cache of the serving session: 36 layers, S = 2048 + 64
    n_layer, s, hkv, grp = 36, 2112, 8, 4
    kq, ks = _kv_quant(randn(n_layer, 1, s, hkv, 128))
    vq, vs = _kv_quant(randn(n_layer, 1, s, hkv, 128))
    for length in (1, 257, 1100, 2048):
        q = randn(1, hkv, grp, 128)
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        mx = mean = 0.0
        for layer in (0, n_layer - 1):
            e = _errors(flash_decode_attention_kv8(q, kq, ks, vq, vs, layer, lens),
                        flash_decode_kv8_reference(q, kq, ks, vq, vs, layer, lens))
            mx, mean = max(mx, e[0]), max(mean, e[1])
        ms, plain_ms = _in_turns(
            lambda k=0: flash_decode_kv8_reference(q, kq, ks, vq, vs,
                                                   k % n_layer, lens),
            lambda k=0: flash_decode_attention_kv8(q, kq, ks, vq, vs,
                                                   k % n_layer, lens), 100)
        # SDPA over the same cache dequantized to bf16 beforehand
        kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], torch.bfloat16)
        vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], torch.bfloat16)
        qs = q.reshape(1, hkv * grp, 1, 128)
        lib = _time_ms(lambda k=0: F.scaled_dot_product_attention(
            qs, kd[k % n_layer].transpose(1, 2), vd[k % n_layer].transpose(1, 2),
            enable_gqa=True), 100)
        del kd, vd
        bound = _bound(4 * hkv * grp * 128 * length,
                       2 * length * hkv * 128 + 2 * 2 * length * hkv
                       + 2 * 2 * hkv * grp * 128)
        cases["flash_decode_kv8"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={grp} D=128 len={length} "
                  f"int8 K/V", max_abs_err=mx, mean_abs_err=mean, ms=ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=lib))
    del kq, ks, vq, vs
    torch.cuda.empty_cache()
    return cases


def _tiny_cfg(tokenizer):
    """A tiny model whose slow heads (D=64) the attention kernels take."""
    from fish_speech_tpu_torch.config import dual_ar_tiny

    return dual_ar_tiny(vocab_size=tokenizer.vocab_size, head_dim=64,
                        n_head=4, n_local_heads=2, fast_head_dim=64,
                        fast_n_head=3, fast_n_local_heads=1, num_codebooks=10,
                        attention_qk_norm=True, tie_word_embeddings=False,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id)


def small_reference(dev, tokenizer):
    """Phase 3: a tiny fp32 model through the kernels (card) and the plain
    versions (CPU) on the same weights and request."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar

    cfg = _tiny_cfg(tokenizer)
    cpu_params = dual_ar.init_dual_ar(3, cfg, torch.float32, "cpu")
    gpu_params = _to(cpu_params, dev)
    inp = torch.randint(0, cfg.codebook_size, (1, cfg.num_codebooks + 1, 64),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    inp[0, 0, 10:30] += cfg.semantic_begin_id  # a stretch of semantic tokens
    logits = []
    for params, d in ((cpu_params, "cpu"), (gpu_params, dev)):
        cache = dual_ar.init_kv_cache(cfg, 1, 96, torch.float32, d)
        lg, _, _ = dual_ar.prefill(params, cfg, inp.to(d), cache,
                                   torch.zeros(1, dtype=torch.int32, device=d), 60)
        logits.append(lg.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    codes = []
    for params in (cpu_params, gpu_params):
        session = GenerationSession(params, cfg, SamplingConfig(),
                                    dtype=torch.float32, decode_chunk_size=8,
                                    first_chunk_size=4)
        out = [r.codes for r in generate_long(
            session=session, tokenizer=tokenizer, text="A small check.",
            max_new_tokens=20, top_k=1, seed=5) if r.action == "sample"]
        codes.append(np.concatenate(out, axis=1))
    same = codes[0].shape == codes[1].shape and np.array_equal(*codes)
    print(f"small reference (tiny fp32, card kernels vs CPU plain): "
          f"prefill max_abs_err={err:.3e}, greedy codes {codes[0].shape} "
          f"identical={same}")
    if err > 1e-4 or not same:
        raise SystemExit("the kernel path disagrees with the plain path on "
                         "the small reference")


def small_quant_reference(dev, tokenizer):
    """Phase 3c: phase 3's tiny fp32 model quantized `mixed` (slow int8,
    fast int4, heads int8), with the int8 KV cache, through the kernels
    (card) and the plain versions (CPU) on the same weights and request."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention_kv8
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg(tokenizer)
    cpu_params = quantize_dual_ar_lowmem(
        dual_ar.init_dual_ar(3, cfg, torch.float32, "cpu"), mode="int8",
        fast_mode="int4")
    gpu_params = _to(cpu_params, dev)
    inp = torch.randint(0, cfg.codebook_size, (1, cfg.num_codebooks + 1, 64),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    inp[0, 0, 10:30] += cfg.semantic_begin_id
    launches = (int4_matmul.launches, flash_decode_attention_kv8.launches)
    logits = []
    for params, d in ((cpu_params, "cpu"), (gpu_params, dev)):
        cache = dual_ar.init_kv_cache(cfg, 1, 96, torch.float32, d, quant=True)
        lg, _, _ = dual_ar.prefill(params, cfg, inp.to(d), cache,
                                   torch.zeros(1, dtype=torch.int32, device=d), 60)
        logits.append(lg.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    codes = []
    for params in (cpu_params, gpu_params):
        session = GenerationSession(params, cfg, SamplingConfig(),
                                    dtype=torch.float32, decode_chunk_size=8,
                                    first_chunk_size=4, kv_quant=True)
        out = [r.codes for r in generate_long(
            session=session, tokenizer=tokenizer, text="A small check.",
            max_new_tokens=20, top_k=1, seed=5) if r.action == "sample"]
        codes.append(np.concatenate(out, axis=1))
    same = codes[0].shape == codes[1].shape and np.array_equal(*codes)
    ran = (int4_matmul.launches > launches[0]
           and flash_decode_attention_kv8.launches > launches[1])
    print(f"small quantized reference (tiny fp32 mixed int8/int4 + int8 KV, card "
          f"kernels vs CPU plain): prefill max_abs_err={err:.3e}, greedy codes "
          f"{codes[0].shape} identical={same}, int4/kv8 kernels ran={ran}")
    if err > 1e-4 or not same or not ran:
        raise SystemExit("the quantized kernel path disagrees with the plain "
                         "path on the small reference")


def _to(tree, dev):
    """A copy of a tensor tree on `dev` (new leaf tensors, never shared)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _numpy_batch(cfg, rng, b, t, pads):
    """A training batch in `TextDataCollator`'s layout: text ids with
    stretches of semantic tokens carrying codebook values, rows right-padded
    by `pads` (padding is IGNORE_INDEX in the labels)."""
    inputs = np.zeros((b, cfg.num_codebooks + 1, t), dtype=np.int32)
    inputs[:, 0] = rng.integers(4, 200, size=(b, t))
    sem = rng.random((b, t)) < 0.6
    for i in range(b):
        codes = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
        inputs[i, 0, sem[i]] = cfg.semantic_begin_id + codes[0, sem[i]]
        inputs[i, 1:, sem[i]] = codes[:, sem[i]].T
    labels = inputs.copy()
    pad = np.zeros((b, t), bool)
    for i, n in enumerate(pads):
        if n:
            pad[i, -n:] = True
            labels[i, :, -n:] = -100
    return {"inputs": inputs, "labels": labels, "pad_mask": pad}


def small_train_reference(dev, tokenizer):
    """Phase 3b: a tiny fp32 LoRA model takes two optimizer steps through the
    training attention kernels (card) and the plain versions (CPU), from the
    same weights on the same batch (T=200: a ragged tile, one row padded).
    Pass: both steps' losses within 1e-5 and every LoRA leaf within 1e-5
    after the steps (fp32 on both sides, TF32 off; only the summation order
    differs)."""
    import torch

    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.lora import (LoraConfig, add_lora,
                                                   apply_lora_config,
                                                   lora_filter)
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.train.step import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg(tokenizer)
    lcfg = LoraConfig(r=4, lora_alpha=8.0)
    base = add_lora(dual_ar.init_dual_ar(4, cfg, torch.float32, "cpu"), cfg,
                    lcfg, seed=5, dtype=torch.float32)
    cfg = apply_lora_config(cfg, lcfg)
    batch = _numpy_batch(cfg, np.random.default_rng(0), 2, 200, [0, 37])
    launches = (flash_train_forward.launches, flash_train_backward.launches)
    losses, trees = [], []
    for d in ("cpu", dev):
        params = _to(base, d)
        opt = make_optimizer(params, lr=1e-3, trainable_mask=lora_filter(params))
        step = make_train_step(cfg, opt)
        placed = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        losses.append([float(step(params, placed)["loss"]) for _ in range(2)])
        trees.append({k: v.detach().cpu() for k, v in _flat(params).items()
                      if "lora" in k})
    if (flash_train_forward.launches == launches[0]
            or flash_train_backward.launches == launches[1]):
        raise SystemExit("the card's training steps did not run the kernels")
    loss_err = max(abs(a - b) for a, b in zip(*losses))
    leaf_err = max((trees[0][k] - trees[1][k]).abs().max().item()
                   for k in trees[0])
    moved = all(not torch.equal(trees[0][k], _flat(base)[k]) for k in trees[0])
    print(f"small training reference (tiny fp32 LoRA, 2 steps, card kernels vs "
          f"CPU plain): losses {losses[0]} vs {losses[1]}, max loss err "
          f"{loss_err:.3e}, max LoRA leaf err {leaf_err:.3e} over "
          f"{len(trees[0])} leaves, all moved={moved}")
    if loss_err > 1e-5 or leaf_err > 1e-5 or not moved:
        raise SystemExit("the training kernels disagree with the plain path on "
                         "the small reference")


def _recording_engine(session, tokenizer, codec, dac_cfg):
    """A `TTSInferenceEngine` that keeps the codes of the last decoded
    segment, for the repeat check."""
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine

    class RecordingEngine(TTSInferenceEngine):
        def decode_vq_tokens(self, codes):
            self.last_codes = np.array(codes)
            return super().decode_vq_tokens(codes)

    return RecordingEngine(session, tokenizer, codec, dac_cfg)


def _s2_pro_cfg(tokenizer, max_seq_len):
    from fish_speech_tpu_torch.config import dual_ar_s2_pro

    cfg = dual_ar_s2_pro(semantic_begin_id=tokenizer.semantic_begin_id,
                         semantic_end_id=tokenizer.semantic_end_id,
                         im_end_id=tokenizer.im_end_id)
    return dataclasses.replace(cfg, max_seq_len=max_seq_len).resolve()


def _requests():
    """Phase 4's streamed requests (one client, in this order). 72 new
    tokens each: the first chunk of 8 and one of 64, so no step is cut."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    short = "Hello from the port. This is a short streamed request."
    long_text = ("The quick brown fox jumps over the lazy dog, and then it runs "
                 "back home before the rain. ") * 8
    long_text = long_text[:700]
    medium = ("Streaming speech synthesis sends the first audio while the "
              "rest is still being generated. ") * 3
    return [
        ("short", TTSRequest(text=short, streaming=True, max_new_tokens=72, seed=11)),
        ("long", TTSRequest(text=long_text, streaming=True, max_new_tokens=72,
                            seed=12, chunk_length=1000)),
        ("medium", TTSRequest(text=medium, streaming=True, max_new_tokens=72,
                              seed=13)),
        ("short-repeat", TTSRequest(text=short, streaming=True,
                                    max_new_tokens=72, seed=11)),
    ]


def serve(dev, tokenizer, engine, requests, frame, label):
    """Stream `requests` through `engine`, checking every segment; returns
    the per-request rows and codes."""
    import torch

    results, codes = [], {}
    for name, req in requests:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        t_first = t_last = None
        samples, n_seg = 0, 0
        for res in engine.inference(req):
            now = time.perf_counter()
            if res.code == "error":
                raise SystemExit(f"{label} request {name} failed: {res.error!r}")
            if res.code == "segment":
                audio = res.audio[1]
                if len(audio) % frame or not np.isfinite(audio).all():
                    raise SystemExit(f"{label} request {name}: a segment of "
                                     f"{len(audio)} samples is not whole finite "
                                     f"frames")
                samples += len(audio)
                n_seg += 1
                t_first = t_first or now
                t_last = now
            if res.code == "final":
                if not np.isfinite(res.audio[1]).all() or len(res.audio[1]) != samples:
                    raise SystemExit(f"{label} request {name}: bad final audio")
        frames = samples // frame
        if frames < 2 or t_first is None:
            raise SystemExit(f"{label} request {name}: only {frames} frames")
        codes[name] = engine.last_codes
        prompt_len = len(tokenizer.encode(req.text))
        row = dict(request=name, text_bytes=len(req.text.encode()),
                   ttfa_s=t_first - t_start, frames=frames, segments=n_seg,
                   samples=samples,
                   decode_frames_per_s=(frames - 1) / (t_last - t_first),
                   wall_s=t_last - t_start)
        results.append(row)
        print(f"{label} request {name}: text {row['text_bytes']} bytes "
              f"(~{prompt_len} text tokens), TTFA {row['ttfa_s'] * 1e3:.1f} ms, "
              f"{frames} frames in {n_seg} segments, decode "
              f"{row['decode_frames_per_s']:.2f} frames/s, {samples} samples, "
              f"wall {row['wall_s']:.2f}s")
    torch.cuda.synchronize()
    if "short-repeat" in codes:
        same = np.array_equal(codes["short"], codes["short-repeat"])
        print(f"{label} repeat with the same seed: codes {codes['short'].shape} "
              f"identical={same}")
        if not same:
            raise SystemExit(f"{label}: the repeated request gave different codes")
    return results


def _counted(wrappers):
    """Launch counts of `wrappers` (name -> function), read after a path."""
    return {name: f.launches for name, f in wrappers.items()}


def run_slice(dev, tokenizer):
    """Phase 4: the full-width LM and codec answer streamed requests."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.convert.from_jax import init_dac_decoder
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention

    t0 = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    if cfg.num_codebooks != dac_cfg.rvq.total_codebooks:
        raise SystemExit("LM and codec codebook counts differ")
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    n_params = dual_ar.param_count(params)
    codec = init_dac_decoder(1, dac_cfg, torch.float32, dev)
    session = GenerationSession(params, cfg, SamplingConfig(),
                                dtype=torch.bfloat16, decode_chunk_size=64,
                                first_chunk_size=8)
    del params  # the session holds the fused-FFN copy it decodes with
    engine = _recording_engine(session, tokenizer, codec, dac_cfg)
    torch.cuda.synchronize()
    print(f"slice: dual_ar_s2_pro {n_params / 1e9:.3f}B params bf16 "
          f"(max_seq_len 2048) + dac_s2_pro, built in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    for f in _kernel_wrappers():
        f.launches = 0
    results = serve(dev, tokenizer, engine, _requests(), dac_cfg.frame_length,
                    "bf16")
    launches = _counted({"flash_prefill": flash_prefill_attention,
                         "flash_decode": flash_decode_attention})
    print(f"kernel launches on the engine path: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit("a kernel of the path was never launched")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return results, launches


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def fast_stack_frame_ms(session, frames=20):
    """The serving path's fast stack per frame: `_sample_column` (project
    in, NC fast steps with their heads and samplers, one top-k of the slow
    head) on a random hidden state, CUDA events over `frames` frames."""
    import torch

    from fish_speech_tpu_torch.generate import _sample_column

    cfg, dev = session.cfg, session.device
    gen = torch.Generator(device=dev).manual_seed(0)
    hidden = torch.randn((1, cfg.dim), generator=gen, device=dev,
                         dtype=torch.bfloat16)
    logits = torch.randn((1, cfg.semantic_end_id - cfg.semantic_begin_id + 2),
                         generator=gen, device=dev)

    def frame(i=0):
        return _sample_column(session.params, cfg, session.scfg, logits, hidden,
                              None, gen, 1.0, 0.9, 30)

    return _time_ms(frame, frames)


def run_quant_slice(dev, tokenizer):
    """Phase 6: quantized serving of full-width s2-pro with the int8 KV
    cache, `mixed` (the short request and its repeat), then `int4` (the
    700-byte request)."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.convert.from_jax import init_dac_decoder
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention_kv8
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.int4 import int4_matmul
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    codec = init_dac_decoder(1, dac_cfg, torch.float32, dev)
    wrappers = {"int4_mm": int4_matmul, "flash_decode_kv8": flash_decode_attention_kv8,
                "flash_prefill": flash_prefill_attention}
    requests = dict(_requests())
    out = {}
    for label, mode, fast_mode, names in (
            ("mixed", "int8", "int4", ["short", "short-repeat"]),
            ("int4", "int4", None, ["long"])):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = quantize_dual_ar_lowmem(
            dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev), mode=mode,
            fast_mode=fast_mode)
        session = GenerationSession(params, cfg, SamplingConfig(), max_batch=1,
                                    dtype=torch.bfloat16, decode_chunk_size=64,
                                    first_chunk_size=8, kv_quant=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        engine = _recording_engine(session, tokenizer, codec, dac_cfg)
        torch.cuda.synchronize()
        weight_bytes = _tree_bytes(session.params)
        print(f"quantized slice {label} (slow {mode}, fast {fast_mode or mode}, "
              f"heads int8, int8 KV cache): built and quantized in "
              f"{time.perf_counter() - t0:.1f}s; session weights "
              f"{weight_bytes / 2**30:.3f} GiB; device memory allocated "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        for f in _kernel_wrappers():
            f.launches = 0
        rows = serve(dev, tokenizer, engine, [(n, requests[n]) for n in names],
                     dac_cfg.frame_length, label)
        launches = _counted(wrappers)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        fast_ms = fast_stack_frame_ms(session)
        print(f"{label}: kernel launches {launches}; peak device memory "
              f"{peak:.2f} GiB; serving fast stack {fast_ms:.3f} ms/frame "
              f"(_sample_column, CUDA events)")
        if min(launches.values()) <= 0:
            raise SystemExit(f"{label}: a kernel of the quantized path was never "
                             f"launched: {launches}")
        out[label] = dict(rows=rows, launches=launches, peak_gib=peak,
                          weight_bytes=weight_bytes, fast_stack_ms=fast_ms)
        del engine, session
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _probe_faults(weights, dims):
    """Two faulty weight sets for the plain chain, to show what a wrong
    kernel scores against the check's bound: layer 0 reads layer 1's whole
    w2 (the kind of fault the TPU probe's prefetch race makes), and layer 0
    reads layer 1's w2 in one 128-column tile only (one block's share)."""
    from fish_speech_tpu_torch.ops.faststack import layer_weights

    faults = {}
    for name, cols in (("layer 0 reads layer 1's w2", slice(None)),
                       ("one 128-column tile of layer 0's w2 from layer 1",
                        slice(0, 128))):
        bad = {"w": weights["w"].clone(), "sc": weights["sc"]}
        layer_weights(bad, 0, dims)["w2"][0][:, cols] = (
            layer_weights(weights, 1, dims)["w2"][0][:, cols])
        faults[name] = bad
    return faults


def run_probe(dev, serving_fast_ms):
    """Phase 7: the fast-stack probe at flagship dims against its plain
    version, R in {0, 1} x {bf16, w8a8}."""
    import torch

    from fish_speech_tpu_torch.ops import faststack

    dims = faststack.ProbeDims()
    t0 = time.perf_counter()
    weights = faststack.make_weights(dims, dev)
    print(f"probe: {dims}, weights {dims.layer_bytes * dims.n_layer / 1e6:.1f} MB "
          f"int8 made in {time.perf_counter() - t0:.1f}s")
    x = torch.full((1, dims.df), 0.01, device=dev)
    configs = [(variant, r) for variant in ("bf16", "w8a8") for r in (0, 1)]
    # the checks: one and two codebook steps (12 and 24 layers; the second
    # step re-reads every layer, the resident one from L2) at full width
    held = [dataclasses.replace(dims, steps=n) for n in (1, 2)]
    tol = {"bf16": 5e-2, "w8a8": 1e-5}
    faults = _probe_faults(weights, dims)
    for variant in tol:
        for d in held:
            want = faststack.probe_reference(x, weights, variant, d)
            for name, bad in faults.items():
                e = (faststack.probe_reference(x, bad, variant, d) - want).abs()
                print(f"probe fault yardstick {variant} steps={d.steps}: {name}: "
                      f"max_abs_err {e.max().item():.3e} mean {e.mean().item():.3e} "
                      f"(bound {tol[variant]:g})")
                if e.max().item() <= tol[variant]:
                    raise SystemExit(f"probe: the {variant} bound cannot see a "
                                     f"fault ({name})")
    del faults
    checks = {}
    for variant, r in configs:
        errs = []
        for d in held:
            got = faststack.faststack_probe(x, weights, r, variant, d)
            want = faststack.probe_reference(x, weights, variant, d)
            errs.append((got - want).abs())
        frame = faststack.faststack_probe(x, weights, r, variant, dims)
        again = faststack.faststack_probe(x, weights, r, variant, dims)
        frame_want = faststack.probe_reference(x, weights, variant, dims)
        plain_ms = _time_ms(lambda i=0: faststack.probe_reference(
            x, weights, variant, dims), 2)
        checks[variant, r] = dict(
            errs=errs, out_max=want.abs().max().item(),
            finite=bool(torch.isfinite(frame).all()), plain_ms=plain_ms,
            frame_err=(frame - frame_want).abs().max().item(),
            spread=(frame - again).abs().max().item())
    # the probe's own entry point (`python -m ...faststack`'s `_bench`):
    # best of 3 x 30 chained frames; only these launches are counted
    faststack.faststack_probe.launches = 0
    rows = []
    scale_bytes = 4 * (dims.dqkv + 2 * dims.df + 2 * dims.inter)
    for variant, r in configs:
        ms = faststack._bench(r, variant, dims=dims, weights=weights, device=dev)
        c = checks[variant, r]
        plain_ms = c["plain_ms"]
        traffic = dims.frame_bytes(r)
        # least time: every streamed layer (weights and scales) is read on
        # each step, the resident one once; the L2 cannot hold the rest
        layer_reads = r + dims.steps * (dims.n_layer - r)
        flops = 2 * dims.layer_bytes * dims.n_layer * dims.steps
        bound = _bound(flops, traffic + layer_reads * scale_bytes + 8 * dims.df,
                       PEAK_INT8 if variant == "w8a8" else PEAK_BF16)
        row = dict(shape=f"R={r} {variant} DF={dims.df} DQKV={dims.dqkv} "
                         f"INTER={dims.inter} NL={dims.n_layer} "
                         f"steps={dims.steps} (error: 1 and 2 steps)",
                   max_abs_err=max(e.max().item() for e in c["errs"]),
                   mean_abs_err=max(e.mean().item() for e in c["errs"]),
                   step_max_abs_err=[e.max().item() for e in c["errs"]],
                   frame_max_abs_err=c["frame_err"], frame_spread=c["spread"],
                   ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                   bound_by=bound[1], library_ms=None,
                   effective_gb_s=traffic / ms / 1e6)
        rows.append(row)
        steps_err = ", ".join(f"{d.steps} step(s) ({d.steps * d.n_layer} layers) "
                              f"{e.max().item():.3e} mean {e.mean().item():.3e}"
                              for d, e in zip(held, c["errs"]))
        print(f"probe R={r} {variant}: {ms:.4f} ms/frame, effective "
              f"{row['effective_gb_s']:.0f} GB/s over {traffic / 1e9:.3f} GB "
              f"(bound {row['bound_ms']:.4f} ms, {row['bound_by']}); plain "
              f"{plain_ms:.2f} ms; max_abs_err at {steps_err} (bound "
              f"{tol[variant]:g}), max |out| {c['out_max']:.3f}; whole frame "
              f"({dims.steps * dims.n_layer} layers): max_abs_err "
              f"{c['frame_err']:.3e}, kernel run-to-run {c['spread']:.3e}")
        if not (c["finite"] and row["max_abs_err"] <= tol[variant]):
            raise SystemExit(f"probe R={r} {variant} disagrees with its plain "
                             f"version")
    launches = faststack.faststack_probe.launches
    faststack.reset_l2_persistence()
    print(f"probe vs serving: the probe's matvec chain {min(r['ms'] for r in rows):.3f}"
          f"-{max(r['ms'] for r in rows):.3f} ms/frame against the serving fast "
          f"stack's {serving_fast_ms:.3f} ms/frame (mixed: fast int4, with "
          f"attention, heads and sampling); kernel launches {launches}")
    if launches <= 0:
        raise SystemExit("the probe kernel was never launched")
    return rows, launches


def _write_protos(path, num_codebooks, codebook_size, rng):
    """A small proto shard: two speakers, sentences of random text and
    random codes, enough for samples past 1024 tokens and shorter ones."""
    from fish_speech_tpu_torch.data.protos import Semantics, Sentence, TextData
    from fish_speech_tpu_torch.data.stream import write_pb_stream

    words = ["speech", "model", "voice", "quiet", "river", "light", "stone",
             "window", "morning", "paper", "simple", "garden"]
    with open(path, "wb") as f:
        for name, n_sentences in (("spk0", 16), ("spk1", 5)):
            sentences = []
            for _ in range(n_sentences):
                text = " ".join(rng.choice(words, size=int(rng.integers(4, 9))))
                frames = int(rng.integers(20, 60))
                sems = [Semantics(values=rng.integers(0, codebook_size,
                                                      size=frames).tolist())
                        for _ in range(num_codebooks)]
                sentences.append(Sentence(texts=[text], semantics=sems))
            write_pb_stream(f, TextData(source="chip_smoke", name=name,
                                        sentences=sentences))
    return path


def run_train_slice(dev, tokenizer, cfg, out_dir):
    """Phase 5: LoRA fine-tuning of `cfg` through `Trainer.fit` on one batch
    of the shared data pipeline, repeated, so that the loss must fall."""
    import itertools
    import shutil

    import torch

    from fish_speech_tpu_torch.data.dataset import (SemanticIterableDataset,
                                              TextDataCollator)
    from fish_speech_tpu_torch.models.dual_ar import param_count
    from fish_speech_tpu_torch.models.lora import LoraConfig
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    steps, batch_size, max_length = 8, 2, 1024
    # constant after a one-step warmup: at this rate the loss on the
    # repeated batch falls within the 8 steps
    lr = 1e-3
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    proto = _write_protos(out_dir / "data.protos", cfg.num_codebooks,
                          cfg.codebook_size, rng)
    ds = SemanticIterableDataset([str(proto)], tokenizer, seed=0,
                                 max_length=max_length,
                                 num_codebooks=cfg.num_codebooks)
    stream = iter(ds)
    batch = TextDataCollator(tokenizer, max_length)(
        [next(stream) for _ in range(batch_size)])
    real_tokens = int((~batch["pad_mask"]).sum())

    lora = LoraConfig(r=8, lora_alpha=16.0,
                      target_modules=["attention", "mlp", "embeddings", "output"])
    tcfg = TrainConfig(output_dir=str(out_dir), project="lora",
                       max_steps=steps, batch_size=batch_size,
                       max_length=max_length, lr=lr, warmup_steps=1,
                       schedule="constant", log_every_steps=1,
                       val_every_steps=10 ** 9, ckpt_every_steps=steps,
                       seed=0, precision="bfloat16", lora=lora)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    flat = _flat(trainer.params)
    n_lora = sum(v.numel() for k, v in flat.items() if "lora" in k)
    n_base = param_count(trainer.params) - n_lora
    print(f"training slice: {n_base / 1e9:.3f}B base params bf16 (frozen, "
          f"remat={trainer.cfg.use_gradient_checkpointing}), "
          f"{n_lora / 1e6:.2f}M LoRA params (r=8, alpha=16, "
          f"{','.join(lora.target_modules)}), built in "
          f"{time.perf_counter() - t0:.1f}s; batch {tuple(batch['inputs'].shape)} "
          f"from the data pipeline, {real_tokens} real tokens; constant LR "
          f"{lr:g} after a 1-step warmup; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    # samples of the frozen base: first/last layers, the semantic rows and
    # columns of the tables the batch reads
    sem = slice(cfg.semantic_begin_id, cfg.semantic_end_id + 1)
    samples = {"layers/wqkv": (0,), "layers/w2": (-1,), "fast/layers/w1": (0,),
               "embeddings": (sem,), "codebook_embeddings": (slice(0, 4096),),
               "output": (slice(None), sem), "fast/output": (slice(None),)}
    frozen = {k: flat[k][idx].clone() for k, idx in samples.items()}

    for f in _kernel_wrappers():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.fit(itertools.repeat(batch, steps), resume=False)
    torch.cuda.synchronize()
    launches = {"flash_train_fwd": flash_train_forward.launches,
                "flash_train_bwd": flash_train_backward.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    recs = [json.loads(line) for line in
            (trainer.out_dir / "metrics.jsonl").read_text().splitlines()]
    step_tokens = batch_size * max_length
    for r in recs:
        s = 1.0 / r["it_per_s"]
        print(f"train step {r['step']}: loss {r['loss']:.4f} (base "
              f"{r['base_loss']:.4f} semantic {r['semantic_loss']:.4f}) grad_norm "
              f"{r['grad_norm']:.4f} {s:.3f} s/step {step_tokens / s:.0f} tokens/s "
              f"({real_tokens / s:.0f} real)")
    steady = float(np.mean([1.0 / r["it_per_s"] for r in recs[1:]]))
    print(f"training: steps 2-{steps} mean {steady:.4f} s/step, "
          f"{step_tokens / steady:.0f} tokens/s; peak device memory {peak:.2f} GiB; "
          f"kernel launches {launches}")

    losses = [r["loss"] for r in recs]
    if len(recs) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"training: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"training: the loss did not fall on a repeated batch: "
                         f"{losses}")
    flat = _flat(trainer.params)
    changed = [k for k, v in frozen.items()
               if not torch.equal(flat[k][samples[k]], v)]
    zero_b = [k for k, v in flat.items()
              if "lora" in k and k.endswith("/b") and not bool(v.any())]
    if changed or zero_b:
        raise SystemExit(f"training: frozen tensors changed {changed}, LoRA B "
                         f"leaves still zero {zero_b}")
    if min(launches.values()) <= 0:
        raise SystemExit("a training kernel of the path was never launched")

    # the checkpoint holds the LoRA leaves and the optimizer state: wipe the
    # leaves and restore them
    ckpt = trainer.latest_checkpoint()
    lora_now = {k: v.detach().clone() for k, v in flat.items() if "lora" in k}
    with torch.no_grad():
        for k in lora_now:
            flat[k].zero_()
    trainer.step = 0
    restored = trainer.restore_checkpoint(ckpt)
    same = all(torch.equal(flat[k], v) for k, v in lora_now.items())
    print(f"checkpoint {ckpt.name}: {len(lora_now)} LoRA leaves restored "
          f"identical={same}, step {trainer.step}, optimizer count "
          f"{trainer.optimizer.count}")
    if not (restored and same and trainer.step == steps
            and trainer.optimizer.count == steps):
        raise SystemExit("training: the checkpoint did not restore")
    return launches


def _kernel_wrappers():
    from fish_speech_tpu_torch.ops.faststack import faststack_probe
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention, flash_decode_attention_kv8)
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.ops.int4 import int4_matmul

    return (flash_prefill_attention, flash_decode_attention, flash_train_forward,
            flash_train_backward, int4_matmul, flash_decode_attention_kv8,
            faststack_probe)


SRC = "fish_speech_tpu_torch/csrc/"
KERNELS = {  # name: (source, the TPU kernel or JAX code it replaces)
    "flash_prefill": (SRC + "flash_prefill.cu",
                      "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_decode": (SRC + "flash_decode.cu",
                     "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_train_fwd": (SRC + "flash_train.cu",
                        "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    "flash_train_bwd": (SRC + "flash_train.cu",
                        "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "int4_mm": (SRC + "int4_mm.cu", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "flash_decode_kv8": (SRC + "flash_decode.cu",
                         "fish_speech_tpu/ops/attention.py:66"),
    "faststack_probe": (SRC + "faststack.cu",
                        "fish_speech_tpu/ops/pallas_faststack.py:136"),
}
# headline shapes: the long request's prefill bucket, a 257-long cache, the
# B=2 x T=1024 fine-tune shape, the slow w13 (B=1), a 257-long int8 cache,
# the probe at R=0 in bf16
HEADLINE = {"flash_prefill": 1, "flash_decode": 1, "flash_train_fwd": 0,
            "flash_train_bwd": 0, "int4_mm": 2, "flash_decode_kv8": 1,
            "faststack_probe": 0}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
    from fish_speech_tpu_torch.ops import _kernels

    dev = torch.device("cuda:0")
    smi = _nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.load_kernels()
    print(f"kernels built from {_kernels.CSRC} and loaded in "
          f"{time.perf_counter() - t0:.1f}s: {_kernels.library_path()}")

    cases = kernel_cases(dev)
    tokenizer = build_test_tokenizer()
    small_reference(dev, tokenizer)
    small_train_reference(dev, tokenizer)
    small_quant_reference(dev, tokenizer)
    _, launches = run_slice(dev, tokenizer)
    gc.collect()  # the serving slice's model and caches go before training
    torch.cuda.empty_cache()
    train_launches = run_train_slice(
        dev, tokenizer, _s2_pro_cfg(tokenizer, 1024),
        Path(__file__).resolve().parent / "build" / "chip_smoke_train")
    launches.update(train_launches)
    gc.collect()  # the training model goes before quantized serving
    torch.cuda.empty_cache()
    quant = run_quant_slice(dev, tokenizer)
    launches["int4_mm"] = quant["mixed"]["launches"]["int4_mm"]
    launches["flash_decode_kv8"] = quant["mixed"]["launches"]["flash_decode_kv8"]
    cases["faststack_probe"], launches["faststack_probe"] = run_probe(
        dev, quant["mixed"]["fast_stack_ms"])

    kernels = []
    for name, rows in cases.items():
        pick = rows[HEADLINE[name]]
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
            "library_ms": pick["library_ms"],
            "shape": pick["shape"], "cases": rows,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
