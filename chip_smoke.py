#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`fish_speech_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions,
   the build of the CUDA kernels from `fish_speech_tpu_torch/csrc/` (the
   tensor-core kernels' registers and spills from ptxas' report), and the
   count of HGMMA (wgmma) instructions in the SASS (`cuobjdump -sass`) of
   the int4 tensor-core kernel, of the two attention forwards
   (`train_fwd_wgmma_kernel`, `prefill_wgmma_kernel`) and of the training
   backward's two kernels (`train_bwd_dkdv_wgmma_kernel`,
   `train_bwd_dq_wgmma_kernel`), none of which may be 0, and the blocks
   per SM of the backward's two kernels (CUDA's occupancy calculator);
2. each kernel against its plain PyTorch version at the main paths' shapes,
   in bf16 from N(0,1) inputs (pass: max abs error <= 2e-2, mean <= 2e-3,
   the bound of bf16 rounding of P before P.V in the plain version; the
   training forward's O also gets one bf16 step of the value, 2^-7 |O|;
   the training backward's dQ/dK/dV, 2e-2 of the tensor's largest
   magnitude and 1e-2 of its mean magnitude), timed with CUDA events in
   turns (plain, kernel, kernel, plain). The attention kernels' bf16
   cases run their tensor-core route and print TFLOP/s (the backward's
   on the minimal five products a pair): the prefill at B=1 T=64, 1024
   and 4096 and B=2 T=600 with offsets [0, 129], the training forward
   and backward at B=2 T=1024 with a right-padded row, B=1 T=4096 and a
   ragged B=2 T=1000; their fp32 CUDA-core route is held once at a small
   shape (B=2 T=256, one row padded 30), to 1e-4 (the backward's of each
   tensor's largest magnitude).
   The int4 matmul's matvec route runs at s2-pro's eight decode shapes
   (B=1), its tensor-core route at the slow stack's four shapes at B=128
   and B=1024 (the two prompt buckets) and at a ragged (1000, 384, 200,
   g=64); every case is held to one bf16 rounding of W and y, 2^-8
   (|x| @ |W| + |y|) elementwise, against the fp32-W plain version, and
   the tensor-core cases also to their own plain version (the Pallas
   kernel's bf16 W, summed in fp32) within 2^-8 |y| + 1e-5 (|x| @ |W|);
   each prints its TFLOP/s. The int8-KV decode kernel runs in bf16 at the
   slow caches (S = 2048 + 64 at len 1, 257, 1100 and 2048, S = 4096 + 64
   at len 4000) to kernel 2's bounds and in fp32 at phase 3c's tiny cache
   to 1e-4. The fp32 routes of the decode (phase 3's tiny slow and fast
   caches) and of the int4 matvec (phase 3c's tiny fast shapes) are held
   to 1e-4 and to 1e-5 of |x| @ |W|. The decode cases (slow cache
   S = 4160 at len 1, 257 and 4000, S = 2112 at len 2048, fast cache S =
   10), the int8-KV and fp32 cases and the matvec cases also print
   `device_ms`: the same calls
   captured in one CUDA graph and replayed (no wrapper host cost; the
   matvec walking copies of its weight, and cuBLAS copies of the bf16 W,
   over twice the L2), with the library call's `library_device_ms` and the
   wrapper's host cost (`ms` - `device_ms`). Each case also reports its
   bound (the larger of its bytes over 3.35 TB/s and its operations over
   989 TFLOP/s, H100 SXM) and, where one PyTorch call computes the same
   function, that call's time (SDPA, with `is_causal` where the mask is
   plain causal and the mask tensor where padding or offsets need it, the
   best of three runs for the attention cases; cuBLAS on the dequantized
   weight);
3. a small-input reference: a tiny fp32 model runs the same greedy request
   through the kernels on the card (its session's graphs captured at first
   use) and through the plain versions on the CPU (the same step bodies
   run eagerly); token columns must be identical and prefill logits within
   1e-4;
3b. a small training reference: a tiny fp32 LoRA model takes two
   `make_train_step` steps through the training kernels on the card (the
   forward's and the backward's CUDA-core route, which must launch) and
   the plain versions on the CPU; losses and LoRA leaves must agree to
   1e-5;
3c. a small quantized reference: phase 3's tiny fp32 model quantized
   `mixed` (slow int8, fast int4, heads int8) with the int8 KV cache, card
   kernels against CPU plain versions: identical greedy token columns,
   prefill logits within 1e-4;
4. the serving slice: the full-width `dual_ar_s2_pro` LM (bf16, random
   weights from a seed, max_seq_len 2048) and the full `dac_s2_pro` codec
   (encoder included) answer streamed requests through
   `TTSInferenceEngine`, one of them with a prompt over 512 tokens. The
   session's CUDA graphs (each request's prefill bucket, the decode step)
   are captured first by `GenerationSession.precompile`, and the codec's
   decode graphs of the code buckets the requests reach (32 and 128) by
   `TTSInferenceEngine.precompile` (capture seconds and both pools printed
   apart from the requests). The audio must be finite and in whole
   frames, the decode kernel and the prefill's tensor-core route must have
   been launched (by graph replays: a replay adds the launches its capture
   recorded), every decode step must have been a replay of the step graph
   and every codec call a replay of a codec graph (no eager body run on
   the card), and a repeated request with the same seed must give
   identical codes. The first request's TTFA is printed beside the
   others'; then the codec's device ms per replay for each (rows, bucket)
   reached, and the launches of one replayed step by kernel and its
   device time (CUDA events over 64 replays);
4b. voice cloning on the same model, session and engine: a ~30 s
   reference clip written from a seed under `build/` (16-bit mono PCM at
   24 kHz, so `load_audio` resamples it) with its transcript, in a
   references directory. Its encode graph (bucket 1024) and its prompt's
   prefill graph are captured first; then three streamed requests of 72
   new tokens: by `reference_id` (memory cache on), by `references` (the
   same bytes and text) and by id again, with one seed. Each must give
   finite whole frames and no `error`; the clip must have been encoded
   once (one VQ cache miss, a hit), every prompt prefilled by
   `prefill_1024`, the prefill's tensor-core route and the decode kernel
   launched, the encode graph replayed, no step or codec body run eagerly
   on the card, and the three requests' codes identical. The TTFAs (the
   first with the clip's `load_audio` + encode time apart), frames/s, the
   encode's device ms at bucket 1024, the codec pool and the peak memory
   are printed. The replayed encode's codes must equal an eager run of
   the same body on the card bit for bit; their agreement with an eager
   run without TF32 (cuDNN and matmul) is printed per codebook, not held
   (TF32 against fp32 moves near ties of the argmax);
5. the training slice: the serving model is freed, then `Trainer.fit` runs
   8 LoRA steps (r=8, alpha=16, attention/mlp/embeddings/output, remat on)
   of the full-width `dual_ar_s2_pro` (bf16, random weights, max_seq_len
   1024) on one B=2 x T=1024 batch of the shared data pipeline, repeated.
   Every loss must be finite and the last below the first, sampled frozen
   base tensors bitwise unchanged, every LoRA B leaf nonzero, the
   forward's tensor-core route launched, the backward 288 times on its
   tensor-core route and never on the CUDA cores, and the checkpoint
   must restore; s/step and tokens/s are printed beside the
   prediction;
6. quantized serving: the training model is freed, full-width s2-pro (bf16,
   seed 0, max_seq_len 2048) is quantized `mixed` (`quantize_dual_ar_lowmem
   (mode="int8", fast_mode="int4")`) and served with the int8 KV cache
   (`kv_quant=True`) to phase 4's short request and its repeat: finite
   whole frames, identical codes on the repeated seed, and `int4_mm`,
   `flash_decode_kv8` and `flash_prefill` (tensor-core route) launched. Then the model is
   rebuilt and quantized `int4` (every layer int4, heads int8) and serves
   the 700-byte request (prefill bucket 1024: the int4 matmul's
   tensor-core route, whose launch count must be > 0). Both serve through
   graphs captured beforehand, as phase 4 does, with the same replay
   checks (the codec's decode graphs captured first, as in phase 4).
   TTFA, frames/s, weight bytes and peak memory for both, the
   replayed step's launches and device time, and the fast stack's time per
   frame on the serving path, eager and replayed from a graph;
7. the fast-stack probe at flagship dims (12 layers x 10 steps, 1536 /
   2560 / 6144): R in {0, 1} x {bf16, w8a8}, each against its plain version
   on one and on two codebook steps (12 and 24 layers at full width, the
   second step re-reading every layer; outputs of rms 1): w8a8 to 1e-5
   (int8 products summed exactly in int32 on both sides), bf16 to 5e-2
   (fp32 sums in another order move a few activations across a bf16
   rounding boundary, a 2^-8 jump each, compounding over the layers).
   Faulty weights in the plain chain (one layer's w2, or one 128-column
   tile of it, from the next layer) must score above each bound. The whole
   120-layer frame is chaotic under such jumps: its error is printed, not
   held; two frames must give equal bits (each column is summed in one
   order). Then ms per frame and effective GB/s through the probe's own
   `_bench`, and, timed alike, the frame's grid barriers alone and its
   weight stream alone (`part_ms`).

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


def _device_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls (`fn(i)`) captured in one CUDA
    graph, its replay timed with CUDA events, best of three replays. The
    wrappers' host cost (checks, allocation, the ctypes call) is left out,
    and the capture shows that `fn` runs under a CUDA graph."""
    import torch

    fn(0)  # built, scratch made, library plans chosen before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def _library_ms(fn, iters: int) -> float:
    """The library call's time: the best of three `_time_ms` runs, so that
    its first calls on a new shape (plan and workspace set-up) do not count."""
    return min(_time_ms(fn, iters) for _ in range(3))


def _in_turns(plain, kernel, iters):
    """Times (plain, kernel, kernel, plain); returns the two means in ms."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, dense bf16 and int8
# on the tensor cores, fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12


def _bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _sdpa(q, k, v, mask, causal, **kw):
    """SDPA over (B, H, T, D) with GQA: `is_causal` where the mask is plain
    causal (its flash kernel takes that case, not a mask tensor), else the
    explicit boolean mask."""
    import torch.nn.functional as F

    if causal:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True, **kw)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True, **kw)


def _ms_text(ms):
    """A time in ms, or in us where it is under 1 us (bounds of the decode
    and fast-stack cases)."""
    return f"{ms * 1e3:.4f}us" if ms < 1e-3 else f"{ms:.4f}ms"


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def kernel_cases(dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

    import torch.nn.functional as F

    from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                        flash_decode_reference)
    from fish_speech_tpu_torch.ops.flash_prefill import _route as flash_prefill_route
    from fish_speech_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    cases = {"flash_prefill": [], "flash_prefill_fp32": [], "flash_decode": []}
    # prefill: flagship heads (H=32, Hkv=8, D=128), prompt buckets, bf16
    # (the tensor-core route); the fp32 route (CUDA cores, the tiny fp32
    # models of phases 3 and 3c) once at a small shape, to fp32's 1e-4
    for b, t, offsets, dtype in [(1, 64, [0], torch.bfloat16),
                                 (1, 1024, [0], torch.bfloat16),
                                 (2, 600, [0, 129], torch.bfloat16),
                                 (1, 4096, [0], torch.bfloat16),
                                 (1, 256, [0], torch.float32)]:
        q, k, v = (randn(b, t, n, 128).to(dtype) for n in (32, 8, 8))
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        route = flash_prefill_route(dtype)
        got = flash_prefill_attention(q, k, v, off)
        want = flash_prefill_reference(q, k, v, off)
        mx, mean = _errors(got, want)
        iters = 5 if t == 4096 else 20
        ms, plain_ms = _in_turns(lambda i=0: flash_prefill_reference(q, k, v, off),
                                 lambda i=0: flash_prefill_attention(q, k, v, off),
                                 iters)
        pairs = sum((t - o) * (t - o + 1) // 2 for o in offsets)
        flops = 4 * 32 * 128 * pairs
        bound = _bound(flops, q.element_size() * b * t * 128 * 2 * (32 + 8),
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        # SDPA on the same function: is_causal where every offset is 0, else
        # the causal, offset mask
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] >= off[:, None, None]))[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        causal = not any(offsets)
        lib = _library_ms(lambda i=0: _sdpa(qt, kt, vt, mask, causal), iters)
        fp32 = dtype == torch.float32
        cases["flash_prefill_fp32" if fp32 else "flash_prefill"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 offsets={offsets} "
                  f"{str(dtype)[6:]} {route} ({flops / ms / 1e9:.1f} TFLOP/s; "
                  f"SDPA {'is_causal' if causal else 'mask'})",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            tflop_s=flops / ms / 1e9,
            ok=mx <= 1e-4 if fp32 else mx <= 2e-2 and mean <= 2e-3))
        del q, k, v, got, want, mask
    # decode: slow cache (36 layers, S = 2048 + 64 is the serving session's;
    # 4160 the 4096-context one) and fast cache (12 layers, S = 10
    # codebooks). Each timed launch reads the next layer, as the decode loop
    # does, so the cache is not served from L2. `device_ms` and
    # `library_device_ms` time the same calls replayed from a CUDA graph.
    for n_layer, s, hkv, g, length in [(36, 4160, 8, 4, 1), (36, 4160, 8, 4, 257),
                                       (36, 2112, 8, 4, 2048),
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

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        lib = _time_ms(sdpa, 100)
        cases["flash_decode"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D=128 len={length}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            device_ms=_device_ms(lambda i=0: flash_decode_attention(
                q, kc, vc, i % n_layer, lens), 100),
            library_device_ms=_device_ms(sdpa, 100)))
        del kc, vc
    # the fp32 route (CUDA cores) at the caches of phase 3's tiny fp32 model:
    # the slow one (2 layers, S = 256 + 8, Hkv=2 G=2 D=64) and the fast one
    # (S = 10 codebooks, Hkv=1 G=3), to fp32's 1e-4
    cases["flash_decode_fp32"] = []
    for n_layer, s, hkv, g, length in [(2, 264, 2, 2, 100), (2, 10, 1, 3, 10)]:
        q = randn(1, hkv, g, 64).float()
        kc, vc = (randn(n_layer, 1, s, hkv, 64).float() for _ in range(2))
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        mx, mean = _errors(flash_decode_attention(q, kc, vc, 1, lens),
                           flash_decode_reference(q, kc, vc, 1, lens))
        ms, plain_ms = _in_turns(
            lambda i=0: flash_decode_reference(q, kc, vc, i % n_layer, lens),
            lambda i=0: flash_decode_attention(q, kc, vc, i % n_layer, lens),
            100)
        bound = _bound(4 * hkv * g * 64 * length,
                       4 * (2 * length * hkv * 64 + 2 * hkv * g * 64), PEAK_FP32)
        qs = q.reshape(1, hkv * g, 1, 64)

        def sdpa(i=0):
            return F.scaled_dot_product_attention(
                qs, kc[i % n_layer, :, :length].transpose(1, 2),
                vc[i % n_layer, :, :length].transpose(1, 2), enable_gqa=True)

        cases["flash_decode_fp32"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D=64 len={length} fp32",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=_time_ms(sdpa, 100),
            device_ms=_device_ms(lambda i=0: flash_decode_attention(
                q, kc, vc, i % n_layer, lens), 100),
            library_device_ms=_device_ms(sdpa, 100), ok=mx <= 1e-4))
    cases.update(train_kernel_cases(dev, randn))
    cases.update(quant_kernel_cases(dev, randn))
    torch.cuda.synchronize()
    for name, rows in cases.items():
        for r in rows:
            lib = r.get("library_ms")
            print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
                  f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound={_ms_text(r['bound_ms'])} "
                  f"({r['bound_by']}) library_ms="
                  + ("null" if lib is None else f"{lib:.4f}")
                  + (f" library_causal_ms={r['library_causal_ms']:.4f}"
                     if "library_causal_ms" in r else "")
                  + (f" device_ms={r['device_ms']:.4f} library_device_ms="
                     f"{r['library_device_ms']:.4f} wrapper_host_ms="
                     f"{max(0.0, r['ms'] - r['device_ms']):.4f}"
                     if "device_ms" in r else "")
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
    the value (2^-7 |O|) elementwise and 2e-3 mean abs (the tensor-core
    kernel rounds the unnormalised P to bf16, the plain version the
    normalised one; rows with few visible keys have |O| above 2, where the
    two roundings can land one step apart); lse, fp32 on both sides, to
    1e-4; the fp32 route's O to 1e-4; dQ, dK and dV, which are not convex
    combinations, to 2e-2 of the tensor's largest magnitude (max) and 1e-2
    of its mean magnitude (mean): one bf16 rounding of the output, plus the
    plain version's bf16 rounding of P and dS."""
    import torch

    from fish_speech_tpu_torch.ops.flash_train import _route as flash_train_route
    from fish_speech_tpu_torch.ops.flash_train import (
        flash_train_backward, flash_train_backward_reference, flash_train_forward,
        flash_train_forward_reference)

    cases = {"flash_train_fwd": [], "flash_train_fwd_fp32": [],
             "flash_train_bwd": [], "flash_train_bwd_fp32": []}
    # the fine-tune shape with a right-padded row, the default max_length,
    # and a ragged T (not a multiple of the 64-row tile), in bf16 (the
    # forward's tensor-core route); the forward's fp32 route (CUDA cores,
    # the tiny fp32 model of phase 3b) once at a small shape, to 1e-4
    for b, t, pads, dtype in [(2, 1024, [0, 100], torch.bfloat16),
                              (1, 4096, [0], torch.bfloat16),
                              (2, 1000, [0, 0], torch.bfloat16),
                              (2, 256, [0, 30], torch.float32)]:
        q, k, v = (randn(b, t, n, 128).to(dtype) for n in (32, 8, 8))
        kvalid = torch.ones((b, t), dtype=torch.int32, device=dev)
        for i, n in enumerate(pads):
            if n:
                kvalid[i, -n:] = 0
        do = randn(b, t, 32, 128).to(dtype) * kvalid[:, :, None, None].to(dtype)
        fp32 = dtype == torch.float32
        route = flash_train_route(dtype)
        # visible (query, key) pairs: causal and key-valid
        pairs = sum((t - n) * (t - n + 1) // 2 + n * (t - n) for n in pads)
        flops = 4 * 32 * 128 * pairs

        o, lse = flash_train_forward(q, k, v, kvalid)
        want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
        e_o, e_lse = _errors(o, want_o), _errors(lse, want_lse)
        ms, plain_ms = _in_turns(
            lambda i=0: flash_train_forward_reference(q, k, v, kvalid),
            lambda i=0: flash_train_forward(q, k, v, kvalid), 10)
        shape = (f"B={b} T={t} H=32 Hkv=8 D=128 right_pad={pads} "
                 f"{str(dtype)[6:]} {route} ({flops / ms / 1e9:.1f} TFLOP/s)")
        io_bytes = q.element_size() * b * t * 128 * (32 + 8)  # q, o | k, v
        fwd_bound = _bound(flops, 2 * io_bytes + 4 * b * 32 * t,
                           PEAK_FP32 if fp32 else PEAK_BF16)
        # inputs q, k, v, O, dO, lse and kvalid once, dQ, dK and dV once
        bwd_bytes = (q.element_size() * b * t * 128 * (4 * 32 + 4 * 8)
                     + 4 * b * 32 * t + 4 * b * t)
        bwd_bound = _bound(10 * 32 * 128 * pairs, bwd_bytes,
                           PEAK_FP32 if fp32 else PEAK_BF16)
        # SDPA on the same function: is_causal where no key is padded, else
        # the causal, key-valid mask; a padded case also times is_causal,
        # which gives the same O on every row that is not padding
        i = torch.arange(t, device=dev)
        mask = ((i[None, :] <= i[:, None])[None]
                & kvalid[:, None, :].bool())[:, None]
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        causal = not any(pads)
        shape += f"; SDPA {'is_causal' if causal else 'mask'}"

        def sdpa_fwd(i=0, causal=causal):
            return _sdpa(qt, kt, vt, mask, causal)

        def sdpa_fwd_bwd(i=0, causal=causal):
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            out = _sdpa(*leaves, mask, causal)
            return torch.autograd.grad(out, leaves, dot)

        lib_fwd = _library_ms(sdpa_fwd, 10)
        extra = {} if causal else {
            "library_causal_ms": _library_ms(lambda i=0: sdpa_fwd(causal=True), 10)}
        cases["flash_train_fwd_fp32" if fp32 else "flash_train_fwd"].append(dict(
            shape=shape, max_abs_err=max(e_o[0], e_lse[0]),
            mean_abs_err=max(e_o[1], e_lse[1]), ms=ms, plain_ms=plain_ms,
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
            **extra,
            outputs={"O": e_o, "lse": e_lse}, tflop_s=flops / ms / 1e9,
            ok=(e_o[0] <= 1e-4 if fp32 else _within_bf16_step(o, want_o)
                and e_o[1] <= 2e-3) and e_lse[0] <= 1e-4))
        # the backward: SDPA forward+backward minus its forward, on the same
        # mask (and is_causal beside it where a key is padded)
        lib_bwd = _library_ms(sdpa_fwd_bwd, 5) - lib_fwd
        if not causal:
            extra = {"library_causal_ms": _library_ms(
                lambda i=0: sdpa_fwd_bwd(causal=True), 5) - extra["library_causal_ms"]}
        args = (q, k, v, kvalid, want_o, want_lse, do)
        n_route = getattr(flash_train_backward, f"launches_{route}")
        got = flash_train_backward(*args)
        ran = getattr(flash_train_backward, f"launches_{route}") == n_route + 1
        want = flash_train_backward_reference(*args)
        errs, ok = {}, ran
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            errs[name] = _errors(g, w)
            ref = w.float().abs()
            ok &= bool(torch.isfinite(g.float()).all())
            if fp32:  # only the order of the fp32 sums differs
                ok &= errs[name][0] <= 1e-4 * max(1.0, ref.max().item())
            else:
                ok &= (errs[name][0] <= 2e-2 * ref.max().item()
                       and errs[name][1] <= 1e-2 * ref.mean().item())
        ms, plain_ms = _in_turns(lambda i=0: flash_train_backward_reference(*args),
                                 lambda i=0: flash_train_backward(*args), 5)
        # TFLOP/s on the minimal five products (S, dP, dV, dK, dQ) a pair
        bwd_flops = 10 * 32 * 128 * pairs
        cases["flash_train_bwd_fp32" if fp32 else "flash_train_bwd"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 right_pad={pads} "
                  f"{str(dtype)[6:]} {route} ({bwd_flops / ms / 1e9:.1f} TFLOP/s "
                  f"on five products; SDPA {'is_causal' if causal else 'mask'})",
            max_abs_err=max(e[0] for e in errs.values()),
            mean_abs_err=max(e[1] for e in errs.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=lib_bwd, **extra, outputs=errs,
            tflop_s=bwd_flops / ms / 1e9, ok=ok))
        del q, k, v, do, o, lse, want_o, want_lse, got, want, args
    torch.cuda.empty_cache()
    return cases


L2_COLD_BYTES = 100_000_000  # twice the H100's 50 MB L2

# s2-pro's int4 weights, I -> O (w13 fused): slow stack, then fast stack
INT4_SHAPES = [("slow wqkv", 2560, 6144), ("slow wo", 4096, 2560),
               ("slow w13", 2560, 19456), ("slow w2", 9728, 2560),
               ("fast wqkv", 1536, 2560), ("fast wo", 1536, 1536),
               ("fast w13", 1536, 12288), ("fast w2", 6144, 1536)]


def quant_kernel_cases(dev, randn):
    """The int4 matmul's routes and the int8-KV decode kernel against their
    plain versions at the quantized serving path's shapes: the matvec route
    at the eight decode shapes (B=1); the tensor-core route at the slow
    stack's four shapes at B=128 (the short prompt's bucket) and B=1024
    (the long one's), and at a ragged (1000, 384, 200, g=64); the matvec's
    fp32 route at phase 3c's tiny shapes; the int8-KV decode at the slow
    caches (bf16) and phase 3c's tiny one (fp32)."""
    import torch
    import torch.nn.functional as F

    from fish_speech_tpu_torch.models.dual_ar import _kv_dequant, _kv_quant
    from fish_speech_tpu_torch.ops.flash_decode import (
        flash_decode_attention_kv8, flash_decode_kv8_reference)
    from fish_speech_tpu_torch.ops.int4 import (_route, int4_dequant_bf16,
                                                 int4_matmul,
                                                 int4_matmul_bf16w_reference,
                                                 int4_matmul_reference)
    from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight,
                                                 quantize_int4)

    cases = {"int4_mm": [], "int4_mm_wgmma": [], "flash_decode_kv8": []}
    slow = INT4_SHAPES[:4]
    shapes = ([(1, *s, 128) for s in INT4_SHAPES]
              + [(b, *s, 128) for b in (128, 1024) for s in slow]
              + [(1000, "ragged", 384, 200, 64)])
    for b, name, i, o, g in shapes:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=g)
        p, gs = qw["p"], qw["gs"]
        x = randn(b, i)
        route = _route(b, x.dtype)
        got = int4_matmul(x, p, gs).float()
        want = int4_matmul_reference(x, p, gs).float()
        scale = x.float().abs() @ _int4_effective_weight(qw, torch.float32).abs()
        # every route: one bf16 rounding of W and of y against the fp32 W
        ok = bool(((got - want).abs() <= 2.0 ** -8 * (scale + want.abs())).all())
        if route == "wgmma":
            # the Pallas kernel's bf16 W, summed in fp32: one rounding of y
            # plus the order of the sums
            plain = int4_matmul_bf16w_reference
            w_lib = int4_dequant_bf16(p, gs)
            exact = plain(x.float(), p, gs)
            err = (got - exact).abs()
            ok &= bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all())
            del exact
        else:
            plain = int4_matmul_reference
            w_lib = _int4_effective_weight(qw, torch.bfloat16)
            err = (got - want).abs()
        del got, want, scale
        iters = 200 if b == 1 else 20
        ms, plain_ms = _in_turns(lambda k=0: plain(x, p, gs),
                                 lambda k=0: int4_matmul(x, p, gs), iters)
        lib = _time_ms(lambda k=0: x @ w_lib, iters)
        flops = 2 * b * i * o
        bound = _bound(flops, i // 2 * o + 4 * (i // g) * o + 2 * b * (i + o))
        tflops = flops / ms / 1e9
        device = {}
        if route == "gemv":
            # device time with the weights read cold, as the decode loop reads
            # each layer's own: the graph walks copies of (p, gs), and cuBLAS
            # copies of its bf16 W, over at least twice the 50 MB L2
            n_q = -(-L2_COLD_BYTES // (p.numel() + 4 * gs.numel()))
            n_w = -(-L2_COLD_BYTES // (2 * i * o))
            qs = [(p.clone(), gs.clone()) for _ in range(n_q)]
            ws = [w_lib.clone() for _ in range(n_w)]
            device = dict(
                device_ms=_device_ms(lambda k=0: int4_matmul(x, *qs[k % n_q]), iters),
                library_device_ms=_device_ms(lambda k=0: x @ ws[k % n_w], iters),
                weight_copies=[n_q, n_w])
            del qs, ws
        cases["int4_mm_wgmma" if route == "wgmma" else "int4_mm"].append(dict(
            shape=f"{name} B={b} I={i} O={o} g={g} ({tflops:.1f} TFLOP/s)",
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), ms=ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=lib, tflop_s=tflops, ok=ok, **device))
        del qw, p, gs, x, w_lib, err
    # the int4 matvec's fp32 route (`int4_gemv_kernel`) at the fast-stack
    # shapes of phase 3c's tiny model (fast dim 32, 3 x 64 q, 64 x 2 kv,
    # ffn 64), held to 1e-5 of |x| @ |W| (the order of the fp32 sums)
    cases["int4_mm_fp32"] = []
    for name, i, o, g in [("tiny fast wqkv", 32, 320, 16), ("tiny fast wo", 192, 32, 32),
                          ("tiny fast w13", 32, 128, 16), ("tiny fast w2", 64, 32, 32)]:
        qw = quantize_int4(randn(i, o).float() * 0.02, group_size=g)
        p, gs = qw["p"], qw["gs"]
        x = randn(1, i).float()
        w_lib = _int4_effective_weight(qw, torch.float32)
        err = (int4_matmul(x, p, gs) - int4_matmul_reference(x, p, gs)).abs()
        scale = x.abs() @ w_lib.abs()
        ms, plain_ms = _in_turns(lambda k=0: int4_matmul_reference(x, p, gs),
                                 lambda k=0: int4_matmul(x, p, gs), 200)
        bound = _bound(2 * i * o, i // 2 * o + 4 * (i // g) * o + 4 * (i + o),
                       PEAK_FP32)
        cases["int4_mm_fp32"].append(dict(
            shape=f"{name} B=1 I={i} O={o} g={g} fp32", max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_time_ms(lambda k=0: x @ w_lib, 200),
            device_ms=_device_ms(lambda k=0: int4_matmul(x, p, gs), 200),
            library_device_ms=_device_ms(lambda k=0: x @ w_lib, 200),
            ok=bool((err <= 1e-5 * scale + 1e-6).all())))
    # the int8 cache of the serving session (36 layers, S = 2048 + 64) and
    # of the 4096-context one (S = 4096 + 64); each timed call reads the
    # next layer, `device_ms` / `library_device_ms` from a CUDA-graph replay
    # as for the decode rows. Then the fp32 route (CUDA cores) at phase 3c's
    # tiny cache (2 layers, S = 264, Hkv=2 G=2 D=64), to fp32's 1e-4.
    hkv, grp = 8, 4
    for n_layer, s, lengths, d, dtype in [
            (36, 2112, (1, 257, 1100, 2048), 128, torch.bfloat16),
            (36, 4160, (4000,), 128, torch.bfloat16),
            (2, 264, (100,), 64, torch.float32)]:
        h, gq = (hkv, grp) if d == 128 else (2, 2)
        kq, ks = _kv_quant(randn(n_layer, 1, s, h, d))
        vq, vs = _kv_quant(randn(n_layer, 1, s, h, d))
        for length in lengths:
            q = randn(1, h, gq, d).to(dtype)
            lens = torch.tensor([length], dtype=torch.int32, device=dev)
            mx = mean = 0.0
            for layer in (0, n_layer - 1):
                e = _errors(flash_decode_attention_kv8(q, kq, ks, vq, vs, layer, lens),
                            flash_decode_kv8_reference(q, kq, ks, vq, vs, layer, lens))
                mx, mean = max(mx, e[0]), max(mean, e[1])

            def kernel(k=0):
                return flash_decode_attention_kv8(q, kq, ks, vq, vs, k % n_layer, lens)

            ms, plain_ms = _in_turns(
                lambda k=0: flash_decode_kv8_reference(q, kq, ks, vq, vs,
                                                       k % n_layer, lens),
                kernel, 100)
            # SDPA over the same cache dequantized to q's dtype beforehand
            kd = _kv_dequant(kq[:, :, :length], ks[:, :, :length], dtype)
            vd = _kv_dequant(vq[:, :, :length], vs[:, :, :length], dtype)
            qs = q.reshape(1, h * gq, 1, d)

            def sdpa(k=0):
                return F.scaled_dot_product_attention(
                    qs, kd[k % n_layer].transpose(1, 2),
                    vd[k % n_layer].transpose(1, 2), enable_gqa=True)

            lib = _time_ms(sdpa, 100)
            device = dict(device_ms=_device_ms(kernel, 100),
                          library_device_ms=_device_ms(sdpa, 100))
            del kd, vd
            bound = _bound(4 * h * gq * d * length,
                           2 * length * h * d + 2 * 2 * length * h
                           + 2 * q.element_size() * h * gq * d,
                           PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
            fp32 = dtype == torch.float32
            cases["flash_decode_kv8"].append(dict(
                shape=f"L={n_layer} B=1 S={s} Hkv={h} G={gq} D={d} len={length} "
                      f"int8 K/V {str(dtype)[6:]}", max_abs_err=mx,
                mean_abs_err=mean, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib,
                ok=mx <= 1e-4 if fp32 else mx <= 2e-2 and mean <= 2e-3, **device))
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


def _recording_engine(session, tokenizer, codec, dac_cfg, references_dir="references"):
    """A `TTSInferenceEngine` that keeps the codes of the last decoded
    segment, for the repeat check, and the host seconds of each codec
    decode and reference encode (`load_audio` and the codec's encode);
    both end in a host copy, so each is the call's whole time."""
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine

    class RecordingEngine(TTSInferenceEngine):
        def __init__(self, *args):
            super().__init__(*args)
            self.encode_seconds = []
            self.decode_seconds = []

        def decode_vq_tokens(self, codes):
            self.last_codes = np.array(codes)
            t0 = time.perf_counter()
            out = super().decode_vq_tokens(codes)
            self.decode_seconds.append(time.perf_counter() - t0)
            return out

        def encode_references_batch(self, audios):
            t0 = time.perf_counter()
            out = super().encode_references_batch(audios)
            self.encode_seconds.append(time.perf_counter() - t0)
            return out

    return RecordingEngine(session, tokenizer, codec, dac_cfg, references_dir)


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
        engine.decode_seconds.clear()
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
                   wall_s=t_last - t_start,
                   codec_s=[round(x, 4) for x in engine.decode_seconds])
        results.append(row)
        print(f"{label} request {name}: text {row['text_bytes']} bytes "
              f"(~{prompt_len} text tokens), TTFA {row['ttfa_s'] * 1e3:.1f} ms, "
              f"{frames} frames in {n_seg} segments, decode "
              f"{row['decode_frames_per_s']:.2f} frames/s, {samples} samples, "
              f"wall {row['wall_s']:.2f}s; codec decodes (host s each, "
              f"replay + copy) {row['codec_s']}")
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


def _prompt_len(tokenizer, cfg, text, prompt_text=None, prompt_tokens=None):
    """The prompt length of a request's (only) text batch, built as
    `generate_long` builds it (with a voice-clone prompt of reference
    texts and codes, if given)."""
    from fish_speech_tpu_torch.generate import build_base_conversation, encode_turn

    return encode_turn(build_base_conversation(prompt_text, prompt_tokens), text,
                       tokenizer, cfg.num_codebooks).shape[1]


def precompile_for(session, tokenizer, requests, label):
    """Capture the graphs of `requests` before they are measured, as the
    JAX server's `warm_up` compiles; prints the capture seconds and pool."""
    times = {}
    for t in sorted({_prompt_len(tokenizer, session.cfg, req.text)
                     for _, req in requests}):
        times.update(session.precompile(t, requests[0][1].max_new_tokens,
                                        session.first_chunk_size))
    print(f"{label} graphs captured (s, each with its eager run): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; graph pool {session.pool_bytes / 2**20:.1f} MiB")
    session.replays.clear()
    session.eager_runs.clear()
    return times


def precompile_codec(engine, code_buckets, reference_buckets, label):
    """Capture the codec graphs the timed requests reach, before them (the
    engine's `precompile`); prints the capture seconds and the codec pool,
    then clears the codec's replay and eager-run counts."""
    times, grown = {}, {}
    for kind, buckets in (("code", code_buckets), ("reference", reference_buckets)):
        for b in buckets:  # one graph a call, to read each one's pool growth
            before = engine.codec_pool_bytes
            new = engine.precompile(**{f"{kind}_buckets": (b,)})
            times.update(new)
            grown.update({k: (engine.codec_pool_bytes - before) / 2**20 for k in new})
    print(f"{label} codec graphs captured by engine.precompile (s, each with its "
          f"eager run; the pool's growth in MiB): "
          + ", ".join(f"{k} {v:.3f} s +{grown[k]:.1f}" for k, v in times.items())
          + f"; codec graph pool {engine.codec_pool_bytes / 2**20:.1f} MiB")
    engine.codec_replays.clear()
    engine.codec_eager_runs.clear()
    return times


def check_codec_replayed(engine, kinds, label):
    """Every codec call of the measured requests was a graph replay (no
    codec body ran eagerly on the card), and each kind in `kinds` replayed."""
    print(f"{label}: codec graph replays {dict(engine.codec_replays)}; codec "
          f"eager body runs {dict(engine.codec_eager_runs)}")
    replayed = {k[0] for k, n in engine.codec_replays.items() if n > 0}
    if engine.codec_eager_runs or not set(kinds) <= replayed:
        raise SystemExit(f"{label}: a codec body ran eagerly on the card, or "
                         f"the codec's {kinds} graphs never replayed")


def codec_device_ms(engine, key, n):
    """Device ms of one replay of codec graph `key`: n replays between CUDA
    events, after one untimed (not counted as the engine's replays)."""
    import torch

    graph = engine.codec_graphs[key].graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def eager_peak_mib(engine, key):
    """MiB above the allocation before it that an eager run of codec graph
    `key`'s body peaks at (its live temporaries), to set beside the pool
    its capture grew."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        engine._codec_body(key)()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def print_codec_ms(engine, label, reps=10):
    """The codec's device ms per replay for each (rows, bucket) a timed
    request reached, and each body's eager peak of live temporaries."""
    out = {}
    for key in sorted(engine.codec_replays):
        out[key] = codec_device_ms(engine, key, reps)
    peaks = {key: eager_peak_mib(engine, key) for key in out}
    print(f"{label} codec device ms per replay (CUDA events, {reps} replays): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + "; eager peak of each body's temporaries (MiB): "
          + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return out


def replayed_step_ms(session, n=64):
    """Device ms of one decode step: n replays of the step graph (one
    chunk: its uniforms, the replays, the copy of its columns) between CUDA
    events, after one such chunk untimed."""
    import torch

    gen = session.new_generator(0)
    session.decode_chunk(n, gen)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    session.decode_chunk(n, gen)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def check_replayed(session, label):
    """Every decode step of the measured requests was a graph replay: no
    eager body ran on the card, and the step graph replayed. Prints the
    replays and the launches one replayed step makes."""
    per_step = session.launches_per_replay("decode")
    print(f"{label}: graph replays {dict(session.replays)}; eager body runs "
          f"{dict(session.eager_runs)}; launches per replayed decode step "
          f"{per_step}")
    if session.eager_runs or session.replays["decode"] <= 0:
        raise SystemExit(f"{label}: a step ran eagerly on the card, or the "
                         f"decode graph never replayed")
    return per_step


# the eager session's figures that the replayed runs replace (earlier runs
# of this script, before the decode ran as CUDA graphs; NVIDIA H100 80GB
# HBM3, 700.00 W): decode frames/s and TTFA of the streamed requests
EAGER_FIGURES = {"bf16": "decode 4.31-6.38 frames/s, TTFA 173-253 ms",
                 "mixed": "decode 4.31-6.38 frames/s",
                 "int4": "TTFA 248.2-306.7 ms"}


# phase 4's requests decode at these code buckets: the first partial (the
# prefill's frame, then 9 frames after the first chunk of 8) and 72 frames
PHASE4_CODE_BUCKETS = (32, 128)


def run_slice(dev, tokenizer):
    """Phase 4: the full-width LM and codec answer streamed requests; then
    phase 4b, voice cloning, on the same model, session and engine."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig, dac_s2_pro
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention

    t0 = time.perf_counter()
    cfg = _s2_pro_cfg(tokenizer, 2048)
    dac_cfg = dac_s2_pro()
    if cfg.num_codebooks != dac_cfg.rvq.total_codebooks:
        raise SystemExit("LM and codec codebook counts differ")
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    n_params = dual_ar.param_count(params)
    codec = init_dac(1, dac_cfg, torch.float32, dev)
    session = GenerationSession(params, cfg, SamplingConfig(),
                                dtype=torch.bfloat16, decode_chunk_size=64,
                                first_chunk_size=8)
    del params  # the session holds the fused-FFN copy it decodes with
    refs_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_refs"
    engine = _recording_engine(session, tokenizer, codec, dac_cfg, str(refs_dir))
    torch.cuda.synchronize()
    print(f"slice: dual_ar_s2_pro {n_params / 1e9:.3f}B params bf16 "
          f"(max_seq_len 2048) + dac_s2_pro with its encoder "
          f"({_tree_bytes(codec) / 2**30:.2f} GiB fp32), built in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    precompile_for(session, tokenizer, _requests(), "bf16")
    precompile_codec(engine, PHASE4_CODE_BUCKETS, (), "bf16")
    _zero_counts()
    results = serve(dev, tokenizer, engine, _requests(), dac_cfg.frame_length,
                    "bf16")
    print("bf16 TTFA after precompile: first request "
          f"{results[0]['ttfa_s'] * 1e3:.1f} ms, the others "
          + " / ".join(f"{r['ttfa_s'] * 1e3:.1f}" for r in results[1:])
          + " ms (earlier runs of this script with the codec eager, NVIDIA "
          "H100 80GB HBM3, 700.00 W: first 424.1-573.3, warm 43.5-65.9)")
    launches = {"flash_prefill": flash_prefill_attention.launches_wgmma,
                "flash_decode": flash_decode_attention.launches}
    print(f"kernel launches on the engine path: {launches} (prefill on the "
          f"tensor-core route; all routes {flash_prefill_attention.launches})")
    if min(launches.values()) <= 0:
        raise SystemExit("a kernel of the path was never launched")
    check_replayed(session, "bf16")
    check_codec_replayed(engine, ("decode",), "bf16")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"(allocated; the graph pools' reserved memory aside)")
    print_codec_ms(engine, "bf16")
    step_ms = replayed_step_ms(session)
    print(f"bf16 replayed decode step: {step_ms:.3f} ms of device time "
          f"({1e3 / step_ms:.2f} steps/s; the eager session: "
          f"{EAGER_FIGURES['bf16']})")
    clone = run_clone(dev, tokenizer, session, engine, refs_dir)
    return results, launches, clone


CLONE_TEXT = ("A reference speaker reads a few calm sentences, so that the model "
              "can follow the voice, the pace and the tone of the recording.")


def _reference_clip(path, seconds=30.0, sr=24000, seed=21):
    """A ~30 s reference clip from a seed, written as 16-bit mono PCM at
    24 kHz (so `load_audio` resamples it to 44.1 kHz): a tone gliding
    around 140 Hz with its harmonics, in syllable-like bursts, and noise."""
    from fish_speech_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    bursts = 0.5 + 0.5 * np.sin(2 * np.pi * 3.7 * t + rng.uniform(0, 2 * np.pi))
    x = 0.25 * voice * bursts + 0.02 * rng.standard_normal(len(t))
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, x, sr)
    return path.read_bytes()


def run_clone(dev, tokenizer, session, engine, refs_dir):
    """Phase 4b: voice cloning on phase 4's model, session and engine: a
    ~30 s reference by id, by bytes, and by id again (the same seed)."""
    import shutil
    from types import SimpleNamespace

    import torch

    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.engine.tts import TTSRequest
    from fish_speech_tpu_torch.models.dac.model import dac_encode
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention

    cfg, dac_cfg = session.cfg, engine.codec_cfg
    frame = dac_cfg.frame_length
    shutil.rmtree(refs_dir, ignore_errors=True)
    clip = _reference_clip(refs_dir / "speaker" / "sample.wav")
    (refs_dir / "speaker" / "sample.lab").write_text(CLONE_TEXT)
    n_frames = -(-len(load_audio(clip, dac_cfg.sample_rate)) // frame)
    text = _requests()[0][1].text
    prompt_len = _prompt_len(tokenizer, cfg, text, [CLONE_TEXT],
                             [np.zeros((dac_cfg.rvq.total_codebooks, n_frames),
                                       np.int32)])
    bucket = session._bucket(prompt_len)
    print(f"clone reference: {len(clip)} bytes of 16-bit mono PCM at 24 kHz "
          f"(~30 s), {n_frames} frames at 44.1 kHz; transcript "
          f"{len(CLONE_TEXT)} bytes; prompt {prompt_len} tokens (prefill "
          f"bucket {bucket}) with phase 4's {len(text)}-byte short text")
    torch.cuda.reset_peak_memory_stats(dev)
    times = session.precompile(prompt_len, 72, session.first_chunk_size)
    print(f"clone session graphs captured (s): {times or 'none new'}")
    precompile_codec(engine, (), (n_frames,), "clone")
    session.replays.clear()
    session.eager_runs.clear()
    engine.encode_seconds.clear()
    _zero_counts()
    common = dict(text=text, streaming=True, max_new_tokens=72, seed=31)
    requests = [
        ("clone-id", TTSRequest(**common, reference_id="speaker",
                                use_memory_cache="on")),
        ("clone-bytes", TTSRequest(**common, references=[
            SimpleNamespace(audio=clip, text=CLONE_TEXT)])),
        ("clone-id-repeat", TTSRequest(**common, reference_id="speaker",
                                       use_memory_cache="on")),
    ]
    codes = {}
    rows = []
    for name, req in requests:
        rows += serve(dev, tokenizer, engine, [(name, req)], frame, "clone")
        codes[name] = engine.last_codes
    launches = {"flash_prefill": flash_prefill_attention.launches_wgmma,
                "flash_decode": flash_decode_attention.launches}
    encode_key = ("encode", 1, engine._code_bucket(n_frames))
    print(f"clone: reference load_audio + encode {engine.encode_seconds[0] * 1e3:.1f} "
          f"ms inside request clone-id's TTFA; VQ cache misses "
          f"{engine.vq_cache_misses}, hits {engine.vq_cache_hits}; prefill "
          f"graph replays {dict(session.replays)}; kernel launches {launches}")
    check_replayed(session, "clone")
    check_codec_replayed(engine, ("decode", "encode"), "clone")
    same = all(np.array_equal(codes["clone-id"], c) for c in codes.values())
    print(f"clone: codes of the three requests {codes['clone-id'].shape} "
          f"identical={same}")
    failures = [msg for bad, msg in (
        (engine.vq_cache_misses != 1 or engine.vq_cache_hits < 1,
         "the clip was not encoded exactly once"),
        (bucket != 1024 or session.replays[f"prefill_{bucket}"] != 3,
         "the prompts did not go through prefill_1024"),
        (min(launches.values()) <= 0, "a kernel of the path was never launched"),
        (engine.codec_replays[encode_key] < 1, "the encode graph never replayed"),
        (not same, "the same reference, text and seed gave different codes"))
        if bad]
    if failures:
        raise SystemExit(f"clone: {'; '.join(failures)}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    encode_ms = codec_device_ms(engine, encode_key, 5)
    step_ms = replayed_step_ms(session)
    print(f"clone: encode device ms per replay at {encode_key}: {encode_ms:.3f} "
          f"(its body's eager peak of temporaries "
          f"{eager_peak_mib(engine, encode_key):.1f} MiB); codec graph pool "
          f"{engine.codec_pool_bytes / 2**20:.1f} MiB; peak device memory over "
          f"the requests {peak:.2f} GiB; replayed decode step after them "
          f"{step_ms:.3f} ms of device time")

    # the replayed codes against eager runs of the same body on the card
    entry = engine.codec_graphs[encode_key]
    entry.graph.replay()
    replayed = entry.out.clone()
    with torch.no_grad():
        eager = dac_encode(engine.codec_params, dac_cfg, entry.inp)[0]
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            fp32 = dac_encode(engine.codec_params, dac_cfg, entry.inp)[0]
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    bitwise = torch.equal(replayed, eager)
    share = (replayed[0, :, :n_frames] == fp32[0, :, :n_frames]).float().mean(dim=1)
    print(f"clone encode check: replayed codes equal an eager run on the card "
          f"bit for bit: {bitwise}; share of codes equal to an eager run "
          f"without TF32 (cuDNN and matmul), per codebook over {n_frames} "
          f"frames: {[round(float(x), 4) for x in share]} (printed, not held)")
    if not bitwise:
        raise SystemExit("clone: the replayed encode differs from its eager body")
    return dict(rows=rows, encode_ms=encode_ms, encode_s=engine.encode_seconds[0],
                prompt_len=prompt_len)


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _fast_stack_frame(session):
    """One frame of the serving path's fast stack: `_sample_column` (project
    in, NC fast steps with their heads and samplers, one top-k of the slow
    head) on a random hidden state, reading the session's fixed buffers."""
    import torch

    from fish_speech_tpu_torch.generate import _sample_column

    cfg, dev, st = session.cfg, session.device, session.state
    gen = torch.Generator(device=dev).manual_seed(0)
    hidden = torch.randn((1, cfg.dim), generator=gen, device=dev,
                         dtype=session.params["embeddings"].dtype)
    logits = torch.randn((1, cfg.semantic_end_id - cfg.semantic_begin_id + 2),
                         generator=gen, device=dev)
    u = st.u[0].uniform_(generator=gen).clamp_(min=1e-30)

    def frame(i=0):
        return _sample_column(session.params, cfg, session.scfg, logits, hidden,
                              None, u, st.sampling_args(), st.fast_cache)

    return frame


def fast_stack_frame_ms(session, frames=20):
    """The serving path's fast stack per frame, run eagerly: CUDA events
    over `frames` frames."""
    return _time_ms(_fast_stack_frame(session), frames)


def fast_stack_replayed_ms(session, frames=20):
    """The same frame captured in a CUDA graph: CUDA events over `frames`
    replays."""
    import torch

    frame = _fast_stack_frame(session)
    frame()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        frame()
    ms = _time_ms(lambda i=0: graph.replay(), frames)
    del graph
    return ms


# the serving fast stack per frame in three earlier runs of this script
# with the two-launch int4 matvec (NVIDIA H100 80GB HBM3, 700.00 W)
TWO_LAUNCH_FAST_STACK_MS = {"mixed": "159.234 / 172.634 / 174.479",
                            "int4": "161.277 / 155.006 / 261.142"}


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
    wrappers = {"flash_decode_kv8": flash_decode_attention_kv8}
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
        served = [(n, requests[n]) for n in names]
        precompile_for(session, tokenizer, served, label)
        precompile_codec(engine, PHASE4_CODE_BUCKETS, (), label)
        _zero_counts()
        rows = serve(dev, tokenizer, engine, served, dac_cfg.frame_length, label)
        # the int4 matmul's routes: matvec (decode), tensor cores (bf16
        # prefill); the fp32 tiled route serves no bf16 model
        launches = dict(_counted(wrappers),
                        flash_prefill=flash_prefill_attention.launches_wgmma,
                        int4_mm=int4_matmul.launches_gemv,
                        int4_mm_wgmma=int4_matmul.launches_wgmma,
                        int4_mm_fp32_tiled=int4_matmul.launches_fp32_tiled)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        per_step = check_replayed(session, label)
        check_codec_replayed(engine, ("decode",), label)
        step_ms = replayed_step_ms(session)
        fast_ms = fast_stack_frame_ms(session)
        fast_replayed_ms = fast_stack_replayed_ms(session)
        print(f"{label}: kernel launches {launches}; peak device memory "
              f"{peak:.2f} GiB; replayed decode step {step_ms:.3f} ms "
              f"({1e3 / step_ms:.2f} steps/s; the eager session: "
              f"{EAGER_FIGURES[label]}); serving fast stack "
              f"{fast_ms:.3f} ms/frame eager, {fast_replayed_ms:.3f} replayed "
              f"(_sample_column, CUDA events; eager with the two-launch "
              f"matvec: {TWO_LAUNCH_FAST_STACK_MS[label]} ms/frame)")
        # `mixed` keeps its slow stack int8, so only `int4` prefills in int4
        required = ["int4_mm", "flash_prefill", *wrappers] + (
            ["int4_mm_wgmma"] if label == "int4" else [])
        if min(launches[k] for k in required) <= 0:
            raise SystemExit(f"{label}: a kernel of the quantized path was never "
                             f"launched: {launches}")
        if label == "int4":
            ttfa_ms = rows[0]["ttfa_s"] * 1e3
            print(f"int4 700-byte request: TTFA {ttfa_ms:.1f} ms against the "
                  f"predicted 80-160 ms (the eager session: "
                  f"{EAGER_FIGURES['int4']}); tensor-core route launched "
                  f"{launches['int4_mm_wgmma']} times")
        out[label] = dict(rows=rows, launches=launches, peak_gib=peak,
                          weight_bytes=weight_bytes, fast_stack_ms=fast_ms,
                          step_ms=step_ms, launches_per_step=per_step)
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
        if not torch.equal(frame, again):  # each column summed in one order
            raise SystemExit(f"probe R={r} {variant}: two frames differ")
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
        # a frame's pieces alone (the same best of 3 x 30 frames)
        parts = {part: faststack.part_ms(part, r, variant, dims=dims,
                                         weights=weights, device=dev)
                 for part in ("barriers", "loads")}
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
                   effective_gb_s=traffic / ms / 1e6,
                   barriers_ms=parts["barriers"], loads_ms=parts["loads"])
        rows.append(row)
        steps_err = ", ".join(f"{d.steps} step(s) ({d.steps * d.n_layer} layers) "
                              f"{e.max().item():.3e} mean {e.mean().item():.3e}"
                              for d, e in zip(held, c["errs"]))
        print(f"probe R={r} {variant}: {ms:.4f} ms/frame, effective "
              f"{row['effective_gb_s']:.0f} GB/s over {traffic / 1e9:.3f} GB "
              f"(bound {row['bound_ms']:.4f} ms, {row['bound_by']}, "
              f"{row['bound_ms'] / ms:.1%} of it); its "
              f"{4 * dims.n_layer * dims.steps} grid barriers alone "
              f"{parts['barriers']:.4f} ms/frame, its weight stream alone "
              f"{parts['loads']:.4f} ms/frame; plain "
              f"{plain_ms:.2f} ms; max_abs_err at {steps_err} (bound "
              f"{tol[variant]:g}), max |out| {c['out_max']:.3f}; whole frame "
              f"({dims.steps * dims.n_layer} layers): max_abs_err "
              f"{c['frame_err']:.3e}, kernel run-to-run {c['spread']:.3e} "
              f"(equal bits required)")
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

    _zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.fit(itertools.repeat(batch, steps), resume=False)
    torch.cuda.synchronize()
    launches = {"flash_train_fwd": flash_train_forward.launches_wgmma,
                "flash_train_bwd": flash_train_backward.launches_wgmma}
    bwd_cuda_cores = flash_train_backward.launches_cuda_cores
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
          f"{step_tokens / steady:.0f} tokens/s (predicted 0.74-0.77 s/step, "
          f"about 2,650-2,770 tokens/s, with the tensor-core attention "
          f"forward; 0.8586-0.8709 s/step without); peak device memory "
          f"{peak:.2f} GiB; kernel launches {launches} (forward and backward "
          f"on the tensor-core route; all routes: forward "
          f"{flash_train_forward.launches}, backward "
          f"{flash_train_backward.launches})")

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
    # 36 layers, each backward once under remat, over 8 steps
    if launches["flash_train_bwd"] != 288 or bwd_cuda_cores:
        raise SystemExit(f"training: {launches['flash_train_bwd']} backward "
                         f"launches on the tensor-core route (want 288) and "
                         f"{bwd_cuda_cores} on the CUDA cores (want 0)")

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


def _zero_counts():
    """Set every kernel wrapper's launch counts to 0 (per route too)."""
    from fish_speech_tpu_torch.ops import flash_prefill, flash_train, int4

    for f in _kernel_wrappers():
        f.launches = 0
    for mod in (flash_prefill, flash_train, int4):
        mod.reset_launches()


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
    "flash_prefill": (SRC + "attn_wgmma.cuh",
                      "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_prefill_fp32": (SRC + "flash_prefill.cu",
                           "fish_speech_tpu/ops/pallas_attention.py:26"),
    "flash_decode": (SRC + "flash_decode.cu",
                     "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_decode_fp32": (SRC + "flash_decode.cu",
                          "fish_speech_tpu/ops/pallas_decode.py:47"),
    "flash_train_fwd": (SRC + "attn_wgmma.cuh",
                        "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    "flash_train_fwd_fp32": (SRC + "flash_train.cu",
                             "fish_speech_tpu/ops/pallas_attention_train.py:56"),
    "flash_train_bwd": (SRC + "attn_bwd_wgmma.cuh",
                        "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "flash_train_bwd_fp32": (SRC + "flash_train.cu",
                             "fish_speech_tpu/ops/pallas_attention_train.py:131"),
    "int4_mm": (SRC + "int4_mm.cu", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "int4_mm_wgmma": (SRC + "int4_mm.cu",
                      "fish_speech_tpu/ops/pallas_int4.py:32"),
    "int4_mm_fp32": (SRC + "int4_mm.cu", "fish_speech_tpu/ops/pallas_int4.py:32"),
    "flash_decode_kv8": (SRC + "flash_decode.cu",
                         "fish_speech_tpu/ops/attention.py:66"),
    "faststack_probe": (SRC + "faststack.cu",
                        "fish_speech_tpu/ops/pallas_faststack.py:136"),
}
# headline shapes: the long request's prefill bucket, a 257-long cache, the
# B=2 x T=1024 fine-tune shape, the slow w13 at B=1 (matvec route) and at
# B=1024 (tensor-core route), a 257-long int8 cache, the probe at R=0 in
# bf16; the fp32 attention routes' one small case each, the tiny slow
# cache and the tiny fast wqkv for the fp32 decode and matvec
HEADLINE = {"flash_prefill": 1, "flash_prefill_fp32": 0, "flash_decode": 1,
            "flash_decode_fp32": 0, "flash_train_fwd": 0, "flash_train_fwd_fp32": 0,
            "flash_train_bwd": 0, "flash_train_bwd_fp32": 0, "int4_mm": 2,
            "int4_mm_wgmma": 6, "int4_mm_fp32": 0, "flash_decode_kv8": 1,
            "faststack_probe": 0}
# the kernels whose SASS must hold HGMMA (wgmma) instructions
WGMMA_KERNELS = ("int4_wgmma_kernel", "train_fwd_wgmma_kernel",
                 "prefill_wgmma_kernel", "train_bwd_dkdv_wgmma_kernel",
                 "train_bwd_dq_wgmma_kernel")


def _ptxas_report(build_log):
    """Print ptxas' registers, shared memory and spills of the tensor-core
    kernels from the build's log."""
    name = None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in WGMMA_KERNELS if k in line), None)
            dims = "<64>" if "ILi64E" in line else "<128>" if "ILi128E" in line else ""
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {name}{dims}: {line.strip()}")
        if "C7513" in line:
            print(f"ptxas: {line.strip()}")


def _sass_hgmma(lib_path):
    """Count of HGMMA (wgmma) instructions per kernel in the built library's
    SASS, read with the toolkit's cuobjdump."""
    from fish_speech_tpu_torch.ops import _kernels

    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _bwd_occupancy():
    """Blocks per SM of the bf16 backward's two kernels at D = 64 and 128,
    from the CUDA occupancy calculator."""
    import ctypes

    from fish_speech_tpu_torch.ops import _kernels

    lib = _kernels.load_kernels()
    out = {}
    for d in (64, 128):
        dkdv, dq = ctypes.c_int(), ctypes.c_int()
        rc = lib.fs_flash_train_bwd_occupancy(d, ctypes.byref(dkdv), ctypes.byref(dq))
        _kernels.check_launch(rc, "fs_flash_train_bwd_occupancy")
        out[f"train_bwd_dkdv_wgmma_kernel<{d}>"] = dkdv.value
        out[f"train_bwd_dq_wgmma_kernel<{d}>"] = dq.value
    return out


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
    _ptxas_report(_kernels.library_path().parent / "build.log")
    sass = _sass_hgmma(_kernels.library_path())
    for name in WGMMA_KERNELS:
        hgmma = {k: n for k, n in sass.items() if name in k}
        print(f"HGMMA instructions in {name}'s SASS: {hgmma}")
        if not hgmma or min(hgmma.values()) <= 0:
            raise SystemExit(f"{name} issues no HGMMA")
    occupancy = _bwd_occupancy()
    print(f"blocks per SM of the training backward's kernels: {occupancy}")
    if min(occupancy.values()) <= 0:
        raise SystemExit("a training backward kernel fits no block on an SM")

    cases = kernel_cases(dev)
    tokenizer = build_test_tokenizer()
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from fish_speech_tpu_torch.ops.flash_train import (flash_train_backward,
                                                       flash_train_forward)
    from fish_speech_tpu_torch.ops.int4 import int4_matmul

    # the fp32 routes run in the tiny fp32 models' phases (phase 3's decode
    # is all fp32, so its launches are the fp32 route's)
    _zero_counts()
    small_reference(dev, tokenizer)
    fp32_launches = {"flash_prefill_fp32": flash_prefill_attention.launches_cuda_cores,
                     "flash_decode_fp32": flash_decode_attention.launches}
    _zero_counts()
    small_train_reference(dev, tokenizer)
    fp32_launches["flash_train_fwd_fp32"] = flash_train_forward.launches_cuda_cores
    fp32_launches["flash_train_bwd_fp32"] = flash_train_backward.launches_cuda_cores
    _zero_counts()
    small_quant_reference(dev, tokenizer)
    fp32_launches["int4_mm_fp32"] = int4_matmul.launches_gemv
    print(f"fp32 routes' launches in phases 3, 3b and 3c: {fp32_launches}")
    if min(fp32_launches.values()) <= 0:
        raise SystemExit("an fp32 route was never launched")
    _, launches, _ = run_slice(dev, tokenizer)
    gc.collect()  # the serving slice's model and caches go before training
    torch.cuda.empty_cache()
    train_launches = run_train_slice(
        dev, tokenizer, _s2_pro_cfg(tokenizer, 1024),
        Path(__file__).resolve().parent / "build" / "chip_smoke_train")
    launches.update(train_launches)
    launches.update(fp32_launches)
    gc.collect()  # the training model goes before quantized serving
    torch.cuda.empty_cache()
    quant = run_quant_slice(dev, tokenizer)
    launches["int4_mm"] = quant["mixed"]["launches"]["int4_mm"]
    launches["int4_mm_wgmma"] = quant["int4"]["launches"]["int4_mm_wgmma"]
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
