#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`fish_speech_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit if it fails:

1. the card (`nvidia-smi` name and power limit), torch and CUDA versions,
   and the build of the CUDA kernels from `fish_speech_tpu_torch/csrc/`;
2. each kernel against its plain PyTorch version at the main path's shapes,
   in bf16 from N(0,1) inputs (pass: max abs error <= 2e-2, mean <= 2e-3,
   the bound of bf16 rounding of P before P.V in the plain version), timed
   with CUDA events in turns (plain, kernel, kernel, plain);
3. a small-input reference: a tiny fp32 model runs the same greedy request
   through the kernels on the card and through the plain versions on the
   CPU; token columns must be identical and prefill logits within 1e-4;
4. the slice: the full-width `dual_ar_s2_pro` LM (bf16, random weights from
   a seed, max_seq_len 2048) and the `dac_s2_pro` codec answer streamed
   requests through `TTSInferenceEngine`, one of them with a prompt over 512
   tokens. The audio must be finite and in whole frames, both kernels'
   launch counts must be > 0, and a repeated request with the same seed
   must give identical codes.

The line before the last is a JSON object with each kernel's numbers; the
last line is `{"ok": true, "device": {...}}`. No result is printed when
CUDA is unavailable or when the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

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


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def kernel_cases(dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

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
        cases["flash_prefill"].append(dict(
            shape=f"B={b} T={t} H=32 Hkv=8 D=128 offsets={offsets}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms))
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
        cases["flash_decode"].append(dict(
            shape=f"L={n_layer} B=1 S={s} Hkv={hkv} G={g} D=128 len={length}",
            max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms))
        del kc, vc
    torch.cuda.synchronize()
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name} [{r['shape']}]: max_abs_err={r['max_abs_err']:.3e} "
                  f"mean_abs_err={r['mean_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f}")
            if r["max_abs_err"] > 2e-2 or r["mean_abs_err"] > 2e-3:
                raise SystemExit(f"{name} disagrees with its plain version at "
                                 f"{r['shape']}")
    return cases


def small_reference(dev, tokenizer):
    """Phase 3: a tiny fp32 model through the kernels (card) and the plain
    versions (CPU) on the same weights and request."""
    import torch

    from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar

    cfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size, head_dim=64,
                       n_head=4, n_local_heads=2, fast_head_dim=64,
                       fast_n_head=3, fast_n_local_heads=1, num_codebooks=10,
                       attention_qk_norm=True, tie_word_embeddings=False,
                       semantic_begin_id=tokenizer.semantic_begin_id,
                       semantic_end_id=tokenizer.semantic_end_id,
                       im_end_id=tokenizer.im_end_id)
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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run_slice(dev, tokenizer):
    """Phase 4: the full-width LM and codec answer streamed requests."""
    import torch

    from fish_speech_tpu.config import SamplingConfig, dac_s2_pro, dual_ar_s2_pro
    from fish_speech_tpu_torch.convert.from_jax import init_dac_decoder
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine, TTSRequest
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention
    from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention

    class RecordingEngine(TTSInferenceEngine):
        """Keeps the codes of the last decoded segment for the repeat check."""

        def decode_vq_tokens(self, codes):
            self.last_codes = np.array(codes)
            return super().decode_vq_tokens(codes)

    t0 = time.perf_counter()
    cfg = dual_ar_s2_pro(semantic_begin_id=tokenizer.semantic_begin_id,
                         semantic_end_id=tokenizer.semantic_end_id,
                         im_end_id=tokenizer.im_end_id)
    cfg = dataclasses.replace(cfg, max_seq_len=2048).resolve()
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
    engine = RecordingEngine(session, tokenizer, codec, dac_cfg)
    torch.cuda.synchronize()
    print(f"slice: dual_ar_s2_pro {n_params / 1e9:.3f}B params bf16 "
          f"(max_seq_len 2048) + dac_s2_pro, built in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    short = "Hello from the port. This is a short streamed request."
    long_text = ("The quick brown fox jumps over the lazy dog, and then it runs "
                 "back home before the rain. ") * 8
    long_text = long_text[:700]
    medium = ("Streaming speech synthesis sends the first audio while the "
              "rest is still being generated. ") * 3
    requests = [
        ("short", TTSRequest(text=short, streaming=True, max_new_tokens=96, seed=11)),
        ("long", TTSRequest(text=long_text, streaming=True, max_new_tokens=96,
                            seed=12, chunk_length=1000)),
        ("medium", TTSRequest(text=medium, streaming=True, max_new_tokens=96,
                              seed=13)),
        ("short-repeat", TTSRequest(text=short, streaming=True,
                                    max_new_tokens=96, seed=11)),
    ]
    frame = dac_cfg.frame_length
    flash_prefill_attention.launches = 0
    flash_decode_attention.launches = 0
    results, codes = [], {}
    for name, req in requests:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        t_first = t_last = None
        samples, n_seg = 0, 0
        for res in engine.inference(req):
            now = time.perf_counter()
            if res.code == "error":
                raise SystemExit(f"request {name} failed: {res.error!r}")
            if res.code == "segment":
                audio = res.audio[1]
                if len(audio) % frame or not np.isfinite(audio).all():
                    raise SystemExit(f"request {name}: a segment of {len(audio)} "
                                     f"samples is not whole finite frames")
                samples += len(audio)
                n_seg += 1
                t_first = t_first or now
                t_last = now
            if res.code == "final":
                if not np.isfinite(res.audio[1]).all() or len(res.audio[1]) != samples:
                    raise SystemExit(f"request {name}: bad final audio")
        frames = samples // frame
        if frames < 2 or t_first is None:
            raise SystemExit(f"request {name}: only {frames} frames")
        codes[name] = engine.last_codes
        prompt_len = len(tokenizer.encode(req.text))
        row = dict(request=name, text_bytes=len(req.text.encode()),
                   ttfa_s=t_first - t_start, frames=frames, segments=n_seg,
                   samples=samples,
                   decode_frames_per_s=(frames - 1) / (t_last - t_first),
                   wall_s=t_last - t_start)
        results.append(row)
        print(f"request {name}: text {row['text_bytes']} bytes (~{prompt_len} "
              f"text tokens), TTFA {row['ttfa_s'] * 1e3:.1f} ms, {frames} frames "
              f"in {n_seg} segments, decode {row['decode_frames_per_s']:.2f} "
              f"frames/s, {samples} samples, wall {row['wall_s']:.2f}s")
    torch.cuda.synchronize()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    print(f"kernel launches on the engine path: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit("a kernel of the path was never launched")
    same = np.array_equal(codes["short"], codes["short-repeat"])
    print(f"repeat with the same seed: codes {codes['short'].shape} identical={same}")
    if not same:
        raise SystemExit("the repeated request gave different codes")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return results, launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from fish_speech_tpu.tokenizer import build_test_tokenizer
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
    _, launches = run_slice(dev, tokenizer)

    replaces = {"flash_prefill": "fish_speech_tpu/ops/pallas_attention.py:26",
                "flash_decode": "fish_speech_tpu/ops/pallas_decode.py:47"}
    # headline shapes: the long request's prefill bucket, a 257-long cache
    headline = {"flash_prefill": 1, "flash_decode": 1}
    kernels = []
    for name, rows in cases.items():
        pick = rows[headline[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fish_speech_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "shape": pick["shape"], "cases": rows,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
