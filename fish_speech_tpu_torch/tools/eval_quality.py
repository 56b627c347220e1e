"""Quality-evaluation harness: manifest -> synthesize -> WER / speaker-SIM,
the port of `fish_speech_tpu/tools/eval_quality.py`.

The reference publishes its quality numbers as a benchmark table
(reference `README.md:92-101`: Seed-TTS Eval WER zh/en, speaker SIM,
...) but ships NO evaluation code. This harness is the in-repo gate those
numbers need the day real checkpoints exist: it drives the REAL serving
engine over a test manifest, scores word/
char error rate through a pluggable ASR hook and speaker similarity
through a pluggable embedding hook, runs opt-in-flag A/B comparisons
(int8 KV cache, voice-clone prefix cache) in one invocation, and emits
both machine-readable JSON and the reference's own markdown table format.

    python -m fish_speech_tpu_torch.tools.eval_quality \
        --checkpoint-path checkpoints/s2-pro \
        --manifest seed_tts_eval.jsonl --out-dir eval_out \
        --asr mypkg.asr:transcribe --ab kv-int8

Manifest: JSONL, one utterance per line:
    {"id": "en_0001", "text": "...", "lang": "en",
     "ref_audio": "spk1.wav", "ref_text": "...",    # optional voice clone
     "target": "..."}                               # ASR target (default: text)

ASR hook contract: `module:function`, called as fn(wav_path, lang) ->
transcript string. Speaker-SIM hook: fn(wav_path_a, wav_path_b) -> float
in [-1, 1]. Two built-ins ship for plumbing tests and as honest proxies:
  * --asr mock       echoes the target (WER 0; exercises the pipeline)
  * --sim spectral   cosine over log-mel statistics (a PROXY, labelled as
                     such in the output; real speaker-embedding models are
                     not bundled in this image)

This file is the documented gate for the opt-in serving flags: the int8-KV
and prefix-cache flags flip to default only when this harness shows WER /
SIM parity (<2% relative) on a real checkpoint (see PARITY.md "pending
real checkpoints").

It runs on `cuda:0` and fails where there is none; `--cpu` runs it on the
CPU. `--pool-size` > 1 (default 8) synthesizes through the continuous
batcher (`ContinuousBatcher` behind a `BatcherSession`), 1 through a
single-stream `GenerationSession`; `--int8` quantizes the weights as the
server does (`quantize_dual_ar_lowmem(mode="int8")`).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
import time
import types
import unicodedata
from pathlib import Path
from typing import Callable, Optional

import click
import numpy as np

# ---------------------------------------------------------------------------
# Text normalization + error rate (Seed-TTS-eval conventions: lowercase,
# strip punctuation; zh scores CER over chars, others WER over words)
# ---------------------------------------------------------------------------

_PUNCT = re.compile(r"[^\w\s]|_", re.UNICODE)


def normalize_text(text: str, lang: str = "en") -> list:
    text = unicodedata.normalize("NFKC", text).lower()
    text = _PUNCT.sub(" ", text)
    if lang.startswith("zh") or lang.startswith("ja"):
        return [c for c in text if not c.isspace()]
    return text.split()


def edit_distance(a: list, b: list) -> int:
    """Levenshtein distance (word- or char-level)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def error_rate(hyp: str, ref: str, lang: str = "en") -> float:
    h, r = normalize_text(hyp, lang), normalize_text(ref, lang)
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(h, r) / len(r)


# ---------------------------------------------------------------------------
# Pluggable hooks
# ---------------------------------------------------------------------------


def resolve_hook(spec: str) -> Callable:
    """'module.path:function' -> callable."""
    mod, fn = spec.split(":")
    return getattr(importlib.import_module(mod), fn)


def spectral_sim(wav_a, wav_b) -> float:
    """Log-mel statistics cosine — a PROXY for speaker similarity (mean +
    std of 64 mel bands; captures timbre envelope, not identity). Labelled
    `sim_metric: spectral_proxy` in the output so it is never confused
    with a real speaker-embedding SIM."""
    import torch

    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.audio.spectrogram import log_mel_spectrogram

    def embed(p):
        wav = load_audio(str(p), 16000)
        mel = log_mel_spectrogram(torch.from_numpy(wav[None]), sample_rate=16000,
                                  n_mels=64).numpy()[0]
        v = np.concatenate([mel.mean(axis=-1), mel.std(axis=-1)])
        return v / (np.linalg.norm(v) + 1e-9)

    return float(np.dot(embed(wav_a), embed(wav_b)))


# ---------------------------------------------------------------------------
# Synthesis of one manifest through the engine
# ---------------------------------------------------------------------------


def synthesize_manifest(engine, items, out_dir: Path, tag: str,
                        max_new_tokens: int, seed: int,
                        temperature: float, top_p: float,
                        workers: int = 1):
    """Run every manifest item through engine.inference, write
    `<out_dir>/<tag>/<id>.wav`, return [(item, wav_path, timing)] in
    manifest order. timing = {"seconds", "ttfa_s", "audio_s", "rtf"}.

    workers > 1 synthesizes items CONCURRENTLY (the same worker-thread
    pattern as `tools/batch_tts.py:run_job`): with a pooled engine
    (BatcherSession over a ContinuousBatcher) the manifest runs at the
    box's SERVING throughput instead of single-stream. Requests
    stream so each item also records its time-to-first-audio."""
    import queue as queue_mod
    import threading

    from fish_speech_tpu_torch.audio.io import write_wav
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    d = out_dir / tag
    d.mkdir(parents=True, exist_ok=True)
    work: queue_mod.Queue = queue_mod.Queue()
    for i, item in enumerate(items):
        work.put((i, item))
    results = [None] * len(items)
    errors = []

    def run_one(i, item):
        refs = []
        if item.get("ref_audio"):
            refs = [types.SimpleNamespace(
                audio=Path(item["ref_audio"]).read_bytes(),
                text=item.get("ref_text", ""),
            )]
        req = TTSRequest(
            text=item["text"], streaming=True,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, seed=seed + i, references=refs,
            use_memory_cache="on" if refs else "off",
        )
        t0 = time.perf_counter()
        audio, ttfa = None, None
        for result in engine.inference(req):
            if result.code == "error":
                raise result.error
            if (result.code == "segment" and ttfa is None
                    and len(result.audio[1]) > 0):
                ttfa = time.perf_counter() - t0
            if result.code == "final":
                audio = result.audio
        dt = time.perf_counter() - t0
        sr, samples = audio
        path = d / f"{item['id']}.wav"
        write_wav(path, samples, sr)
        audio_s = len(samples) / sr
        results[i] = (item, path, {
            "seconds": dt,
            "ttfa_s": ttfa,
            "audio_s": audio_s,
            "rtf": dt / audio_s if audio_s > 0 else None,
        })

    def worker():
        while True:
            try:
                i, item = work.get_nowait()
            except queue_mod.Empty:
                return
            try:
                run_one(i, item)
            except Exception as e:  # noqa: BLE001 — fail the whole eval
                errors.append((items[i]["id"], e))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(workers, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        item_id, e = errors[0]
        raise RuntimeError(
            f"{len(errors)} item(s) failed (first: {item_id})") from e
    return results


def score(results, asr_fn: Optional[Callable], sim_fn: Optional[Callable]):
    """Score synthesized items; returns per-item rows + per-lang WER and
    mean SIM aggregates.

    Per-language WER is CORPUS-LEVEL (total edit distance / total reference
    tokens, the Seed-TTS-eval convention) — a mean of per-utterance rates
    would let short utterances dominate the flag-flip gate (a 1-edit 2-word
    clip next to a clean 100-word clip is 0.98% corpus WER, not 25%).
    Per-item rates stay in the rows for inspection."""
    rows, by_lang, sims = [], {}, []
    for item, path, timing in results:
        lang = item.get("lang", "en")
        row = {"id": item["id"], "lang": lang, "wav": str(path),
               "seconds": round(timing["seconds"], 3),
               "audio_s": round(timing["audio_s"], 3)}
        if timing.get("ttfa_s") is not None:
            row["ttfa_s"] = round(timing["ttfa_s"], 3)
        if timing.get("rtf") is not None:
            row["rtf"] = round(timing["rtf"], 4)
        if asr_fn is not None:
            hyp = asr_fn(str(path), lang)
            target = item.get("target", item["text"])
            h = normalize_text(hyp, lang)
            r = normalize_text(target, lang)
            dist = edit_distance(h, r)
            row["transcript"] = hyp
            row["wer"] = round(dist / len(r), 4) if r else (0.0 if not h else 1.0)
            edits, ref_len = by_lang.setdefault(lang, [0, 0])
            by_lang[lang] = [edits + dist, ref_len + len(r)]
        if sim_fn is not None and item.get("ref_audio"):
            row["sim"] = round(sim_fn(str(path), item["ref_audio"]), 4)
            sims.append(row["sim"])
        rows.append(row)
    agg = {}
    for lang, (edits, ref_len) in sorted(by_lang.items()):
        agg[f"wer_{lang}"] = round(edits / max(ref_len, 1), 4)
    if sims:
        agg["sim_mean"] = round(float(np.mean(sims)), 4)
    return rows, agg


def markdown_table(model_name: str, aggs: dict) -> str:
    """The reference's benchmark table format (README.md:92-101)."""
    lang_names = {"zh": "Chinese", "en": "English", "ja": "Japanese",
                  "ko": "Korean"}
    lines = [f"| Benchmark | {model_name} |", "|------|------|"]
    for key, val in aggs.items():
        if key.startswith("wer_"):
            lang = key[4:]
            label = lang_names.get(lang, lang)
            lines.append(
                f"| Seed-TTS Eval — WER ({label}) | **{val * 100:.2f}%** |")
    if "sim_mean" in aggs:
        lines.append(f"| Speaker SIM (manifest refs) | **{aggs['sim_mean']:.3f}** |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@click.command()
@click.option("--manifest", type=click.Path(path_type=Path, exists=True),
              required=True)
@click.option("--out-dir", type=click.Path(path_type=Path),
              default=Path("eval_out"))
@click.option("--checkpoint-path", type=click.Path(path_type=Path),
              default=Path("checkpoints/s2-pro"))
@click.option("--asr", type=str, default=None,
              help="'module:function' ASR hook, or 'mock' (echoes targets; "
                   "pipeline test only). Without it WER is reported as "
                   "pending.")
@click.option("--sim", type=str, default=None,
              help="'module:function' speaker-sim hook, or 'spectral' "
                   "(log-mel proxy)")
@click.option("--ab", type=click.Choice(["kv-int8", "prefix-cache"]),
              multiple=True,
              help="also run the manifest with this opt-in flag enabled and "
                   "report side-by-side (the flag-flip gate)")
@click.option("--max-new-tokens", type=int, default=0)
@click.option("--temperature", type=float, default=0.8)
@click.option("--top-p", type=float, default=0.8)
@click.option("--seed", type=int, default=42)
@click.option("--int8", is_flag=True, help="int8 weight-only quantization")
@click.option("--tiny", is_flag=True, help="tiny random models (smoke test)")
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
@click.option("--model-name", type=str, default="fish-speech-tpu")
@click.option("--pool-size", type=int, default=8,
              help="continuous-batcher decode slots; the manifest "
                   "synthesizes at serving throughput through the pool "
                   "(1 = the old serial single-stream session)")
@click.option("--workers", type=int, default=0,
              help="concurrent in-flight items (default: pool size)")
@click.option("--decode-chunk-size", type=int, default=64)
def main(manifest, out_dir, checkpoint_path, asr, sim, ab, max_new_tokens,
         temperature, top_p, seed, int8, tiny, cpu, model_name, pool_size,
         workers, decode_chunk_size):
    device = "cpu" if cpu else "cuda:0"
    items = [json.loads(l) for l in
             Path(manifest).read_text(encoding="utf-8").splitlines() if l.strip()]
    out_dir.mkdir(parents=True, exist_ok=True)

    if asr == "mock":
        targets = {it["id"]: it.get("target", it["text"]) for it in items}

        def asr_fn(path, lang):  # echo the target for this wav's id
            return targets.get(Path(path).stem, "")
    elif asr:
        asr_fn = resolve_hook(asr)
    else:
        asr_fn = None
    sim_fn = (spectral_sim if sim == "spectral"
              else resolve_hook(sim) if sim else None)

    configs = [("baseline", {})]
    for flag in ab:
        key = {"kv-int8": "kv_quant", "prefix-cache": "prefix_cache_size"}[flag]
        val = True if flag == "kv-int8" else 4
        configs.append((flag, {key: val}))

    report = {"manifest": str(manifest), "n_items": len(items),
              "model": model_name,
              "asr": asr or "none (WER pending a real ASR hook)",
              "sim_metric": ("spectral_proxy" if sim == "spectral"
                             else sim or "none"),
              "configs": {}}
    n_workers = workers or max(pool_size, 1)
    for tag, overrides in configs:
        engine = _build_engine(checkpoint_path, device, tiny=tiny, int8=int8,
                               pool_size=pool_size,
                               decode_chunk_size=decode_chunk_size,
                               **overrides)
        t0 = time.perf_counter()
        results = synthesize_manifest(engine, items, out_dir, tag,
                                      max_new_tokens, seed, temperature,
                                      top_p, workers=n_workers)
        wall = time.perf_counter() - t0
        rows, agg = score(results, asr_fn, sim_fn)
        audio_s = sum(t["audio_s"] for _, _, t in results)
        agg["synthesis_wall_s"] = round(wall, 1)
        agg["synthesis_x_realtime"] = round(audio_s / wall, 1) if wall else 0.0
        report["configs"][tag] = {"aggregates": agg, "items": rows}
        click.echo(f"[{tag}] {agg}", err=True)
        shutdown = getattr(getattr(engine, "session", None), "batcher", None)
        if shutdown is not None:
            shutdown.shutdown()

    # A/B deltas vs baseline (the flag-flip decision numbers)
    base = report["configs"]["baseline"]["aggregates"]
    for tag in list(report["configs"]):
        if tag == "baseline":
            continue
        deltas = {k: round(report["configs"][tag]["aggregates"].get(k, 0.0)
                           - v, 4) for k, v in base.items()
                  if not k.startswith("synthesis_")}
        report["configs"][tag]["delta_vs_baseline"] = deltas

    (out_dir / "report.json").write_text(json.dumps(report, indent=2),
                                         encoding="utf-8")
    table = markdown_table(model_name, base)
    (out_dir / "report.md").write_text(table + "\n", encoding="utf-8")
    click.echo(table)
    click.echo(f"Report -> {out_dir}/report.json", err=True)


def _build_engine(checkpoint_path, device, tiny=False, int8=False,
                  kv_quant=False, prefix_cache_size=0, pool_size=8,
                  decode_chunk_size=64):
    """The engine of one config on `device` (raises where it names CUDA and
    there is none): the server's random tiny models (`--tiny`) or a
    checkpoint's LM in bf16 and codec in fp32, the LM quantized int8 with
    `int8`, behind a pool of `pool_size` slots (> 1) or a single-stream
    session, as `server/main.py:build_engine` builds them."""
    import tempfile

    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "eval_quality")
    if tiny:
        from fish_speech_tpu_torch.server.main import tiny_models

        tokenizer, cfg, params, dac_cfg, dac_params = tiny_models(device)
        dtype = torch.float32
    else:
        import dataclasses

        from fish_speech_tpu_torch.tokenizer import FishTokenizer
        from fish_speech_tpu_torch.utils.checkpoint import load_codec, load_dual_ar

        dtype = torch.bfloat16
        params, cfg = load_dual_ar(checkpoint_path, dtype=dtype, device=device)
        tokenizer = FishTokenizer.from_pretrained(str(checkpoint_path))
        cfg = dataclasses.replace(
            cfg,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id,
        ).resolve()
        dac_params, dac_cfg = load_codec(checkpoint_path, dtype=torch.float32,
                                         device=device)

    if int8:
        # SAME path as the server (`server/main.py`): the harness must
        # qualify exactly the weights serving runs with
        from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

        params = quantize_dual_ar_lowmem(params, mode="int8")

    if pool_size > 1:
        # pooled decode slots: the manifest synthesizes at serving
        # throughput (same construction as `server/main.py:build_engine`
        # and `tools/batch_tts.py`)
        from fish_speech_tpu_torch.engine.batcher import (BatcherSession,
                                                          ContinuousBatcher)

        batcher = ContinuousBatcher(
            params, cfg, SamplingConfig(), pool_size=pool_size, dtype=dtype,
            decode_chunk_size=decode_chunk_size, first_chunk_size=8,
            kv_quant=kv_quant, prefix_cache_size=prefix_cache_size,
        )
        session = BatcherSession(batcher)
    else:
        session = GenerationSession(
            params, cfg, SamplingConfig(), dtype=dtype, kv_quant=kv_quant,
            prefix_cache_size=prefix_cache_size,
            decode_chunk_size=decode_chunk_size,
        )
    del params  # the sessions hold a fused-w13 copy of the weights
    return TTSInferenceEngine(session, tokenizer, dac_params, dac_cfg,
                              references_dir=tempfile.mkdtemp())


if __name__ == "__main__":
    main()
