"""The port's evaluation and client tools against the JAX package's, on the
CPU: the quality harness's pure functions on the same inputs, its whole
run (`eval_quality --tiny --cpu`, the pool and the single-stream session,
both A/Bs) with the report's keys as JAX's, the in-context evaluation's
per-frame losses on the same checkpoint, the spectrograms, the analytic
FLOPs against `torch.utils.flop_counter.FlopCounterMode`, the ranked
logger and `set_seed`, the API client's saved file against the JAX
client's on one in-process server, the playback ladder and the web UI
launcher's argv.

No timing field of a report is asserted: JAX's `test_eval_quality_harness`
asserts `synthesis_x_realtime > 0`, a ratio rounded to one decimal that is
0.05 when that test runs alone on a CPU (2 x 0.372 s of audio over a
14.7 s wall) and so rounds to 0.0 once the machine is loaded."""

import asyncio
import dataclasses
import json
import logging
import random
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fish_speech_tpu.tools import eval_quality as jeq
from fish_speech_tpu_torch.audio.io import write_wav
from fish_speech_tpu_torch.config import dac_tiny
from fish_speech_tpu_torch.tools import eval_quality as teq

torch.set_num_threads(1)

TEXTS = [("Hello, WORLD!", "hello world", "en"), ("hello big world", "hello world", "en"),
         ("abc", "abd", "zh"), ("", "hello world", "en"), ("", "", "en"),
         ("今天 天气，很好。", "今天天气很好", "zh"), ("Ｆｕｌｌ-width ＡＢＣ", "full width abc", "en"),
         ("こんにちは世界", "こんにちわ世界", "ja")]


@pytest.mark.parametrize("hyp,ref,lang", TEXTS)
def test_text_scoring_functions_match_jax(hyp, ref, lang):
    assert teq.normalize_text(hyp, lang) == jeq.normalize_text(hyp, lang)
    a, b = teq.normalize_text(hyp, lang), teq.normalize_text(ref, lang)
    assert teq.edit_distance(a, b) == jeq.edit_distance(a, b)
    assert teq.error_rate(hyp, ref, lang) == jeq.error_rate(hyp, ref, lang)


def _clip(path, seed, n=24000, sr=24000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t) + 0.05 * rng.normal(size=n)
    write_wav(path, x.astype(np.float32), sr)
    return str(path)


def test_spectral_sim_and_score_match_jax(tmp_path):
    a, b, c = (_clip(tmp_path / f"{i}.wav", i) for i in range(3))
    for x, y in ((a, b), (a, c), (b, b)):
        got, want = teq.spectral_sim(x, y), jeq.spectral_sim(x, y)
        assert -1.0 <= got <= 1.0
        assert abs(got - want) < 1e-5, (got, want)
    timing = {"seconds": 0.1, "ttfa_s": 0.05, "audio_s": 0.5, "rtf": 0.2}
    results = [({"id": "a", "lang": "en", "text": "hello world", "ref_audio": c}, a, timing),
               ({"id": "b", "lang": "en", "text": " ".join(["word"] * 100)}, b, timing),
               ({"id": "c", "lang": "zh", "text": "一二三", "ref_audio": a}, c,
                dict(timing, ttfa_s=None, rtf=None))]
    hyps = {a: "hello big world", b: " ".join(["word"] * 100), c: "一二"}
    got = teq.score(results, lambda p, lang: hyps[p], teq.spectral_sim)
    want = jeq.score(results, lambda p, lang: hyps[p], jeq.spectral_sim)
    assert got[0] == want[0] and got[1] == want[1]
    assert teq.markdown_table("m", got[1]) == jeq.markdown_table("m", want[1])
    assert teq.markdown_table("m", {"wer_ko": 0.5}) == jeq.markdown_table("m", {"wer_ko": 0.5})


def _manifest(tmp_path):
    cfg = dac_tiny()
    ref = tmp_path / "speaker.wav"
    write_wav(ref, np.random.default_rng(0).normal(size=cfg.frame_length * 4)
              .astype(np.float32) * 0.1, cfg.sample_rate)
    items = [{"id": "en_1", "text": "hello there", "lang": "en"},
             {"id": "zh_1", "text": "one two three", "lang": "zh",
              "ref_audio": str(ref), "ref_text": "ref"}]
    path = tmp_path / "manifest.jsonl"
    path.write_text("\n".join(json.dumps(i) for i in items))
    return path, items


ARGS = ["--tiny", "--cpu", "--asr", "mock", "--sim", "spectral", "--ab", "kv-int8",
        "--ab", "prefix-cache", "--max-new-tokens", "8"]


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    """JAX's harness on the same manifest and flags, its synthesis replaced
    by fixed WAVs (the report's layout does not depend on the audio)."""
    tmp = tmp_path_factory.mktemp("jax_eval")
    manifest, items = _manifest(tmp)
    wav = _clip(tmp / "out.wav", 5)
    timing = {"seconds": 0.1, "ttfa_s": 0.05, "audio_s": 0.5, "rtf": 0.2}
    mp = pytest.MonkeyPatch()
    mp.setattr(jeq, "_build_engine", lambda *a, **k: object())
    mp.setattr(jeq, "synthesize_manifest",
               lambda engine, its, *a, **k: [(it, Path(wav), timing) for it in its])
    try:
        r = CliRunner().invoke(jeq.main, ["--manifest", str(manifest), "--out-dir",
                                          str(tmp / "out"), *ARGS],
                               catch_exceptions=False)
    finally:
        mp.undo()
    assert r.exit_code == 0, r.output
    return json.loads((tmp / "out" / "report.json").read_text())


@pytest.mark.parametrize("pool_size", [1, 8])
def test_eval_quality_tiny_cpu_reports_as_jax(tmp_path, jax_report, pool_size):
    manifest, items = _manifest(tmp_path)
    out = tmp_path / "eval_out"
    r = CliRunner().invoke(teq.main, ["--manifest", str(manifest), "--out-dir", str(out),
                                      *ARGS, "--pool-size", str(pool_size)],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    report = json.loads((out / "report.json").read_text())
    assert set(report) == set(jax_report)
    assert {k: v for k, v in report.items() if k not in ("configs", "manifest")} == {
        k: v for k, v in jax_report.items() if k not in ("configs", "manifest")}
    assert list(report["configs"]) == list(jax_report["configs"]) == [
        "baseline", "kv-int8", "prefix-cache"]
    for tag, conf in report["configs"].items():
        want = jax_report["configs"][tag]
        assert set(conf) == set(want)
        assert set(conf["aggregates"]) == set(want["aggregates"])
        assert set(conf.get("delta_vs_baseline", ())) == set(want.get("delta_vs_baseline", ()))
        agg = conf["aggregates"]
        assert agg["wer_en"] == 0.0 and agg["wer_zh"] == 0.0  # mock ASR
        assert -1.0 <= agg["sim_mean"] <= 1.0
        assert [row["id"] for row in conf["items"]] == [it["id"] for it in items]
        for row, wrow in zip(conf["items"], want["items"]):
            assert {"id", "lang", "wav", "transcript", "wer"} <= set(row)
            assert ("sim" in row) == ("sim" in wrow)
            frames = (Path(row["wav"]).stat().st_size - 44) // 2 / dac_tiny().frame_length
            assert frames == int(frames) and frames > 0  # whole frames
    md = (out / "report.md").read_text()
    assert md.startswith("| Benchmark |") and "WER (Chinese)" in md


def test_eval_quality_needs_cuda_without_cpu(tmp_path):
    manifest, _ = _manifest(tmp_path)
    r = CliRunner().invoke(teq.main, ["--manifest", str(manifest), "--out-dir",
                                      str(tmp_path / "o"), "--tiny"])
    assert r.exit_code != 0 and "no CUDA device" in str(r.exception)


def _in_context_checkpoint(tmp_path):
    from fish_speech_tpu.config import dual_ar_tiny
    from fish_speech_tpu.models.dual_ar import init_dual_ar
    from fish_speech_tpu.tokenizer import build_test_tokenizer
    from fish_speech_tpu.utils.checkpoint import save_dual_ar

    tok = build_test_tokenizer()
    cfg = dual_ar_tiny(semantic_begin_id=tok.semantic_begin_id,
                       semantic_end_id=tok.semantic_end_id,
                       im_end_id=tok.im_end_id, vocab_size=tok.vocab_size)
    for i in range(2):
        save_dual_ar(tmp_path / f"ckpt{i}",
                     init_dual_ar(jax.random.PRNGKey(i), cfg, dtype=jnp.float32), cfg, tok)
    rng = np.random.default_rng(7)
    for name, t in (("ref", 6), ("tgt", 5)):
        np.save(tmp_path / f"{name}.npy",
                rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
                .astype(np.int32))
    return ["--checkpoint-path", str(tmp_path / "ckpt0"), "--checkpoint-path",
            str(tmp_path / "ckpt1"), "--reference-codes", str(tmp_path / "ref.npy"),
            "--reference-text", "reference speech", "--target-codes",
            str(tmp_path / "tgt.npy"), "--target-text", "target speech"]


def test_eval_in_context_matches_jax(tmp_path):
    from fish_speech_tpu.tools.eval_in_context import main as jmain
    from fish_speech_tpu_torch.tools.eval_in_context import main as tmain

    args = _in_context_checkpoint(tmp_path)
    r = CliRunner().invoke(jmain, args + ["--output", str(tmp_path / "j.json")],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    r = CliRunner().invoke(tmain, args + ["--output", str(tmp_path / "t.json"), "--cpu"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert list(got) == list(want) and len(got) == 2
    for ckpt in want:
        assert len(got[ckpt]["per_frame"]) == len(want[ckpt]["per_frame"]) == 5
        np.testing.assert_allclose(got[ckpt]["per_frame"], want[ckpt]["per_frame"],
                                   rtol=0, atol=1e-4)
        assert abs(got[ckpt]["mean_loss"] - want[ckpt]["mean_loss"]) < 1e-4
    r = CliRunner().invoke(tmain, args + ["--output", str(tmp_path / "c.json")])
    assert r.exit_code != 0 and "no CUDA device" in str(r.exception)


def test_eval_in_context_over_int4_matches_jax(tmp_path):
    """The tool at its default fp32 over an int4 checkpoint (JAX's
    `tools.quantize --mode int4 --group-size 128` of the tiny tree: groups
    of 32 and 16 at its widths) gives JAX's tool's per-frame losses within
    1e-4: on the card every layer product of that forward is the int4
    matmul's "fp32_tc" route, whose plain version (W = q * s in fp32, the
    JAX package's `int4_matmul_reference`) the CPU run takes."""
    from fish_speech_tpu.tools.eval_in_context import main as jmain
    from fish_speech_tpu.tools.quantize import main as jquantize
    from fish_speech_tpu_torch.tools.eval_in_context import main as tmain
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    args = _in_context_checkpoint(tmp_path)
    r = CliRunner().invoke(jquantize, ["--checkpoint-path", str(tmp_path / "ckpt0"),
                                       "--output", str(tmp_path / "ckpt0-int4"), "--mode",
                                       "int4", "--group-size", "128"], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    params, _ = load_dual_ar(tmp_path / "ckpt0-int4", dtype=torch.float32, device="cpu")
    assert {"p", "gs"} <= set(params["layers"]["w2"])
    # the int4 checkpoint alone, on the same codes and texts
    args = ["--checkpoint-path", str(tmp_path / "ckpt0-int4")] + args[4:]
    r = CliRunner().invoke(jmain, args + ["--output", str(tmp_path / "j.json")],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    r = CliRunner().invoke(tmain, args + ["--output", str(tmp_path / "t.json"), "--cpu"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert list(got) == list(want) == [str(tmp_path / "ckpt0-int4")]
    for ckpt in want:
        assert len(got[ckpt]["per_frame"]) == len(want[ckpt]["per_frame"]) == 5
        np.testing.assert_allclose(got[ckpt]["per_frame"], want[ckpt]["per_frame"],
                                   rtol=0, atol=1e-4)
        assert abs(got[ckpt]["mean_loss"] - want[ckpt]["mean_loss"]) < 1e-4


def test_per_frame_loss_is_the_training_cross_entropy(tmp_path):
    """The tool's per-frame losses average to `dual_ar_loss`'s semantic
    loss on the same inputs (frames of equal codebook counts)."""
    from fish_speech_tpu_torch.tokenizer import FishTokenizer
    from fish_speech_tpu_torch.tools.eval_in_context import (in_context_inputs,
                                                             per_frame_semantic_loss)
    from fish_speech_tpu_torch.train.loss import dual_ar_loss
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    _in_context_checkpoint(tmp_path)
    params, cfg = load_dual_ar(tmp_path / "ckpt0", dtype=torch.float32, device="cpu")
    tok = FishTokenizer.from_pretrained(str(tmp_path / "ckpt0"))
    cfg = dataclasses.replace(cfg, semantic_begin_id=tok.semantic_begin_id,
                              semantic_end_id=tok.semantic_end_id,
                              im_end_id=tok.im_end_id).resolve()
    inp, labels = in_context_inputs(tok, cfg, np.load(tmp_path / "ref.npy"), "a b",
                                    np.load(tmp_path / "tgt.npy"), "c d")
    per_frame, mask = per_frame_semantic_loss(params, cfg, inp, labels)
    _, metrics = dual_ar_loss(params, cfg, {"inputs": torch.from_numpy(inp[None]),
                                            "labels": torch.from_numpy(labels[None])},
                              remat=False)
    assert mask.sum() == 5
    assert abs(per_frame[mask].mean() - float(metrics["semantic_loss"])) < 1e-5


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, 512), (256, 64, 200),
                                           (1024, 256, 1024), (400, 160, 400),
                                           (2048, 512, 2048)])
def test_spectrograms_match_jax(n_fft, hop, win):
    from fish_speech_tpu.audio import spectrogram as J
    from fish_speech_tpu_torch.audio import spectrogram as T

    x = np.random.default_rng(n_fft).normal(size=(2, 4100)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        T.linear_spectrogram(torch.from_numpy(x), n_fft, hop, win).numpy(),
        np.asarray(J.linear_spectrogram(jnp.asarray(x), n_fft, hop, win)),
        rtol=1e-5, atol=1e-5)
    for kw in (dict(sample_rate=16000, n_mels=64), dict(sample_rate=44100, n_mels=128,
                                                         f_min=40.0, f_max=16000.0)):
        got = T.log_mel_spectrogram(torch.from_numpy(x[0]), n_fft=n_fft,
                                    hop_length=hop, win_length=win, **kw).numpy()
        want = np.asarray(J.log_mel_spectrogram(jnp.asarray(x[0]), n_fft=n_fft,
                                                hop_length=hop, win_length=win, **kw))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(T.mel_filter_bank(16000, n_fft, 40),
                                  J.mel_filter_bank(16000, n_fft, 40))


# -- FLOPs accounting ------------------------------------------------------


ONE_LAYER = dict(vocab_size=1024, n_layer=1, dim=256, n_head=4, n_local_heads=2,
                 head_dim=64, intermediate_size=512, max_seq_len=256,
                 codebook_size=64, num_codebooks=4, n_fast_layer=1, fast_dim=128,
                 fast_n_head=2, fast_n_local_heads=1, fast_head_dim=64,
                 fast_intermediate_size=256, tie_word_embeddings=False,
                 use_gradient_checkpointing=False)


def _train_batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    inputs = np.zeros((b, cfg.num_codebooks + 1, t), dtype=np.int32)
    inputs[:, 0] = rng.integers(10, 1000, size=(b, t))
    inputs = torch.from_numpy(inputs)
    return {"inputs": inputs, "labels": inputs.clone(),
            "pad_mask": torch.zeros((b, t), dtype=torch.bool)}


def _counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def test_flops_match_the_flop_counter():
    """The counts are JAX's; in the bands of `tests/test_flops.py` (there
    against XLA's count) against the counter: the forward and the full
    training step (remat off), and the LoRA step's ratio to the full one."""
    from fish_speech_tpu import config as jconfig
    from fish_speech_tpu.utils import flops as JF
    from fish_speech_tpu_torch.config import dual_ar_tiny
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.lora import LoraConfig, add_lora, apply_lora_config
    from fish_speech_tpu_torch.utils import flops as F

    cfg = dual_ar_tiny(**ONE_LAYER).resolve()
    jcfg = jconfig.dual_ar_tiny(**ONE_LAYER).resolve()
    b, t = 2, 256
    assert F.dual_ar_forward_flops(cfg, b, t) == JF.dual_ar_forward_flops(jcfg, b, t)
    for mode in ("full", "lora"):
        assert (F.dual_ar_train_step_flops(cfg, b, t, mode)
                == JF.dual_ar_train_step_flops(jcfg, b, t, mode))
    assert F.dual_ar_prefill_flops(cfg, 16, 128) == JF.dual_ar_prefill_flops(jcfg, 16, 128)
    assert (F.dual_ar_decode_step_flops(cfg, 16, 256.0)
            == JF.dual_ar_decode_step_flops(jcfg, 16, 256.0))

    params = dual_ar.init_dual_ar(0, cfg, torch.float32, "cpu")
    batch = _train_batch(cfg, b, t, 0)
    with torch.no_grad():
        fwd = _counted(lambda: dual_ar.forward_train(params, cfg, batch["inputs"],
                                                     remat=False))
    analytic = F.dual_ar_forward_flops(cfg, b, t)["total"]
    assert 0.98 < fwd / analytic < 1.25, (fwd, analytic)

    full = _counted(lambda: _grad_step(params, cfg, batch, lambda path: True))
    plan = F.dual_ar_train_step_flops(cfg, b, t, mode="full", remat=False)
    assert plan["total"] == plan["hfu_total"]
    assert 0.98 < full / plan["total"] < 1.35, (full, plan)

    lcfg = LoraConfig(r=8, lora_alpha=16.0)
    lparams = add_lora(dual_ar.init_dual_ar(0, cfg, torch.float32, "cpu"), cfg, lcfg,
                       1, torch.float32)
    lora = _counted(lambda: _grad_step(lparams, apply_lora_config(cfg, lcfg), batch,
                                       lambda path: "lora" in path))
    a_full = F.dual_ar_train_step_flops(cfg, b, t, "full")["total"]
    a_lora = F.dual_ar_train_step_flops(cfg, b, t, "lora")["total"]
    # as in JAX's test: the analytic model drops the frozen dW GEMMs and
    # counts no adapter GEMMs, a real share of the step at r=8, dim=256
    assert lora < full
    assert abs(lora / full - a_lora / a_full) < 0.2, (lora / full, a_lora / a_full)


def _grad_step(params, cfg, batch, trains):
    """The gradients of `dual_ar_loss` for the leaves whose path `trains`."""
    from fish_speech_tpu_torch.train.loss import dual_ar_loss

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        elif tree.is_floating_point() and trains(path):
            yield tree

    wrt = [x.requires_grad_(True) for x in leaves(params)]
    loss, _ = dual_ar_loss(params, cfg, batch, remat=False)
    torch.autograd.grad(loss, wrt)


def test_codec_flops_match_the_flop_counter():
    """`dac_encode` (0.9-1.3) and `dac_from_indices` (0.9-1.1) of the full
    codec widths at 4 frames, the bands of `tests/test_flops.py`."""
    from fish_speech_tpu_torch.config import DACConfig
    from fish_speech_tpu_torch.models.dac.model import (dac_encode, dac_from_indices,
                                                        init_dac)
    from fish_speech_tpu_torch.utils import flops as F

    cfg = DACConfig(encoder_transformer_layers=(0, 0, 0, 1))
    params = init_dac(0, cfg, device="cpu")
    samples = cfg.frame_length * 4
    with torch.no_grad():
        enc = _counted(lambda: dac_encode(params, cfg, torch.zeros(1, 1, samples)))
        codes = torch.zeros((1, 1 + cfg.rvq.n_codebooks, 4), dtype=torch.int32)
        dec = _counted(lambda: dac_from_indices(params, cfg, codes))
    assert 0.9 < enc / F.dac_encode_flops(cfg, 1, samples) < 1.3
    assert 0.9 < dec / F.dac_decode_flops(cfg, 1, 4) < 1.1


# -- logging -----------------------------------------------------------------


def test_ranked_logger_and_set_seed(caplog, monkeypatch):
    from fish_speech_tpu.utils import logging as jlog
    from fish_speech_tpu_torch.utils import logging as tlog

    monkeypatch.delenv("RANK", raising=False)
    for mod in (jlog, tlog):
        with caplog.at_level(logging.INFO, logger="eval.test"):
            caplog.clear()
            mod.RankedLogger("eval.test").info("all %d", 1)
            mod.RankedLogger("eval.test", rank_zero_only=True).info("zero")
            mod.RankedLogger("eval.test").info("on one", rank=1)
            mod.RankedLogger("eval.test").debug("hidden")
            records = [r.getMessage() for r in caplog.records]
        if mod is jlog:
            want = records
    assert records == want == ["[rank: 0] all 1", "[rank: 0] zero"]

    monkeypatch.setenv("RANK", "1")
    with caplog.at_level(logging.INFO, logger="eval.test"):
        caplog.clear()
        tlog.RankedLogger("eval.test", rank_zero_only=True).info("zero")
        tlog.RankedLogger("eval.test").info("on one", rank=1)
        assert [r.getMessage() for r in caplog.records] == ["[rank: 1] on one"]

    gen = tlog.set_seed(5)
    draws = (random.random(), np.random.rand(), torch.rand(1, generator=gen).item())
    jlog.set_seed(5)
    assert draws[:2] == (random.random(), np.random.rand())
    assert draws[2] == torch.rand(1, generator=torch.Generator().manual_seed(5)).item()


# -- the API client, playback and the web UI launcher -----------------------


@pytest.fixture(scope="module")
def server_url():
    """The port's HTTP app over a tiny CPU engine, on 127.0.0.1."""
    from aiohttp import web

    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.server.app import create_app
    from fish_speech_tpu_torch.server.main import tiny_models

    tok, cfg, params, dac_cfg, dac_params = tiny_models("cpu")
    session = GenerationSession(params, cfg, dtype=torch.float32, decode_chunk_size=8)
    engine = TTSInferenceEngine(session, tok, dac_params, dac_cfg)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(create_app(engine))
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{port}"
    asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)


@pytest.mark.parametrize("extra", [["--no-streaming"], ["--streaming"],
                                   ["--streaming", "--play"]])
def test_api_client_saves_what_the_jax_client_saves(tmp_path, server_url, extra,
                                                    monkeypatch):
    from fish_speech_tpu.tools import api_client as jclient
    from fish_speech_tpu.tools import playback as jplay
    from fish_speech_tpu_torch.tools import api_client as tclient
    from fish_speech_tpu_torch.tools import playback as tplay

    for mod in (jplay, tplay):  # no audio backend: --play ends file-only
        monkeypatch.setattr(mod, "_BACKENDS", [])
    ref = _clip(tmp_path / "ref.wav", 3, n=8000, sr=16000)
    args = ["--url", f"{server_url}/v1/tts", "--text", "Hello there.", "--seed", "3",
            "--max-new-tokens", "6", "-ra", ref, "-rt", "a reference", *extra]
    out = {}
    for name, mod in (("jax", jclient), ("port", tclient)):
        out[name] = tmp_path / f"{name}.wav"
        r = CliRunner().invoke(mod.main, args + ["-o", str(out[name])],
                               catch_exceptions=False)
        assert r.exit_code == 0, r.output
        assert ("playback disabled" in r.output) == ("--play" in extra)
    body = out["port"].read_bytes()
    assert body == out["jax"].read_bytes()
    assert body[:4] == b"RIFF" and len(body) > 44
    assert (len(body) - 44) // 2 % dac_tiny().frame_length == 0


class _FakeSink:
    def __init__(self, rate, channels):
        self.rate, self.channels, self.data, self.closed = rate, channels, b"", False

    def write(self, pcm):
        self.data += pcm

    def close(self):
        self.closed = True


class _BrokenSink:
    def __init__(self, rate, channels):
        raise OSError("no device")


def test_playback_ladder_matches_jax(tmp_path):
    from fish_speech_tpu.tools import playback as jplay
    from fish_speech_tpu_torch.audio.transcode import encode_flac
    from fish_speech_tpu_torch.tools import playback as tplay

    sink = tplay.open_sink(24000, 1, backends=[_BrokenSink, _FakeSink])
    assert isinstance(sink, _FakeSink) and sink.rate == 24000
    for mod in (tplay, jplay):
        with pytest.raises(mod.PlaybackUnavailable, match="no playback backend"):
            mod.open_sink(44100, 1, backends=[_BrokenSink])
    x = (2000 * np.sin(np.arange(5000) * 0.02)).astype(np.int16)
    wav = tmp_path / "x.wav"
    write_wav(wav, x.astype(np.float32) / 32767.0, 22050)
    for body, fmt in ((wav.read_bytes(), "wav"), (encode_flac(x, 44100), "flac"),
                      (b"\x01\x02" * 10, "pcm")):
        assert tplay.decode_to_pcm(body, fmt) == jplay.decode_to_pcm(body, fmt)
    data = wav.read_bytes()
    for chunk in (1, 7, 4096):
        parsers = (tplay.WavStreamParser(), jplay.WavStreamParser())
        outs = [b"".join(p.feed(data[i:i + chunk]) for i in range(0, len(data), chunk))
                for p in parsers]
        assert outs[0] == outs[1] and parsers[0].rate == 22050
    with pytest.raises(ValueError):
        tplay.decode_to_pcm(b"xx", "au")


@pytest.mark.parametrize("argv", [["--tiny", "--cpu"], ["--listen", "0.0.0.0:9000"],
                                  ["--listen=127.0.0.1:1"]])
def test_run_webui_argv_matches_jax(monkeypatch, argv):
    import sys

    import fish_speech_tpu.server.main as jserver
    import fish_speech_tpu_torch.server.main as tserver
    from fish_speech_tpu.tools import run_webui as jweb
    from fish_speech_tpu_torch.tools import run_webui as tweb

    seen = {}
    monkeypatch.setattr(jserver, "main", lambda a: seen.setdefault("jax", list(a)))
    monkeypatch.setattr(tserver, "main", lambda a: seen.setdefault("port", list(a)))
    monkeypatch.setattr(sys, "argv", ["run_webui", *argv])
    jweb.main()
    tweb.main()
    assert seen["port"] == seen["jax"]
    assert any(a.startswith("--listen") for a in seen["port"])
