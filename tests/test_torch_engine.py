"""The port's codec decoder and TTS engine against the JAX package, on CPU.

Same random weights (JAX `init_dac` / `init_dual_ar`, bridged), float32:
the causal conv primitives and `dac_from_indices` on `dac_tiny` agree to
1e-5 abs; a streamed greedy `TTSInferenceEngine.inference` gives the same
segment count and audio within 1e-5 abs, with and without a voice-clone
reference (by id from a references directory, and by bytes), and a
missing reference is an `error` result; `encode_references_batch` gives
JAX's codes, batched as one by one, with JAX's cache hits and misses.
"""

import io
import wave
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import SamplingConfig, dac_tiny, dual_ar_tiny
from fish_speech_tpu.engine import tts as jtts
from fish_speech_tpu.generate import GenerationSession as JSession
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.dac import conv as jconv
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.models.dac.model import dac_from_indices as j_from_indices
from fish_speech_tpu_torch.convert.from_jax import (dac_decoder_from_jax,
                                                    dac_from_jax,
                                                    dual_ar_from_jax,
                                                    init_dac_decoder)
from fish_speech_tpu_torch.engine import tts as ttts
from fish_speech_tpu_torch.generate import GenerationSession as TSession
from fish_speech_tpu_torch.models.dac import conv as tconv
from fish_speech_tpu_torch.models.dac.model import \
    dac_from_indices as t_from_indices

torch.set_num_threads(1)
ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def codec():
    cfg = dac_tiny()
    jp = init_dac(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    tp = dac_decoder_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              dtype=torch.float32, device="cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("kernel,stride,dilation,groups", [
    (7, 1, 1, 1), (7, 1, 3, 1), (4, 2, 1, 1), (7, 1, 1, 6),
])
def test_causal_conv1d_matches_jax(kernel, stride, dilation, groups):
    rng = np.random.default_rng(kernel + stride + dilation + groups)
    x = rng.standard_normal((2, 21, 6)).astype(np.float32)
    w = rng.standard_normal((kernel, 6 // groups, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride, dilation, groups)
    got = tconv.causal_conv1d(torch.from_numpy(x),
                              torch.from_numpy(np.transpose(w, (2, 1, 0)).copy()),
                              torch.from_numpy(b), stride, dilation, groups)
    _close(got, want)


@pytest.mark.parametrize("kernel,stride", [(16, 8), (4, 2), (2, 2)])
def test_causal_conv_transpose1d_matches_jax(kernel, stride):
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, 3, 5)).astype(np.float32)  # (K, Cout, Cin)
    b = rng.standard_normal(3).astype(np.float32)
    want = jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), stride)
    got = tconv.causal_conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(np.transpose(w, (2, 1, 0)).copy()),
        torch.from_numpy(b), stride)
    assert got.shape == (2, 9 * stride, 3)
    _close(got, want)


def test_snake_and_layer_norm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 8)).astype(np.float32)
    a, w, b = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    _close(tconv.snake(torch.from_numpy(x), torch.from_numpy(a)),
           jconv.snake(jnp.asarray(x), jnp.asarray(a)))
    _close(tconv.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jconv.layer_norm(*map(jnp.asarray, (x, w, b))))


def test_dac_from_indices_matches_jax(codec):
    cfg, jp, tp = codec
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 40, size=(2, cfg.rvq.total_codebooks, 13)).astype(np.int32)
    want = j_from_indices(jp, cfg, jnp.asarray(codes))
    got = t_from_indices(tp, cfg, torch.from_numpy(codes))
    assert got.shape == (2, 1, 13 * cfg.frame_length)
    _close(got, want)


def test_init_dac_decoder_has_the_bridge_layout(codec):
    cfg, _, tp = codec
    fresh = init_dac_decoder(0, cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), fresh) == shapes
    out = t_from_indices(fresh, cfg, torch.zeros((1, 3, 4), dtype=torch.int32))
    assert torch.isfinite(out).all()


def _engines(tokenizer, dac_cfg, jdac, tdac, references_dir, max_seq_len=160):
    """The JAX and the port's engines on the same tiny LM, float32."""
    cfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                       semantic_begin_id=tokenizer.semantic_begin_id,
                       semantic_end_id=tokenizer.semantic_end_id,
                       im_end_id=tokenizer.im_end_id,
                       num_codebooks=dac_cfg.rvq.total_codebooks,
                       attention_qk_norm=True, max_seq_len=max_seq_len)
    jp = jdual.init_dual_ar(jax.random.PRNGKey(4), cfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    scfg = SamplingConfig()
    kw = dict(decode_chunk_size=4, first_chunk_size=2)
    jeng = jtts.TTSInferenceEngine(JSession(jp, cfg, scfg, max_batch=1,
                                            dtype=jnp.float32, **kw),
                                   tokenizer, jdac, dac_cfg,
                                   references_dir=str(references_dir))
    teng = ttts.TTSInferenceEngine(TSession(tp, cfg, scfg, dtype=torch.float32, **kw),
                                   tokenizer, tdac, dac_cfg,
                                   references_dir=str(references_dir))
    return jeng, teng


def _same_results(got, want):
    assert [r.code for r in got] == [r.code for r in want]
    assert [r.code for r in got].count("segment") >= 3
    for g, w in zip(got, want):
        if g.code in ("segment", "final"):
            assert g.audio[1].shape == w.audio[1].shape
            _close(g.audio[1], w.audio[1])


def test_streamed_engine_matches_jax(tokenizer, codec, tmp_path):
    dac_cfg, jdac, tdac = codec
    jeng, teng = _engines(tokenizer, dac_cfg, jdac, tdac, tmp_path)
    req = dict(text="Hello world.", streaming=True, max_new_tokens=11, top_k=1,
               seed=7)
    want = list(jeng.inference(jtts.TTSRequest(**req)))
    got = list(teng.inference(ttts.TTSRequest(**req)))
    _same_results(got, want)

    nonstream = list(teng.inference(ttts.TTSRequest(**dict(req, streaming=False))))
    assert [r.code for r in nonstream] == ["final"]
    _close(nonstream[0].audio[1], got[-1].audio[1])
    # a reference that cannot be loaded is an error result, as in JAX
    missing = list(teng.inference(ttts.TTSRequest(text="x", reference_id="spk")))
    assert [r.code for r in missing] == ["error"]
    assert isinstance(missing[0].error, FileNotFoundError)


def _clip(seconds, sr, seed):
    """16-bit mono WAV bytes of a tone and noise from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * (150 + 50 * seed) * t) + 0.1 * rng.standard_normal(len(t))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def full_codec(codec):
    """The codec of `codec` with its encoder, bridged whole."""
    dac_cfg, jdac, _ = codec
    return dac_cfg, jdac, dac_from_jax(jax.tree_util.tree_map(np.asarray, jdac),
                                       device="cpu")


def test_voice_clone_engine_matches_jax(tokenizer, full_codec, tmp_path):
    """A clip at 22.05 kHz (resampled) and its transcript, by reference id
    from the references directory and by bytes: the same results as the
    JAX engine's, and the clip encoded once by each engine."""
    dac_cfg, jdac, tdac = full_codec
    clip, text = _clip(0.3, 22050, 1), "A short reference line."
    (tmp_path / "spk").mkdir()
    (tmp_path / "spk" / "sample.wav").write_bytes(clip)
    (tmp_path / "spk" / "sample.lab").write_text(text)
    jeng, teng = _engines(tokenizer, dac_cfg, jdac, tdac, tmp_path, 256)
    base = dict(text="Hello world.", streaming=True, max_new_tokens=11, top_k=1,
                seed=7)
    for extra in (dict(reference_id="spk", use_memory_cache="on"),
                  dict(references=[SimpleNamespace(audio=clip, text=text)])):
        want = list(jeng.inference(jtts.TTSRequest(**base, **extra)))
        got = list(teng.inference(ttts.TTSRequest(**base, **extra)))
        _same_results(got, want)
    for eng in (jeng, teng):
        assert (eng.vq_cache_misses, eng.vq_cache_hits) == (1, 1)
    codes = teng.references.ref_by_id["spk"][0][0]
    assert codes.shape == (dac_cfg.rvq.total_codebooks, 7)
    np.testing.assert_array_equal(codes, jeng.references.ref_by_id["spk"][0][0])


def test_encode_references_batch_matches_jax(full_codec):
    """Four clips (one repeated; 7, 7 and 35 frames: buckets 32 and 64) in
    one batch and one by one: JAX's codes, each clip trimmed to its frames,
    and JAX's hit and miss counts."""
    dac_cfg, jdac, tdac = full_codec
    clips = [_clip(0.3, 22050, 1), _clip(0.31, 44100, 2), _clip(0.3, 22050, 1),
             _clip(1.6, 24000, 3)]
    runs = {}
    for name, mod, params in (("jax", jtts, jdac), ("port", ttts, tdac)):
        batched = mod.TTSInferenceEngine(None, None, params, dac_cfg)
        single = mod.TTSInferenceEngine(None, None, params, dac_cfg)
        runs[name] = (batched.encode_references_batch(clips),
                      [single.encode_reference(c) for c in clips],
                      (batched.vq_cache_misses, batched.vq_cache_hits,
                       single.vq_cache_misses, single.vq_cache_hits))
    (jb, js, jn), (tb, ts, tn) = runs["jax"], runs["port"]
    assert tn == jn == (4, 0, 3, 1)
    assert [c.shape[1] for c in tb] == [7, 7, 7, 35]
    for got in (tb, ts, js):
        for g, w in zip(got, jb):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
