"""The port's device partials against its host partials and the JAX
package, on the CPU.

`GenerationSession.generate_stream(device_partials=True)` yields a
`StreamPartial` (the cumulative columns on the device, whole chunks,
untrimmed) before any host sync; `generate_long(device_partials=True)`
passes its codebook rows and `valid_frames` on, and the engine decodes
them on the device (`TTSInferenceEngine._decode_vq_device`). Mirroring
`tests/test_generate.py`'s device-partial cases:

  * the trimmed device values equal the host stream's at every yield, and
    `valid_frames()` equals min(frames the host yields, budget);
  * `StreamPartial.valid_frames` equals JAX's on the same columns, cut at
    im_end, at the budget, at both and at neither; each partial keeps its
    own tensor (the next chunk does not change it);
  * `generate_long`'s device partials (cut at the budget), trimmed, equal
    its host partials, and its samples are equal;
  * a streamed engine request gives identical audio segments and final
    audio from device partials and from host partials;
  * `num_samples` and `max_speakers` give JAX's `generate_long`'s
    responses (actions, texts and greedy codes) on the same weights, and
    `logger` gets one line per segment.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig

from tests.test_torch_slice import make_cfg, make_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tokenizer):
    cfg = dataclasses.replace(make_cfg(tokenizer, "qwen3ish"), max_seq_len=256)
    return cfg, *make_params(cfg, seed=3)


def _session(models, **kw):
    cfg, _, tp = models
    return tgen.GenerationSession(tp, cfg, TSamplingConfig(), dtype=torch.float32,
                                  **{"decode_chunk_size": 8, **kw})


def _prompt(cfg, t, seed):
    rng = np.random.default_rng(seed)
    prompt = np.zeros((cfg.num_codebooks + 1, t), dtype=np.int32)
    prompt[0] = rng.integers(4, 200, size=t)
    return prompt


@pytest.mark.parametrize("budget,first", [(18, 0), (7, 3), (30, 5)])
def test_stream_device_partials_equal_the_host_stream(models, budget, first):
    cfg = models[0]
    session = _session(models, first_chunk_size=first)
    prompt = _prompt(cfg, 8, seed=12)
    kw = dict(max_new_tokens=budget, top_k=30, temperature=0.9)
    host = list(session.generate_stream(prompt, 5, **kw))
    dev = list(session.generate_stream(prompt, 5, **kw, device_partials=True))
    assert len(dev) == len(host) >= 2
    for hp, dp in zip(host, dev):
        assert isinstance(dp, tgen.StreamPartial)
        n_host = hp.shape[1] - (1 if hp[0, -1] == cfg.im_end_id else 0)
        n = dp.valid_frames()
        assert n == min(n_host, budget)
        np.testing.assert_array_equal(dp.host()[:, :n], hp[:, :n])
        # whole chunks, untrimmed: at least the host's columns
        assert dp.device_cols.shape[1] >= hp.shape[1] - (hp.shape[1] > budget)
    # each partial kept its own tensor: the first is still one column
    assert dev[0].device_cols.shape[1] == 1
    np.testing.assert_array_equal(dev[0].host(), host[0])


@pytest.mark.parametrize("cols,budget", [
    ([5, 6, 7, 8], 10),        # neither im_end nor the budget
    ([5, 0, 7, 0], 10),        # im_end inside
    ([5, 6, 7, 8, 9, 9], 4),   # the budget cuts
    ([5, 6, 7, 8, 0, 9], 3),   # im_end past the budget
    ([0], 5),                  # im_end first
])
def test_valid_frames_match_jax(cols, budget):
    im_end = 0
    arr = np.stack([np.asarray(cols, np.int32),
                    np.arange(len(cols), dtype=np.int32)])
    want = jgen.StreamPartial(jnp.asarray(arr), im_end, budget).valid_frames()
    got = tgen.StreamPartial(torch.from_numpy(arr), im_end, budget)
    assert got.valid_frames() == want
    np.testing.assert_array_equal(got.host(), arr)


def test_generate_long_device_partials_equal_host_partials(models, tokenizer):
    session = _session(models)
    kw = dict(session=session, tokenizer=tokenizer, text="hello world",
              max_new_tokens=12, seed=7, stream_partials=True)
    host = list(tgen.generate_long(**kw))
    dev = list(tgen.generate_long(**kw, device_partials=True))
    hp = [r.codes for r in host if r.action == "partial"]
    dp = [r.codes[:, : r.valid_frames()].numpy() for r in dev
          if r.action == "partial"]
    # the device rows are cut at the budget, not at im_end
    assert all(r.codes.shape[1] <= 12 for r in dev if r.action == "partial")
    assert len(hp) == len(dp) >= 2
    for h, d in zip(hp, dp):
        np.testing.assert_array_equal(h, d)
    hs = [r.codes for r in host if r.action == "sample"]
    ds = [r.codes for r in dev if r.action == "sample"]
    assert len(hs) == len(ds) == 1
    np.testing.assert_array_equal(hs[0], ds[0])
    assert [r.action for r in dev][-1] == "next"


def test_engine_audio_from_device_partials_equals_host_partials(tmp_path):
    from fish_speech_tpu_torch.engine.tts import TTSRequest
    from fish_speech_tpu_torch.server.main import build_engine, parse_args

    engine = build_engine(parse_args(["--tiny", "--cpu", "--decode-chunk-size",
                                      "8", "--references-dir", str(tmp_path)]))
    runs = {}
    for device_partials in (True, False):
        engine.device_partials = device_partials
        eager = dict(engine.codec_eager_runs)
        results = list(engine.inference(TTSRequest(
            text="Device partials.", streaming=True, max_new_tokens=20, seed=3)))
        assert results[0].code == "header" and results[-1].code == "final", \
            results[-1].error
        runs[device_partials] = [r.audio[1] for r in results[1:]]
        assert sum(engine.codec_eager_runs.values()) > sum(eager.values())
    assert len(runs[True]) == len(runs[False]) > 3
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)


def test_num_samples_and_max_speakers_follow_jax(models, tokenizer, caplog):
    """Three speaker turns, at most two a segment, two samples: JAX's
    responses (actions, texts, greedy codes) on the same weights; the
    logger gets one line per segment."""
    cfg, jp, _ = models
    js = jgen.GenerationSession(jp, cfg, max_batch=1, dtype=jnp.float32,
                                decode_chunk_size=8)
    text = "<|speaker:0|>One.<|speaker:1|>Two.<|speaker:0|>Three."
    kw = dict(tokenizer=tokenizer, text=text, max_new_tokens=6, top_k=1,
              num_samples=2, max_speakers=2, chunk_length=1000)
    want = list(jgen.generate_long(session=js, seed=1, **kw))
    logger = logging.getLogger("test_torch_device_partials")
    with caplog.at_level(logging.INFO, logger=logger.name):
        got = list(tgen.generate_long(session=_session(models), seed=2,
                                      logger=logger, **kw))
    assert [(r.action, r.text) for r in got] == [(r.action, r.text) for r in want]
    assert [r.action for r in got].count("next") == 2
    assert [r.text for r in got if r.action == "sample"][:2] == [
        "<|speaker:0|>One.\n<|speaker:1|>Two.", "<|speaker:0|>Three."]
    for g, w in zip(got, want):
        if g.action == "sample":
            np.testing.assert_array_equal(g.codes, w.codes)
    assert sum("Generated" in r.message for r in caplog.records) == 4
