"""Audio-feature conditioning (the `audio_projector` path) in the port
against the JAX package, the seven cases of `tests/test_audio_conditioning.py`
on the same seeded inputs and bridged weights, on the CPU: the projector's
initialisation, the embedding that the projected features replace at
masked positions, `forward_train` and `prefill` with features, the warning
of a model without a projector, the copied `align_audio_features`, and the
session's greedy codes with features equal to JAX's."""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu import sequence as jseq
from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.tokenizer import build_test_tokenizer as jtokenizer
from fish_speech_tpu_torch import config as tconfig
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch import sequence as tseq
from fish_speech_tpu_torch.convert.from_jax import config_from_jax, dual_ar_from_jax
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer as ttokenizer

torch.set_num_threads(1)
FEAT = 12


def make_cfg(**kw):
    return dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
                        audio_feature_dim=FEAT, **kw)


def bridged(cfg, seed):
    jp = jdual.init_dual_ar(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    return jp, tp, config_from_jax(cfg, tconfig.DualARConfig)


def _inputs(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    inp = np.zeros((b, cfg.num_codebooks + 1, t), dtype=np.int32)
    inp[:, 0] = rng.integers(4, 200, size=(b, t))
    feats = rng.normal(size=(b, t, FEAT)).astype(np.float32)
    return inp, feats


def test_projector_initialized():
    cfg = config_from_jax(make_cfg(), tconfig.DualARConfig)
    params = tdual.init_dual_ar(0, cfg, torch.float32, "cpu")
    jparams = jdual.init_dual_ar(jax.random.PRNGKey(0), make_cfg(), jnp.float32)
    for name in ("w", "b"):
        assert (tuple(params["audio_projector"][name].shape)
                == jparams["audio_projector"][name].shape)
    assert params["audio_projector"]["w"].shape == (FEAT, cfg.dim)
    assert not params["audio_projector"]["b"].any()
    cfg0 = config_from_jax(dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331,
                                        im_end_id=3), tconfig.DualARConfig)
    assert "audio_projector" not in tdual.init_dual_ar(0, cfg0, torch.float32, "cpu")


@pytest.mark.parametrize("scaled", [False, True])
def test_embed_replaces_masked_positions(scaled):
    jcfg = make_cfg(scale_codebook_embeddings=scaled)
    jp, tp, cfg = bridged(jcfg, 0)
    inp, feats = _inputs(cfg, 2, 9, 0)
    mask = np.zeros((2, 9), dtype=bool)
    mask[0, 2:5] = True
    mask[1, 0] = True

    base = tdual.embed_tokens(tp, cfg, torch.from_numpy(inp)).numpy()
    out = tdual.embed_tokens(tp, cfg, torch.from_numpy(inp), torch.from_numpy(feats),
                             torch.from_numpy(mask)).numpy()
    want = np.asarray(jdual.embed_tokens(jp, jcfg, jnp.asarray(inp),
                                         jnp.asarray(feats), jnp.asarray(mask)))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    proj = feats @ tp["audio_projector"]["w"].numpy() + tp["audio_projector"]["b"].numpy()
    if scaled:
        proj = proj / math.sqrt(2)
    np.testing.assert_allclose(out[mask], proj[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[~mask], base[~mask])
    with pytest.raises(ValueError, match="audio_feature_dim"):
        tdual.embed_tokens(tp, cfg, torch.from_numpy(inp),
                           torch.zeros(2, 9, FEAT + 1), torch.from_numpy(mask))
    with pytest.raises(ValueError, match="audio_mask"):
        tdual.embed_tokens(tp, cfg, torch.from_numpy(inp), torch.from_numpy(feats))


def test_forward_train_and_prefill_accept_audio():
    jcfg = make_cfg()
    jp, tp, cfg = bridged(jcfg, 1)
    inp, feats = _inputs(cfg, 1, 8, 1)
    mask = np.zeros((1, 8), dtype=bool)
    mask[0, 3:6] = True
    kw = dict(audio_features=torch.from_numpy(feats), audio_mask=torch.from_numpy(mask))

    tok0, _ = tdual.forward_train(tp, cfg, torch.from_numpy(inp), remat=False)
    tok1, cb1 = tdual.forward_train(tp, cfg, torch.from_numpy(inp), remat=False, **kw)
    jtok1, jcb1 = jdual.forward_train(jp, jcfg, jnp.asarray(inp), remat=False,
                                      audio_features=jnp.asarray(feats),
                                      audio_mask=jnp.asarray(mask))
    np.testing.assert_allclose(tok1.numpy(), np.asarray(jtok1), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cb1.numpy(), np.asarray(jcb1), rtol=0, atol=1e-4)
    # conditioning changes logits at/after the masked region, not before
    assert not np.allclose(tok0[0, 3].numpy(), tok1[0, 3].numpy())
    np.testing.assert_allclose(tok0[0, :3].numpy(), tok1[0, :3].numpy(),
                               rtol=1e-5, atol=1e-5)

    cache = tdual.init_kv_cache(cfg, 1, 16, torch.float32, "cpu")
    jcache = jdual.init_kv_cache(jcfg, 1, 16, jnp.float32)
    logits, _, _ = tdual.prefill(tp, cfg, torch.from_numpy(inp), cache,
                                 torch.zeros(1, dtype=torch.int32), 8, **kw)
    jlogits, _, _ = jdual.prefill(jp, jcfg, jnp.asarray(inp), jcache,
                                  jnp.zeros((1,), jnp.int32), 8,
                                  audio_features=jnp.asarray(feats),
                                  audio_mask=jnp.asarray(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


def test_missing_projector_warns_and_ignores(caplog):
    jcfg = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3)
    _, tp, cfg = bridged(jcfg, 0)
    inp = torch.zeros((1, cfg.num_codebooks + 1, 4), dtype=torch.int32)
    feats = torch.zeros((1, 4, FEAT))
    mask = torch.zeros((1, 4), dtype=torch.bool)
    with caplog.at_level(logging.WARNING):
        out = tdual.embed_tokens(tp, cfg, inp, feats, mask)
    np.testing.assert_array_equal(out.numpy(), tdual.embed_tokens(tp, cfg, inp).numpy())
    assert any("audio_projector" in r.message for r in caplog.records)


def _encoded(mod, tok, feats):
    seq = mod.ContentSequence(modality="voice")
    seq.append(mod.TextPart(text="hi"))
    seq.append(mod.AudioPart(features=feats))
    seq.append(mod.TextPart(text="bye"))
    return seq.encode(tok, add_shift=False)


def test_align_audio_features_layout():
    feats = np.random.default_rng(2).normal(size=(6, FEAT)).astype(np.float32)
    enc = _encoded(tseq, ttokenizer(), feats)
    want = jseq.ContentSequence.align_audio_features(_encoded(jseq, jtokenizer(), feats))
    aligned = tseq.ContentSequence.align_audio_features(enc)
    np.testing.assert_array_equal(aligned, want)
    assert aligned.shape == (len(enc.tokens), FEAT)
    idx = np.nonzero(enc.audio_masks)[0]
    assert len(idx) == 4  # 6 frames minus start/end delimiters
    np.testing.assert_array_equal(aligned[idx], feats[1:-1])


def test_align_audio_features_none_without_parts():
    seq = tseq.ContentSequence(modality="text")
    seq.append(tseq.TextPart(text="plain"))
    assert tseq.ContentSequence.align_audio_features(seq.encode(ttokenizer())) is None


def test_generation_session_audio_conditioning(caplog):
    """Greedy codes with features equal JAX's session's; conditioning steers
    generation deterministically, through a prefill graph of its own
    (`audio_{bucket}`) and past the prefix cache; a plain request after it
    replays the plain prefill as before."""
    jcfg = make_cfg()
    jp, tp, cfg = bridged(jcfg, 2)
    rng = np.random.default_rng(3)
    t = 130  # long enough for the prefix store to take the plain prompt
    prompt = np.zeros((cfg.num_codebooks + 1, t), dtype=np.int32)
    prompt[0] = rng.integers(4, 200, size=t)
    feats = rng.normal(size=(t, FEAT)).astype(np.float32) * 3
    mask = np.zeros(t, dtype=bool)
    mask[t - 8 :] = True
    kw = dict(max_new_tokens=10, top_k=1)
    cond = dict(audio_features=feats, audio_mask=mask)

    js = jgen.GenerationSession(jp, jcfg, SamplingConfig(), dtype=jnp.float32,
                                decode_chunk_size=8)
    ts = tgen.GenerationSession(tp, cfg, SamplingConfig(), dtype=torch.float32,
                                decode_chunk_size=8, prefix_cache_size=2)
    want = js.generate(prompt, jax.random.PRNGKey(7), **kw, **cond)
    out_a = ts.generate(prompt, 7, **kw, **cond)
    np.testing.assert_array_equal(out_a, want)
    out_b = ts.generate(prompt, 7, **kw)
    np.testing.assert_array_equal(out_b, js.generate(prompt, jax.random.PRNGKey(7), **kw))
    np.testing.assert_array_equal(ts.generate(prompt, 7, **kw, **cond), out_a)
    assert out_a.shape[0] == cfg.num_codebooks + 1
    assert not (out_a.shape == out_b.shape and np.array_equal(out_a, out_b))
    bucket = tgen.pick_bucket(t, ts.cache_len)
    assert ts.eager_runs[f"audio_{bucket}"] == 2
    assert ts.eager_runs[f"prefill_{bucket}"] == 1
    # features never enter the prefix store nor read it (JAX's counts)
    assert (ts.prefix_hits, ts.prefix_misses, len(ts.prefix)) == (0, 3, 1)
    with pytest.raises(ValueError, match="audio_feature_dim"):
        ts.generate(prompt, 7, **kw, audio_features=feats[:, :5], audio_mask=mask)
    with pytest.raises(ValueError, match="audio_mask"):
        ts.generate(prompt, 7, **kw, audio_features=feats)

    # a model without a projector warns and generates as without features
    jcfg0 = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3)
    _, tp0, cfg0 = bridged(jcfg0, 2)
    ts0 = tgen.GenerationSession(tp0, cfg0, SamplingConfig(), dtype=torch.float32,
                                 decode_chunk_size=8)
    with caplog.at_level(logging.WARNING):
        got = ts0.generate(prompt, 7, **kw, **cond)
    np.testing.assert_array_equal(got, ts0.generate(prompt, 7, **kw))
    assert any("audio_projector" in r.message for r in caplog.records)
