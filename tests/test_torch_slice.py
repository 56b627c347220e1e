"""The port's slice against the JAX package, on two tiny configs, on the CPU.

"plain": tied head, GQA. "qwen3ish": untied head, qk-norm, qkv bias,
fast_dim != dim, scaled codebook embeddings, normed fast-stack input. The
same random weights (JAX `init_dual_ar`, bridged with `dual_ar_from_jax`)
and the same prompts go through both packages in float32:

  * prefill logits agree to 1e-4 abs, also against JAX with its Pallas
    prefill kernel forced on in interpret mode;
  * `decode_slow_step` and `fast_decode_step` agree to 1e-4 abs;
  * greedy (top_k=1) `generate_stream` yields identical token columns,
    since both samplers reduce to argmax whatever their RNG.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.convert.from_jax import dual_ar_from_jax
from fish_speech_tpu_torch.models import dual_ar as tdual

torch.set_num_threads(1)
ATOL = 1e-4

PLAIN = dict(n_layer=2, n_head=4, n_local_heads=2, head_dim=16, dim=64,
             intermediate_size=128, max_seq_len=256, codebook_size=32,
             num_codebooks=3, n_fast_layer=2, fast_dim=None, fast_n_head=None,
             fast_n_local_heads=None, fast_head_dim=None,
             fast_intermediate_size=None, tie_word_embeddings=True)
QWEN3ISH = dict(PLAIN, fast_dim=32, fast_n_head=2, fast_n_local_heads=1,
                fast_head_dim=16, fast_intermediate_size=64,
                tie_word_embeddings=False, attention_qkv_bias=True,
                attention_qk_norm=True, scale_codebook_embeddings=True,
                norm_fastlayer_input=True)
CONFIGS = {"plain": PLAIN, "qwen3ish": QWEN3ISH}


def make_cfg(tokenizer, name):
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id, **CONFIGS[name])


def make_params(cfg, seed=0):
    jp = jdual.init_dual_ar(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    if cfg.attention_qkv_bias:  # non-zero biases so the bias path is tested
        rng = np.random.default_rng(seed)
        jp["layers"]["bqkv"] = jnp.asarray(
            rng.normal(size=jp["layers"]["bqkv"].shape).astype(np.float32) * 0.1)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    return jp, tp


def _prompt(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    inp = np.zeros((1, cfg.num_codebooks + 1, t), np.int32)
    inp[0, 0] = rng.integers(0, 256, size=t)
    sem = rng.random(t) < 0.5  # half the positions carry semantic tokens
    inp[0, 0, sem] = cfg.semantic_begin_id + rng.integers(0, cfg.codebook_size,
                                                          size=sem.sum())
    inp[0, 1:, :] = rng.integers(0, cfg.codebook_size,
                                 size=(cfg.num_codebooks, t))
    return inp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("flash", ["off", "interpret"])
@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_prefill_logits_match_jax(tokenizer, name, flash, monkeypatch):
    monkeypatch.setattr(jdual, "FLASH_PREFILL", flash)
    cfg = make_cfg(tokenizer, name)
    jp, tp = make_params(cfg)
    t, t_end = 64, 50
    inp = _prompt(cfg, t)
    jc = jdual.init_kv_cache(cfg, 1, 96, jnp.float32)
    jl, jh, jc = jdual.prefill(jp, cfg, jnp.asarray(inp), jc,
                               jnp.zeros((1,), jnp.int32), jnp.int32(t_end))
    tc = tdual.init_kv_cache(cfg, 1, 96, torch.float32)
    tl, th, tc = tdual.prefill(tp, cfg, torch.from_numpy(inp), tc,
                               torch.zeros((1,), dtype=torch.int32), t_end)
    _close(tl, jl)
    _close(th, jh)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_decode_steps_match_jax(tokenizer, name):
    cfg = make_cfg(tokenizer, name)
    jp, tp = make_params(cfg, seed=1)
    jp = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jp, cfg))
    tp = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg))
    inp = _prompt(cfg, 64, seed=1)
    t_end = 40
    jc = jdual.init_kv_cache(cfg, 1, 96, jnp.float32)
    tc = tdual.init_kv_cache(cfg, 1, 96, torch.float32)
    _, _, jc = jdual.prefill(jp, cfg, jnp.asarray(inp), jc,
                             jnp.zeros((1,), jnp.int32), jnp.int32(t_end))
    _, _, tc = tdual.prefill(tp, cfg, torch.from_numpy(inp), tc,
                             torch.zeros((1,), dtype=torch.int32), t_end)
    rng = np.random.default_rng(2)
    for pos in range(t_end, t_end + 3):
        token = _prompt(cfg, 1, seed=pos)[:, :, 0]
        jhid, jslow, jc = jdual.decode_slow_step(jp, cfg, jnp.asarray(token),
                                                 jc, jnp.int32(pos))
        thid, tslow, tc = tdual.decode_slow_step(tp, cfg,
                                                 torch.from_numpy(token), tc, pos)
        _close(thid, jhid)
        _close(tdual.semantic_head_logits(tp, cfg, tslow),
               jdual.semantic_head_logits(jp, cfg, jslow))

        jfc = jdual.init_fast_kv_cache(cfg, 1, jnp.float32)
        tfc = tdual.init_fast_kv_cache(cfg, 1, torch.float32)
        x0 = rng.normal(size=(1, cfg.dim)).astype(np.float32)
        jx = jdual.fast_project_in(jp, cfg, jnp.asarray(x0))
        tx = tdual.fast_project_in(tp, cfg, torch.from_numpy(x0))
        _close(tx, jx)
        for i in range(cfg.num_codebooks):
            jlog, jfc = jdual.fast_decode_step(jp, cfg, jx, jfc, jnp.int32(i))
            tlog, tfc = tdual.fast_decode_step(tp, cfg, tx, tfc, i)
            _close(tlog, jlog)
            code = int(np.argmax(np.asarray(jlog)[0]))
            jx = jdual.fast_embed(jp, cfg, jnp.asarray([code], jnp.int32))
            tx = tdual.fast_embed(tp, cfg, torch.tensor([code]))
        _close(tfc["k"], jfc["k"])


@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_greedy_generate_stream_columns_identical(tokenizer, name):
    cfg = dataclasses.replace(make_cfg(tokenizer, name), max_seq_len=128)
    jp, tp = make_params(cfg, seed=2)
    scfg = SamplingConfig()
    js = jgen.GenerationSession(jp, cfg, scfg, max_batch=1, dtype=jnp.float32,
                                decode_chunk_size=4, first_chunk_size=2)
    ts = tgen.GenerationSession(tp, cfg, scfg, dtype=torch.float32,
                                decode_chunk_size=4, first_chunk_size=2)
    prompt = _prompt(cfg, 37, seed=3)[0]
    kw = dict(max_new_tokens=12, temperature=0.7, top_p=0.9, top_k=1)
    want = list(js.generate_stream(prompt, jax.random.PRNGKey(0), **kw))
    got = list(ts.generate_stream(prompt, ts.new_generator(123), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[-1].shape[1] > 1


def test_greedy_generate_long_voice_clone_codes_identical(tokenizer):
    """Two speaker-tagged text segments after a voice-clone prompt: the
    second segment is conditioned on the first one's codes."""
    cfg = make_cfg(tokenizer, "qwen3ish")
    jp, tp = make_params(cfg, seed=4)
    js = jgen.GenerationSession(jp, cfg, max_batch=1, dtype=jnp.float32,
                                decode_chunk_size=4)
    ts = tgen.GenerationSession(tp, cfg, dtype=torch.float32, decode_chunk_size=4)
    ref_codes = np.random.default_rng(5).integers(
        0, cfg.codebook_size, size=(cfg.num_codebooks, 6)).astype(np.int32)
    kw = dict(tokenizer=tokenizer,
              text="<|speaker:0|>Hello there.<|speaker:1|>Hi again.",
              max_new_tokens=8, top_k=1, chunk_length=20,
              prompt_text="A reference line.", prompt_tokens=ref_codes)
    want = [r.codes for r in jgen.generate_long(session=js, seed=1, **kw)
            if r.action == "sample"]
    got = [r.codes for r in tgen.generate_long(session=ts, seed=2, **kw)
           if r.action == "sample"]
    assert len(want) == 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_init_dual_ar_has_the_jax_layout(tokenizer, name):
    cfg = make_cfg(tokenizer, name)
    jp = jdual.init_dual_ar(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = tdual.init_dual_ar(0, cfg, torch.bfloat16, "cpu")
    shape = lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1])
    assert (jax.tree_util.tree_map(shape, tp)
            == jax.tree_util.tree_map(lambda a: (a.shape, "bfloat16"), jp))
    w = tp["layers"]["wqkv"].float()
    assert abs(w.std().item() - cfg.initializer_range) < 2e-3
    assert tdual.param_count(tp) == jdual.param_count(jp)


def test_bridge_rejects_what_is_not_ported(tokenizer):
    """Quantized weights cross the bridge now (`tests/test_torch_quant.py`);
    the audio projector is still not ported."""
    cfg = make_cfg(tokenizer, "plain")
    jp = jax.tree_util.tree_map(
        np.asarray, jdual.init_dual_ar(jax.random.PRNGKey(0), cfg, jnp.float32))
    jp["layers"]["wo"] = {"q": jp["layers"]["wo"].astype(np.int8),
                          "s": np.ones(cfg.dim, np.float32)}
    assert dual_ar_from_jax(jp, device="cpu")["layers"]["wo"]["q"].dtype == torch.int8
    jp["audio_projector"] = {"w": np.ones((4, cfg.dim), np.float32)}
    with pytest.raises(NotImplementedError, match="not ported"):
        dual_ar_from_jax(jp, device="cpu")


def test_bucket_and_speaker_helpers_match_jax():
    for t, m in [(1, 4096), (64, 4096), (65, 4096), (600, 4096), (700, 1000),
                 (3000, 4096)]:
        assert tgen.pick_bucket(t, m) == jgen.pick_bucket(t, m)
    text = "<|speaker:0|>Hi there<|speaker:1|>Hello<|speaker:0|>" + "x" * 400
    turns = tgen.split_text_by_speaker(text)
    assert turns == jgen.split_text_by_speaker(text)
    assert (tgen.group_turns_into_batches(turns, 5, 100)
            == jgen.group_turns_into_batches(turns, 5, 100))
