"""The int8 KV cache and the quantized slice against the JAX package, on
the CPU.

  * `_kv_quant` / `_kv_dequant` give bitwise-equal results (eager on both
    sides);
  * prefill logits are identical with and without the int8 cache (prefill
    attends the fresh k/v; only the store is quantized), and within 1e-4 of
    JAX's; the stored cache matches JAX's: int8 values equal or one step
    apart and bf16 scales within one bf16 step (JAX runs prefill under jit,
    where XLA may divide by 127 as a product with the reciprocal);
  * the int8-KV decode kernel's plain version agrees with JAX's
    `gqa_attention_kv8` masked to j <= pos to 1e-5 (fp32);
  * decode steps over the int8 cache agree with JAX's to 1e-4;
  * the slice: a tiny model in `mixed` (slow int8, fast int4, heads int8)
    with `kv_quant` gives greedy token columns identical to JAX's
    `GenerationSession(kv_quant=True)`, prefill logits within 1e-4.
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
from fish_speech_tpu.ops import attention as jattn
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import attention as tattn
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention_kv8, flash_decode_kv8_reference)

torch.set_num_threads(1)
ATOL = 1e-4

# untied head (an int8 LM head), qk-norm, fast_dim != dim
TINY = dict(n_layer=2, n_head=4, n_local_heads=2, head_dim=16, dim=64,
            intermediate_size=128, max_seq_len=128, codebook_size=32,
            num_codebooks=3, n_fast_layer=2, fast_dim=32, fast_n_head=2,
            fast_n_local_heads=1, fast_head_dim=16, fast_intermediate_size=64,
            tie_word_embeddings=False, attention_qk_norm=True,
            norm_fastlayer_input=True)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (1, 7, 8, 128), (4, 1, 2, 64)])
def test_kv_quant_is_bitwise_jax(shape):
    x = _rand(np.random.default_rng(0), *shape) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero vector: scale 0, values 0
    tq, ts = tdual._kv_quant(torch.from_numpy(x))
    jq, js = jdual._kv_quant(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_f32(ts), _f32(js))
    np.testing.assert_array_equal(
        tdual._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jdual._kv_dequant(jq, js, jnp.float32)))


@pytest.mark.parametrize("g,lengths", [(4, [1]), (4, [37]), (3, [64, 9]),
                                       (1, [20, 64])])
def test_kv8_decode_plain_matches_jax_masked_einsum(g, lengths):
    rng = np.random.default_rng(1)
    n_layer, s, hkv, d = 3, 64, 2, 32
    b = len(lengths)
    q = _rand(rng, b, hkv, g, d)
    kf, vf = _rand(rng, n_layer, b, s, hkv, d), _rand(rng, n_layer, b, s, hkv, d)
    kq, ks = jdual._kv_quant(jnp.asarray(kf))
    vq, vs = jdual._kv_quant(jnp.asarray(vf))
    lens = np.asarray(lengths, np.int32)
    layer = 1
    mask = (np.arange(s)[None, :] < lens[:, None])[:, None, :]  # (B, 1, S)
    want = jattn.gqa_attention_kv8(
        jnp.asarray(q.reshape(b, 1, hkv * g, d)), kq[layer], ks[layer],
        vq[layer], vs[layer], jnp.asarray(mask))
    q_t = torch.from_numpy(q)
    kq_t = torch.from_numpy(np.asarray(kq))
    vq_t = torch.from_numpy(np.asarray(vq))
    ks_t = torch.from_numpy(_f32(ks)).to(torch.bfloat16)
    vs_t = torch.from_numpy(_f32(vs)).to(torch.bfloat16)
    got = flash_decode_kv8_reference(q_t, kq_t, ks_t, vq_t, vs_t, layer,
                                     torch.from_numpy(lens))
    _close(got.reshape(b, 1, hkv * g, d), want, atol=1e-5)
    # the einsum itself, and the wrapper on CPU tensors (no launch counted)
    _close(tattn.gqa_attention_kv8(
        q_t.reshape(b, 1, hkv * g, d), kq_t[layer], ks_t[layer],
        vq_t[layer], vs_t[layer], torch.from_numpy(mask)), want, atol=1e-5)
    n0 = flash_decode_attention_kv8.launches
    _close(flash_decode_attention_kv8(q_t, kq_t, ks_t, vq_t, vs_t, layer,
                                      torch.from_numpy(lens)), got, atol=0)
    assert flash_decode_attention_kv8.launches == n0


def _cfgs(tokenizer, **kw):
    jcfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id, **{**TINY, **kw})
    return jcfg, config_from_jax(jcfg, DualARConfig)


def _quantized(jcfg, mode, fast_mode, seed=0):
    """JAX random weights, quantized by JAX, bridged: both packages decode
    the very same integers and scales."""
    jp = jdual.init_dual_ar(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    jq = jquant.quantize_dual_ar_lowmem(jp, mode=mode, fast_mode=fast_mode)
    tq = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                          dtype=torch.float32, device="cpu")
    return jq, tq


def _prompt(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    inp = np.zeros((1, cfg.num_codebooks + 1, t), np.int32)
    inp[0, 0] = rng.integers(0, 256, size=t)
    sem = rng.random(t) < 0.5
    inp[0, 0, sem] = cfg.semantic_begin_id + rng.integers(0, cfg.codebook_size,
                                                          size=sem.sum())
    inp[0, 1:, :] = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
    return inp


@pytest.mark.parametrize("mode,fast_mode", [("int8", "int4"), ("int4", None)])
def test_prefill_over_the_int8_cache_matches_jax(tokenizer, mode, fast_mode):
    jcfg, cfg = _cfgs(tokenizer)
    jq, tq = _quantized(jcfg, mode, fast_mode)
    t, t_end = 40, 33
    inp = _prompt(cfg, t)
    off_t = torch.zeros((1,), dtype=torch.int32)
    logits = {}
    for quant in (False, True):
        cache = tdual.init_kv_cache(cfg, 1, 64, torch.float32, quant=quant)
        logits[quant], _, cache = tdual.prefill(tq, cfg, torch.from_numpy(inp),
                                                cache, off_t, t_end)
    np.testing.assert_array_equal(logits[True].numpy(), logits[False].numpy())
    assert cache["k"].dtype == torch.int8 and cache["ks"].dtype == torch.bfloat16
    jc = jdual.init_kv_cache(jcfg, 1, 64, jnp.float32, quant=True)
    jl, _, jc = jdual.prefill(jq, jcfg, jnp.asarray(inp), jc,
                              jnp.zeros((1,), jnp.int32), jnp.int32(t_end))
    _close(logits[True], jl)
    for name in ("k", "v"):
        assert np.abs(cache[name].numpy().astype(np.int32)
                      - np.asarray(jc[name]).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(_f32(cache[name + "s"]), _f32(jc[name + "s"]),
                                   rtol=2.0 ** -8, atol=0)


def test_decode_steps_over_the_int8_cache_match_jax(tokenizer):
    jcfg, cfg = _cfgs(tokenizer)
    jq, tq = _quantized(jcfg, "int8", "int4", seed=1)
    jq = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jq, jcfg))
    tq = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tq, cfg))
    inp = _prompt(cfg, 32, seed=1)
    t_end = 24
    jc = jdual.init_kv_cache(jcfg, 1, 48, jnp.float32, quant=True)
    tc = tdual.init_kv_cache(cfg, 1, 48, torch.float32, quant=True)
    _, _, jc = jdual.prefill(jq, jcfg, jnp.asarray(inp), jc,
                             jnp.zeros((1,), jnp.int32), jnp.int32(t_end))
    _, _, tc = tdual.prefill(tq, cfg, torch.from_numpy(inp), tc,
                             torch.zeros((1,), dtype=torch.int32), t_end)
    # start both from JAX's stored cache, so only the step is compared
    for k in tc:
        tc[k].copy_(torch.from_numpy(_f32(jc[k])).to(tc[k].dtype))
    for pos in range(t_end, t_end + 3):
        token = _prompt(cfg, 1, seed=pos)[:, :, 0]
        jhid, jslow, jc = jdual.decode_slow_step(jq, jcfg, jnp.asarray(token),
                                                 jc, jnp.int32(pos))
        thid, tslow, tc = tdual.decode_slow_step(tq, cfg,
                                                 torch.from_numpy(token), tc, pos)
        _close(thid, jhid)
        _close(tdual.semantic_head_logits(tq, cfg, tslow),
               jdual.semantic_head_logits(jq, jcfg, jslow))


@pytest.mark.parametrize("mode,fast_mode", [("int8", "int4"), ("int4", None),
                                            ("int8", None)])
def test_greedy_quantized_kv8_session_matches_jax(tokenizer, mode, fast_mode):
    jcfg, cfg = _cfgs(tokenizer)
    jq, tq = _quantized(jcfg, mode, fast_mode, seed=2)
    js = jgen.GenerationSession(jq, jcfg, SamplingConfig(), max_batch=1,
                                dtype=jnp.float32, decode_chunk_size=4,
                                first_chunk_size=2, kv_quant=True)
    ts = tgen.GenerationSession(tq, cfg, TSamplingConfig(), max_batch=1,
                                dtype=torch.float32, decode_chunk_size=4,
                                first_chunk_size=2, kv_quant=True)
    assert ts.cache["k"].dtype == torch.int8 and "w13" in ts.params["layers"]
    prompt = _prompt(cfg, 29, seed=3)[0]
    kw = dict(max_new_tokens=12, temperature=0.7, top_p=0.9, top_k=1)
    want = list(js.generate_stream(prompt, jax.random.PRNGKey(0), **kw))
    got = list(ts.generate_stream(prompt, ts.new_generator(7), **kw))
    assert len(got) == len(want) and want[-1].shape[1] > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_session_options_follow_jax(tokenizer):
    jcfg, cfg = _cfgs(tokenizer)
    _, tq = _quantized(jcfg, "int8", None)
    session = tgen.GenerationSession(tq, cfg, dtype=torch.float32)
    fused = session.params["layers"]["w13"]  # fused at batch 1, as in JAX
    assert "w1" not in session.params["layers"] and fused["q"].dtype == torch.int8
    assert fused["q"].shape[-1] == 2 * tq["layers"]["w1"]["q"].shape[-1]
    assert session.cache["k"].dtype == torch.float32 and "ks" not in session.cache
    assert session.params["_semantic_head"]["q"].dtype == torch.int8
    # a lockstep session of 2 rows: its cache has 2 rows, and it refuses
    # the prefix cache, which JAX's lockstep batch never uses
    batch = tgen.GenerationSession(tq, cfg, max_batch=2, dtype=torch.float32)
    assert batch.cache["k"].shape[1] == 2 and batch.state.rows == 2
    with pytest.raises(ValueError, match="prefix_cache_size"):
        tgen.GenerationSession(tq, cfg, max_batch=2, prefix_cache_size=2)
    cfg2 = dataclasses.replace(cfg, max_seq_len=64)
    assert tgen.GenerationSession(tq, cfg2, kv_quant=True).cache["vs"].shape == (
        cfg.n_layer, 1, 64 + 32, cfg.n_local_heads)
