"""The port's lockstep batch and pool-insert prefills against the JAX
package, on the CPU.

`GenerationSession(max_batch=B).generate_batch` left-pads B prompts to a
common end, prefills them at B rows with per-row offsets and decodes them
in lockstep, each row attending from its offset (JAX's `kv_valid`, the
decode kernels' `starts`). On tiny configs in float32:

  * `decode_slow_step(kv_valid=...)` over a left-padded batch gives hidden
    states within 1e-4 of JAX's (plain and int8 cache), and row 1's decode
    logits are within 3e-4 (absolute and relative) of a single-stream run
    of its prompt, on `tests/test_batch_generate.py`'s config and prompts
    and with its tolerance (the row's RoPE angles sit at other absolute
    positions);
  * greedy (top_k=1) `generate_batch` columns at prompt lengths (10, 6, 8)
    equal JAX's `generate_batch`, for plain fp32 and for `mixed` (slow
    int8, fast int4, heads int8, quantized by JAX and bridged) with the
    int8 KV cache;
  * a seed's sampled codes do not depend on first_chunk_size or
    decode_chunk_size, and row 0 of a batch draws what a single stream of
    the seed draws (`batch_seeds`);
  * the batch's bodies (prefill and decode at B rows) make no host sync,
    under `tests/test_torch_graph_step.py`'s raising dispatch mode;
  * `prefill_single_into_pool` and `prefill_group_into_pool` give JAX's
    greedy first columns, and the rows they insert equal JAX's within 1e-5
    (plain cache) or, under the int8 cache (whose scales JAX's inserts
    drop), JAX's prefilled scratch to one int8 step and one bf16 step of
    the scale (`tests/test_torch_kv8.py`'s bound); the other pool rows stay
    as they were.
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
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.models import dual_ar as tdual

from tests.test_dual_ar import random_prompt
from tests.test_torch_graph_step import _NoHostSync
from tests.test_torch_kv8 import _cfgs, _quantized
from tests.test_torch_slice import _prompt, make_cfg, make_params

torch.set_num_threads(1)
LENS = (10, 6, 8)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _models(tokenizer, name):
    """(JAX cfg, port cfg, JAX params, port params, kv_quant)."""
    if name == "plain":
        cfg = dataclasses.replace(make_cfg(tokenizer, "qwen3ish"), max_seq_len=64)
        jp, tp = make_params(cfg, seed=5)
        return cfg, cfg, jp, tp, False
    jcfg, cfg = _cfgs(tokenizer, max_seq_len=64)
    jp, tp = _quantized(jcfg, "int8", "int4", seed=6)
    return jcfg, cfg, jp, tp, True


def _left_padded(cfg, prompts, bucket):
    t_max = max(p.shape[1] for p in prompts)
    inp = np.zeros((len(prompts), cfg.num_codebooks + 1, bucket), np.int32)
    offsets = np.asarray([t_max - p.shape[1] for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        inp[i, :, offsets[i]:t_max] = p
    return inp, offsets, t_max


def _prompts(cfg, lens=LENS, seed=0):
    return [_prompt(cfg, t, seed=seed + i)[0] for i, t in enumerate(lens)]


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_kv_valid_decode_steps_match_jax(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    prompts = _prompts(cfg, seed=3)
    inp, offsets, t_max = _left_padded(cfg, prompts, 16)
    jc = jdual.init_kv_cache(jcfg, 3, 32, jnp.float32, quant=quant)
    tc = tdual.init_kv_cache(cfg, 3, 32, torch.float32, quant=quant)
    _, _, jc = jdual.prefill(jp, jcfg, jnp.asarray(inp), jc, jnp.asarray(offsets),
                             jnp.int32(t_max))
    _, _, tc = tdual.prefill(tp, cfg, torch.from_numpy(inp), tc,
                             torch.from_numpy(offsets), t_max)
    forced = _prompt(cfg, 4, seed=9)[0]
    for s in range(forced.shape[1]):
        token = np.repeat(forced[None, :, s], 3, axis=0)
        jhid, _, jc = jdual.decode_slow_step(jp, jcfg, jnp.asarray(token), jc,
                                             jnp.int32(t_max + s),
                                             kv_valid=jnp.asarray(offsets))
        thid, _, tc = tdual.decode_slow_step(tp, cfg, torch.from_numpy(token), tc,
                                             torch.tensor([t_max + s]),
                                             kv_valid=torch.from_numpy(offsets))
        _close(thid, jhid, 1e-4)


def test_batched_decode_row_matches_its_single_stream():
    """`tests/test_batch_generate.py::test_batched_decode_matches_single` on
    the port, with its config, prompts and bound: row 1 (offset 4) decoded
    in lockstep gives its own single-stream logits at each step."""
    cfg = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3)
    _, tp = make_params(cfg)
    tp = tdual.precompute_semantic_head(tp, cfg)
    rng = np.random.default_rng(1)
    p1, p2 = random_prompt(cfg, 10, rng), random_prompt(cfg, 6, rng)
    forced = random_prompt(cfg, 4, rng)
    cache = tdual.init_kv_cache(cfg, 1, 32, torch.float32)
    _, _, cache = tdual.prefill(tp, cfg, torch.from_numpy(p2[None]), cache,
                                torch.zeros((1,), dtype=torch.int32), 6)
    single = []
    for s in range(4):
        _, out, cache = tdual.decode_slow_step(
            tp, cfg, torch.from_numpy(forced[None, :, s]), cache, 6 + s)
        single.append(tdual.semantic_head_logits(tp, cfg, out)[0])
    inp, offsets, t_max = _left_padded(cfg, [p1, p2], 16)
    assert list(offsets) == [0, 4]
    bcache = tdual.init_kv_cache(cfg, 2, 32, torch.float32)
    _, _, bcache = tdual.prefill(tp, cfg, torch.from_numpy(inp), bcache,
                                 torch.from_numpy(offsets), t_max)
    for s in range(4):
        token = torch.from_numpy(np.stack([forced[:, s], forced[:, s]]))
        _, out, bcache = tdual.decode_slow_step(tp, cfg, token, bcache, t_max + s,
                                                kv_valid=torch.from_numpy(offsets))
        np.testing.assert_allclose(
            tdual.semantic_head_logits(tp, cfg, out)[1].numpy(), single[s].numpy(),
            rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_greedy_generate_batch_matches_jax(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    prompts = _prompts(cfg, seed=11)
    kw = dict(max_new_tokens=12, temperature=0.7, top_p=0.9, top_k=1)
    js = jgen.GenerationSession(jp, jcfg, SamplingConfig(), max_batch=3,
                                dtype=jnp.float32, decode_chunk_size=4,
                                kv_quant=quant, fuse_ffn=True)
    want = js.generate_batch(prompts, jax.random.PRNGKey(0), **kw)
    ts = tgen.GenerationSession(tp, cfg, TSamplingConfig(), max_batch=3,
                                dtype=torch.float32, decode_chunk_size=4,
                                kv_quant=quant)
    got = ts.generate_batch(prompts, 0, **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ts.eager_runs["prefill_3_64"] == 1 and ts.eager_runs["decode_3"] >= 11
    assert int(ts.state.pos) >= max(LENS) + 11
    # a batch of fewer rows than max_batch runs on buffers of its own
    two = ts.generate_batch(prompts[:2], 0, **kw)
    np.testing.assert_array_equal(two[0], want[0])
    assert sorted(ts._states) == [2, 3]


def test_seeded_batch_codes_do_not_depend_on_chunk_sizes(tokenizer):
    _, cfg, _, tp, _ = _models(tokenizer, "plain")
    prompts = _prompts(cfg, seed=21)
    kw = dict(max_new_tokens=15, temperature=0.8, top_p=0.9, top_k=30)
    runs = []
    for first, chunk in ((2, 4), (3, 5), (None, 4)):
        ts = tgen.GenerationSession(tp, cfg, TSamplingConfig(), max_batch=3,
                                    dtype=torch.float32, decode_chunk_size=chunk)
        runs.append(ts.generate_batch(prompts, 7, first_chunk_size=first, **kw))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    assert max(r.shape[1] for r in runs[0]) > 5
    # row 0 draws the uniforms of a single stream of the same seed
    assert tgen.batch_seeds(7, 3)[0] == 7 and len(set(tgen.batch_seeds(7, 3))) == 3
    single = tgen.GenerationSession(tp, cfg, TSamplingConfig(), dtype=torch.float32,
                                    decode_chunk_size=4)
    alone = single.generate_batch(prompts[:1], 7, **kw)[0]
    np.testing.assert_array_equal(alone, single.generate(prompts[0], 7, **kw))


def test_batch_bodies_make_no_host_sync(tokenizer):
    _, cfg, _, tp, quant = _models(tokenizer, "mixed")
    tp = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg))
    st = tgen.StepState(cfg, TSamplingConfig(), cfg.max_seq_len + 4, 4,
                        torch.float32, torch.float32, "cpu", quant, rows=3)
    inp, offsets, t_max = _left_padded(cfg, _prompts(cfg), 64)
    st.prompt(64).copy_(torch.from_numpy(inp))
    st.offsets.copy_(torch.from_numpy(offsets))
    st.t_end.fill_(t_max)
    st.seed.copy_(torch.tensor(tgen.batch_seeds(4, 3)))
    st.sampling.copy_(torch.tensor([0.8, 0.9, 30.0]))
    with _NoHostSync():
        tgen.prefill_body(tp, cfg, TSamplingConfig(), st, 64)
        tgen.decode_step(tp, cfg, TSamplingConfig(), st)
    assert int(st.pos) == t_max + 1 and int(st.step) == 1 and int(st.draw) == 2
    assert st.cols.shape[1:] == (3, cfg.num_codebooks + 1)


def _pool(cfg, rows, s, quant, seed):
    """A pool cache of random contents (the rows an insert must not touch)."""
    cache = tdual.init_kv_cache(cfg, rows, s, torch.float32, quant=quant)
    gen = torch.Generator().manual_seed(seed)
    for t in cache.values():
        t.copy_((torch.rand(t.shape, generator=gen) * 100 - 50).to(t.dtype))
    return cache


def _jax_cache(cache):
    return {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else
        jnp.int8 if v.dtype == torch.int8 else jnp.float32)
        for k, v in cache.items()}


def _check_inserted(pool, before, rows, want_pool, want_scratch, s):
    """Pool rows `rows`, positions [0, s), against JAX's inserted rows
    (plain: within 1e-5) or JAX's scratch (int8: one int8 step, one bf16
    step of the scale); every other row and position as it was."""
    for name, t in pool.items():
        got = t[:, rows, :s].float().numpy()
        if "ks" not in pool:
            _close(got, np.asarray(want_pool[name][:, rows, :s], np.float32), 1e-5)
        elif name in ("k", "v"):
            want = np.asarray(want_scratch[name], np.float32)
            assert np.abs(got - want).max() <= 1
        else:
            want = np.asarray(want_scratch[name].astype(jnp.float32))
            assert np.all(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-30)
        keep = np.ones(t.shape[1], bool)
        keep[rows] = False
        np.testing.assert_array_equal(t[:, keep].float().numpy(),
                                      before[name][:, keep].float().numpy())
        np.testing.assert_array_equal(t[:, rows, s:].float().numpy(),
                                      before[name][:, rows, s:].float().numpy())


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_prefill_single_into_pool_matches_jax(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    prompt = _prompt(cfg, 13, seed=31)
    inp = np.zeros((1, cfg.num_codebooks + 1, 16), np.int32)
    inp[..., :13] = prompt
    pool = _pool(cfg, 4, 40, quant, seed=1)
    before = {k: v.clone() for k, v in pool.items()}
    jpool = _jax_cache(pool)
    scratch = tdual.init_kv_cache(cfg, 1, 16, torch.float32, quant=quant)
    jscratch = jdual.init_kv_cache(jcfg, 1, 16, jnp.float32, quant=quant)
    scfg = SamplingConfig()
    jcol, jpool, jscratch = jgen.prefill_single_into_pool(
        jp, jcfg, scfg, jnp.asarray(inp), jpool, jscratch, jnp.int32(2),
        jnp.int32(13), jax.random.PRNGKey(0), jnp.float32(0.7), jnp.float32(0.9),
        jnp.int32(1))
    col, out, scratch = tgen.prefill_single_into_pool(
        tp, cfg, TSamplingConfig(), torch.from_numpy(inp), pool, scratch, 2, 13,
        5, (0.7, 0.9, 1))
    assert out is pool
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    _check_inserted(pool, before, [2], jpool, jscratch, 16)


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_prefill_group_into_pool_matches_jax(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    lens = (13, 9, 16)
    inp = np.zeros((3, cfg.num_codebooks + 1, 16), np.int32)
    for i, t in enumerate(lens):
        inp[i, :, :t] = _prompt(cfg, t, seed=40 + i)[0]
    pool = _pool(cfg, 5, 40, quant, seed=2)
    before = {k: v.clone() for k, v in pool.items()}
    jpool = _jax_cache(pool)
    rows = [4, 0, 2]
    jscratch = jdual.init_kv_cache(jcfg, 3, 16, jnp.float32, quant=quant)
    jcol, _, jpool, jscratch = jgen.prefill_group_into_pool(
        jp, jcfg, SamplingConfig(), jnp.asarray(inp), jpool, jscratch,
        jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32),
        jax.random.split(jax.random.PRNGKey(0), 3), jnp.full((3,), 0.7, jnp.float32),
        jnp.full((3,), 0.9, jnp.float32), jnp.ones((3,), jnp.int32))
    scratch = tdual.init_kv_cache(cfg, 3, 16, torch.float32, quant=quant)
    col, out, scratch = tgen.prefill_group_into_pool(
        tp, cfg, TSamplingConfig(), torch.from_numpy(inp), pool, scratch,
        torch.tensor(rows), torch.tensor(lens), [1, 2, 3], (0.7, 0.9, 1))
    assert out is pool and col.shape == (3, cfg.num_codebooks + 1)
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    _check_inserted(pool, before, rows, jpool, jscratch, 16)
