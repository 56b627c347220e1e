"""The port's capturable step bodies against the JAX package, on the CPU.

`generate.prefill_body` and `generate.decode_step` are what a CUDA graph of
the session captures: they read the position, token, RAS window, step index
and uniforms from fixed buffers (`StepState`) and leave nothing on the
host. On two tiny configs ("plain": fp32 weights and cache; "mixed":
slow int8, fast int4, heads int8, with the int8 KV cache, quantized by JAX
and bridged) in float32:

  * driven over chunks of 2, 4 and 4 steps with a tensor position, the
    decode body gives greedy (top_k=1) token columns identical to JAX's
    jitted `prefill_step` + `decode_chunk`, both sides running every step
    of every chunk (JAX's jitted quantization may put a KV scale one bf16
    step off the port's, ROADMAP §3; the columns are still equal);
  * the prefill body at two prompt buckets gives logits within 1e-4 of
    JAX's jitted `prefill`, and the same greedy first column as JAX's
    `prefill_step`;
  * on injected uniforms (top_k 30, top_p 0.9, temperature 0.7) the
    bodies' sampled columns equal a hand loop of the eager per-step path
    (host int positions, a fresh fast cache per frame) reading the same
    uniform block, and the session's `generate_stream` equals that loop on
    the blocks its generator fills;
  * neither body reads a tensor on the host: under a dispatch mode that
    raises on `_local_scalar_dense`, `nonzero` and the other syncing ops,
    one run of each completes;
  * a slow step at a position past the RoPE table (the overshoot of a last
    chunk) clamps as JAX's `dynamic_slice` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import sampling as tsamp

from tests.test_torch_kv8 import _cfgs, _quantized
from tests.test_torch_slice import _prompt, make_cfg, make_params

torch.set_num_threads(1)
ATOL = 1e-4
CHUNKS = (2, 4, 4)  # the first chunk, then two of the session's chunk size


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _models(tokenizer, name):
    """(JAX cfg, port cfg, JAX params, port params, kv_quant), both params
    prepared as the sessions prepare them (restricted head, fused FFN)."""
    if name == "plain":
        cfg = dataclasses.replace(make_cfg(tokenizer, "qwen3ish"), max_seq_len=128)
        jp, tp = make_params(cfg, seed=5)
        jcfg, quant = cfg, False
    else:
        jcfg, cfg = _cfgs(tokenizer)
        jp, tp = _quantized(jcfg, "int8", "int4", seed=6)
        quant = True
    jp = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jp, jcfg))
    tp = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg))
    return jcfg, cfg, jp, tp, quant


def _state(cfg, quant, n_steps=max(CHUNKS)):
    return tgen.StepState(cfg, TSamplingConfig(), cfg.max_seq_len + n_steps,
                          n_steps, torch.float32, torch.float32, "cpu", quant)


def _uniforms(cfg, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, tsamp.uniform_rows(cfg.num_codebooks),
                          tsamp.TOP_K_CAP))
    return torch.from_numpy(np.maximum(u, np.finfo(np.float32).tiny)
                            .astype(np.float32))


def _set_prompt(st, cfg, prompt, sampling):
    """The host's part: the padded prompt, t_end and the sampling
    numbers written into the fixed buffers; returns the bucket."""
    t = prompt.shape[1]
    bucket = min(tgen.pick_bucket(t, st.cache["k"].shape[2]), cfg.max_seq_len)
    inp = np.zeros((1, cfg.num_codebooks + 1, bucket), np.int32)
    inp[0, :, :t] = prompt
    st.prompt(bucket).copy_(torch.from_numpy(inp))
    st.t_end.fill_(t)
    st.sampling.copy_(torch.tensor(sampling, dtype=torch.float32))
    return bucket


def _run_bodies(tp, cfg, st, prompt, sampling, blocks):
    """The prefill body, then CHUNKS of decode steps; block c fills the
    uniforms of chunk c (block 0 row 0 those of the prefill's column).
    Returns the (C+1, 1 + sum(CHUNKS)) columns."""
    scfg = TSamplingConfig()
    bucket = _set_prompt(st, cfg, prompt, sampling)
    st.u[:1].copy_(blocks[0][:1])
    tgen.prefill_body(tp, cfg, scfg, st, bucket)
    cols = [st.token.clone()]
    for n, block in zip(CHUNKS, blocks[1:]):
        st.u[:n].copy_(block)
        st.step.zero_()
        for _ in range(n):
            tgen.decode_step(tp, cfg, scfg, st)
        assert int(st.step) == n
        cols.extend(st.cols[:n].clone())
    return torch.cat(cols).numpy().T


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_decode_body_greedy_columns_match_jax_decode_chunk(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    prompt = _prompt(cfg, 29, seed=7)[0]
    t = prompt.shape[1]
    st = _state(cfg, quant)
    blocks = [_uniforms(cfg, 1, 0)] + [_uniforms(cfg, n, i + 1)
                                       for i, n in enumerate(CHUNKS)]
    got = _run_bodies(tp, cfg, st, prompt, (0.7, 0.9, 1), blocks)

    scfg = SamplingConfig()
    jc = jdual.init_kv_cache(jcfg, 1, st.cache["k"].shape[2], jnp.float32,
                             quant=quant)
    bucket = max(st.inp)  # the one bucket the bodies ran
    inp = np.zeros((1, cfg.num_codebooks + 1, bucket), np.int32)
    inp[0, :, :t] = prompt
    key = jax.random.PRNGKey(0)
    sampling = (jnp.float32(0.7), jnp.float32(0.9), jnp.int32(1))
    column, jc = jgen.prefill_step(jp, jcfg, scfg, jnp.asarray(inp), jc,
                                   jnp.zeros((1,), jnp.int32), jnp.int32(t),
                                   key, *sampling)
    want = [np.asarray(column)]
    token, pos = column, jnp.int32(t)
    window = jnp.zeros((1, scfg.ras_win_size), jnp.int32)
    for n in CHUNKS:
        cols, token, jc, pos, window, key, _ = jgen.decode_chunk(
            jp, jcfg, scfg, n, token, jc, pos, window, key, *sampling)
        want.extend(np.asarray(cols))
    want = np.concatenate(want).T
    np.testing.assert_array_equal(got, want)
    assert int(st.pos) == t + sum(CHUNKS)


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_prefill_body_logits_match_jax_at_two_buckets(tokenizer, name,
                                                      monkeypatch):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    recorded = []
    prefill = tdual.prefill

    def recording_prefill(*args):
        out = prefill(*args)
        recorded.append(out[0].clone())
        return out

    monkeypatch.setattr(tdual, "prefill", recording_prefill)
    jprefill = jax.jit(jdual.prefill, static_argnums=(1,))
    scfg = SamplingConfig()
    buckets = []
    for t in (37, 90):
        st = _state(cfg, quant)
        prompt = _prompt(cfg, t, seed=t)[0]
        bucket = _set_prompt(st, cfg, prompt, (1.0, 0.9, 1))
        st.u[:1].copy_(_uniforms(cfg, 1, t))
        tgen.prefill_body(tp, cfg, TSamplingConfig(), st, bucket)
        buckets.append(bucket)

        inp = jnp.asarray(st.prompt(bucket).numpy())
        jc = jdual.init_kv_cache(jcfg, 1, st.cache["k"].shape[2], jnp.float32,
                                 quant=quant)
        off = jnp.zeros((1,), jnp.int32)
        logits, _, jc2 = jprefill(jp, jcfg, inp, jc, off, jnp.int32(t))
        _close(recorded[-1], logits)
        if not quant:
            _close(st.cache["k"][:, :, :bucket], jc2["k"][:, :, :bucket])
        column, _ = jgen.prefill_step(jp, jcfg, scfg, inp, jc, off,
                                      jnp.int32(t), jax.random.PRNGKey(0),
                                      jnp.float32(1.0), jnp.float32(0.9),
                                      jnp.int32(1))
        np.testing.assert_array_equal(st.token.numpy(), np.asarray(column))
        assert int(st.pos) == t and not st.window.any()
    assert buckets == [64, 128]


def _column(tp, cfg, scfg, logits, hidden, window, u, sampling):
    temperature, top_p, top_k = sampling
    state = tsamp.topk_state(logits)
    main = tdual.semantic_index_to_token(
        cfg, tsamp.sample_topk(state, temperature, top_p, top_k, u=u[0]))
    if window is not None:
        high = tdual.semantic_index_to_token(cfg, tsamp.sample_topk(
            state, scfg.ras_high_temp, scfg.ras_high_top_p, top_k, u=u[1]))
        main = tsamp.ras_select(main, high, window, cfg.semantic_begin_id,
                                cfg.semantic_end_id)
    code = torch.clamp(main - cfg.semantic_begin_id, 0, cfg.codebook_size - 1)
    codes = [main, code]
    fc = tdual.init_fast_kv_cache(cfg, 1, torch.float32)
    _, fc = tdual.fast_decode_step(tp, cfg, tdual.fast_project_in(tp, cfg, hidden),
                                   fc, 0, with_logits=False)
    for i in range(1, cfg.num_codebooks):
        logits_i, fc = tdual.fast_decode_step(
            tp, cfg, tdual.fast_embed(tp, cfg, code), fc, i)
        code = tsamp.sample_topk(tsamp.topk_state(logits_i), temperature,
                                 top_p, top_k, u=u[1 + i])
        codes.append(code)
    return torch.stack(codes, dim=1).to(torch.int32)


def _eager_columns(tp, cfg, quant, prompt, sampling, blocks):
    scfg = TSamplingConfig()
    t = prompt.shape[1]
    cache = tdual.init_kv_cache(cfg, 1, cfg.max_seq_len + max(CHUNKS),
                                torch.float32, quant=quant)
    bucket = min(tgen.pick_bucket(t, cache["k"].shape[2]), cfg.max_seq_len)
    inp = np.zeros((1, cfg.num_codebooks + 1, bucket), np.int32)
    inp[0, :, :t] = prompt
    logits, hidden, cache = tdual.prefill(
        tp, cfg, torch.from_numpy(inp), cache,
        torch.zeros((1,), dtype=torch.int32), t)
    token = _column(tp, cfg, scfg, tgen._restricted_logits(cfg, logits), hidden,
                    None, blocks[0][0], sampling)
    cols = [token]
    window = torch.zeros((1, scfg.ras_win_size), dtype=torch.int32)
    pos = t
    for n, block in zip(CHUNKS, blocks[1:]):
        for step in range(n):
            hidden, slow_out, cache = tdual.decode_slow_step(tp, cfg, token,
                                                             cache, pos)
            token = _column(tp, cfg, scfg,
                            tdual.semantic_head_logits(tp, cfg, slow_out),
                            hidden, window, block[step], sampling)
            window = torch.cat([window[:, 1:], token[:, :1]], dim=1)
            cols.append(token)
            pos += 1
    return torch.cat(cols).numpy().T


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_sampled_columns_equal_a_hand_loop_on_injected_uniforms(tokenizer, name):
    _, cfg, _, tp, quant = _models(tokenizer, name)
    prompt = _prompt(cfg, 33, seed=8)[0]
    sampling = (0.7, 0.9, 30)
    blocks = [_uniforms(cfg, 1, 10)] + [_uniforms(cfg, n, 11 + i)
                                        for i, n in enumerate(CHUNKS)]
    got = _run_bodies(tp, cfg, _state(cfg, quant), prompt, sampling, blocks)
    want = _eager_columns(tp, cfg, quant, prompt, sampling, blocks)
    np.testing.assert_array_equal(got, want)
    # sampled, not greedy: some column differs from the argmax path
    greedy = _run_bodies(tp, cfg, _state(cfg, quant), prompt, (0.7, 0.9, 1),
                         blocks)
    assert not np.array_equal(got, greedy)


def test_session_stream_equals_the_hand_loop_on_its_generator(tokenizer):
    """`generate_stream` fills row 0 of the block for the prefill, then
    each chunk's rows, from the request's generator, in that order."""
    _, cfg, _, tp, _ = _models(tokenizer, "plain")
    prompt = _prompt(cfg, 33, seed=9)[0]
    session = tgen.GenerationSession(tp, cfg, TSamplingConfig(),
                                     dtype=torch.float32,
                                     decode_chunk_size=CHUNKS[1],
                                     first_chunk_size=CHUNKS[0])
    budget = 1 + sum(CHUNKS)
    kw = dict(max_new_tokens=budget, temperature=0.7, top_p=0.9, top_k=30)
    got = list(session.generate_stream(prompt, session.new_generator(3), **kw))
    gen = torch.Generator().manual_seed(3)
    blocks = [tsamp.fill_uniforms(torch.empty(
        (n, tsamp.uniform_rows(cfg.num_codebooks), tsamp.TOP_K_CAP)), gen)
        for n in (1, *CHUNKS)]
    want = _eager_columns(tp, cfg, False, prompt, (0.7, 0.9, 30), blocks)
    end = np.flatnonzero(want[0] == cfg.im_end_id)
    want = want[:, : end[0] + 1] if len(end) else want
    np.testing.assert_array_equal(got[-1], want)
    assert [g.shape[1] for g in got][:2] == [1, 1 + CHUNKS[0]]
    assert session.eager_runs["decode"] >= CHUNKS[0] and not session.replays
    assert session.precompile(33, budget) == {}


class _NoHostSync(TorchDispatchMode):
    """Raises on the ops that make the host wait for a tensor's value,
    indexing by a boolean mask (a `nonzero` inside the kernel) included."""

    SYNCS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
             torch.ops.aten.is_nonzero, torch.ops.aten.item,
             torch.ops.aten.masked_select, torch.ops.aten.equal}
    INDEXING = {torch.ops.aten.index, torch.ops.aten.index_put,
                torch.ops.aten.index_put_}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in self.SYNCS or (packet in self.INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1])):
            raise RuntimeError(f"host sync in a step body: {func}")
        return func(*args, **(kwargs or {}))


def test_the_no_sync_mode_catches_syncs():
    x = torch.arange(4)
    for sync in (lambda: x[0].item(), lambda: x[x > 1], lambda: bool(x[1]),
                 lambda: int(x.sum()), lambda: x.__setitem__(x > 2, 0)):
        with pytest.raises(RuntimeError, match="host sync"):
            with _NoHostSync():
                sync()


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_step_bodies_make_no_host_sync(tokenizer, name):
    _, cfg, _, tp, quant = _models(tokenizer, name)
    st = _state(cfg, quant)
    bucket = _set_prompt(st, cfg, _prompt(cfg, 21, seed=4)[0], (0.8, 0.9, 30))
    st.u.copy_(_uniforms(cfg, st.u.shape[0], 4))
    with _NoHostSync():
        tgen.prefill_body(tp, cfg, TSamplingConfig(), st, bucket)
        tgen.decode_step(tp, cfg, TSamplingConfig(), st)
    assert int(st.pos) == 22 and int(st.step) == 1


def test_slow_step_past_the_rope_table_clamps_as_jax(tokenizer):
    cfg = dataclasses.replace(make_cfg(tokenizer, "plain"), max_seq_len=64)
    jp, tp = make_params(cfg, seed=3)
    inp = _prompt(cfg, 64, seed=3)
    jc = jdual.init_kv_cache(cfg, 1, 72, jnp.float32)
    tc = tdual.init_kv_cache(cfg, 1, 72, torch.float32)
    _, _, jc = jdual.prefill(jp, cfg, jnp.asarray(inp), jc,
                             jnp.zeros((1,), jnp.int32), jnp.int32(64))
    _, _, tc = tdual.prefill(tp, cfg, torch.from_numpy(inp), tc,
                             torch.zeros((1,), dtype=torch.int32), 64)
    for pos in (64, 66, 70):  # past the 64 rows of the table
        token = _prompt(cfg, 1, seed=pos)[:, :, 0]
        jhid, _, jc = jdual.decode_slow_step(jp, cfg, jnp.asarray(token), jc,
                                             jnp.int32(pos))
        thid, _, tc = tdual.decode_slow_step(
            tp, cfg, torch.from_numpy(token), tc, torch.tensor([pos]))
        _close(thid, jhid)
        _close(tc["k"][:, :, pos], jc["k"][:, :, pos])
