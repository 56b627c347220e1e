"""The decode pool's device steps against the JAX package, on the CPU.

The continuous batcher (`engine/batcher.py`) drives four pieces of
`fish_speech_tpu_torch.generate` / `models/dual_ar.py`, each held here to
its JAX counterpart on tiny float32 configs ("plain": fp32 weights and
cache; "mixed": slow int8, fast int4, heads int8 with the int8 KV cache,
quantized by JAX and bridged), with numpy inputs from a seed:

  * `sample_topk` with per-row temperature, top_p and top_k on JAX's own
    uniforms gives the indices of JAX's `sample_topk_rows`;
  * `decode_slow_step_multi` with ragged positions and inactive rows: hidden
    states within 1e-4, the written rows within 1e-4 (int8 values within one
    step, the scales within one bf16 step), inactive rows' cache bitwise
    unchanged;
  * the pool step body `pool_decode_step`, driven over sub-chunks of 2, 4
    and 4 steps, against JAX's jitted `decode_chunk_multi`: identical greedy
    (top_k=1) columns, positions and active flags, also with a head that
    makes rows emit `<|im_end|>` and turn inactive;
  * the group prefill body `prefill_group_body` against
    `prefill_group_parked` at k=4 with one padded row: identical first
    columns, cache rows within 1e-4;
  * `scatter_parked_rows` against JAX's: the same pool;
  * a sampled row's columns do not depend on its slot or its neighbours
    (`counter_uniforms`), and the uniforms are a pure function of (seed,
    draw) spread evenly over (0, 1);
  * the bodies and the host's admission writes make no host sync.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.ops import sampling as jsamp
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import sampling as tsamp

from tests.test_torch_graph_step import CHUNKS, _NoHostSync, _close, _models

torch.set_num_threads(1)
P = 4  # pool rows of the step tests


def _cache(cfg, rows, s, quant, seed):
    """A random slow cache as numpy arrays: N(0,1) fp32, or int8 values and
    positive scales (exact in bf16) for the int8 layout."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layer, rows, s, cfg.n_local_heads, cfg.head_dim)
    if not quant:
        return {n: rng.standard_normal(shape).astype(np.float32) for n in "kv"}
    out = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in "kv"}
    for n in ("ks", "vs"):
        sc = torch.from_numpy(rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32))
        out[n] = sc.to(torch.bfloat16).float().numpy()
    return out


def _jax_cache(c):
    return {n: jnp.asarray(a, jnp.bfloat16 if n in ("ks", "vs") else None)
            for n, a in c.items()}


def _torch_cache(c):
    return {n: torch.from_numpy(a.copy()).to(torch.bfloat16)
            if n in ("ks", "vs") else torch.from_numpy(a.copy())
            for n, a in c.items()}


def _tokens(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    tok = np.zeros((rows, cfg.num_codebooks + 1), np.int32)
    tok[:, 0] = cfg.semantic_begin_id + rng.integers(0, cfg.codebook_size, rows)
    tok[:, 1:] = rng.integers(0, cfg.codebook_size, (rows, cfg.num_codebooks))
    return tok


def _cache_close(got, want, quant, rows=None):
    for n in got:
        g = got[n].float().numpy()
        w = np.asarray(jnp.asarray(want[n], jnp.float32))
        if rows is not None:
            g, w = g[:, rows], w[:, rows]
        if not quant:
            _close(g, w)
        elif n in ("k", "v"):  # JAX's jitted scale may sit 1 ulp off
            assert np.abs(g - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("params", ["rows", "scalars"])
def test_sample_topk_rows_matches_jax_on_its_uniforms(params):
    rng = np.random.default_rng(0)
    b, v = 7, 300
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if params == "rows":
        temp = np.array([0.3, 0.7, 1.0, 1.3, 0.8, 0.5, 1.0], np.float32)
        top_p = np.array([0.9, 0.5, 1.0, 0.8, 0.99, 0.3, 0.7], np.float32)
        top_k = np.array([1, 5, 30, 64, 100, 10, 2], np.int32)
        targs = tuple(torch.from_numpy(x) for x in (temp, top_p, top_k))
    else:
        temp, top_p, top_k = 0.8, 0.9, 30
        targs = (temp, top_p, top_k)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    want = jsamp.sample_topk_rows(keys, jsamp.topk_state(jnp.asarray(logits)),
                                  temp, top_p, top_k)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (jsamp.TOP_K_CAP,), jnp.float32,
        minval=jnp.finfo(jnp.float32).tiny))(keys)
    got = tsamp.sample_topk(tsamp.topk_state(torch.from_numpy(logits)),
                            *targs, u=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_counter_uniforms_depend_only_on_seed_and_draw():
    seeds = torch.tensor([5, 9, 5, 2**35 + 5], dtype=torch.int64)
    draws = torch.tensor([3, 3, 4, 3], dtype=torch.int64)
    u = tsamp.counter_uniforms(seeds, draws, 11)
    assert u.shape == (4, 11, tsamp.TOP_K_CAP) and u.dtype == torch.float32
    alone = tsamp.counter_uniforms(seeds[:1], draws[:1], 11)
    assert torch.equal(u[0], alone[0])  # not its neighbours
    assert torch.equal(u[0], u[3])  # the seed's low 32 bits
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    many = tsamp.counter_uniforms(torch.arange(32), torch.arange(32) * 7, 11)
    assert 0 < float(many.min()) and float(many.max()) < 1
    hist = torch.histc(many, bins=16, min=0, max=1).numpy()
    expected = many.numel() / 16
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 40  # 15 degrees of freedom: p ~ 5e-4


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_decode_slow_step_multi_matches_jax(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    s = cfg.max_seq_len + 8
    start = _cache(cfg, P, s, quant, seed=1)
    token = _tokens(cfg, P, seed=2)
    pos = np.array([5, 40, 0, s - 9], np.int64)
    active = np.array([True, False, True, True])
    jh, jout, jc = jdual.decode_slow_step_multi(
        jp, jcfg, jnp.asarray(token), _jax_cache(start),
        jnp.asarray(pos, jnp.int32), jnp.asarray(active))
    tc = _torch_cache(start)
    th, tout, tc = tdual.decode_slow_step_multi(
        tp, cfg, torch.from_numpy(token), tc, torch.from_numpy(pos),
        torch.from_numpy(active))
    _close(th, jh)
    _close(tout, jout)
    _cache_close(tc, jc, quant)
    for n, t in tc.items():  # the inactive row: bitwise as it was
        np.testing.assert_array_equal(t[:, 1].float().numpy(),
                                      _torch_cache(start)[n][:, 1].float().numpy())


def _pool(cfg, quant, seed, sampling):
    """A pool of P rows over a random cache: ragged positions, row 1
    inactive; returns (PoolState, the JAX carry, the cache's start)."""
    st = tgen.PoolState(cfg, TSamplingConfig(), P, cfg.max_seq_len + 16,
                        max(CHUNKS), torch.float32, torch.float32, "cpu", quant)
    start = _cache(cfg, P, cfg.max_seq_len + 16, quant, seed)
    for n, t in _torch_cache(start).items():
        st.cache[n].copy_(t)
    token = _tokens(cfg, P, seed + 1)
    pos = np.array([9, 30, 17, 50], np.int64)
    active = np.array([True, False, True, True])
    st.token.copy_(torch.from_numpy(token))
    st.pos.copy_(torch.from_numpy(pos))
    st.active.copy_(torch.from_numpy(active))
    st.seed.copy_(torch.arange(P) + 100)
    st.sampling.copy_(torch.tensor(sampling, dtype=torch.float32)[:, None].expand(3, P))
    jcarry = dict(token=jnp.asarray(token), cache=_jax_cache(start),
                  pos=jnp.asarray(pos, jnp.int32),
                  window=jnp.zeros((P, SamplingConfig().ras_win_size), jnp.int32),
                  keys=jax.random.split(jax.random.PRNGKey(0), P),
                  active=jnp.asarray(active))
    return st, jcarry, start


def _bias_im_end(jp, tp):
    """Scale the head's im_end column so that rows emit im_end."""
    jp = dict(jp, _semantic_head={"w": jp["_semantic_head"]["w"].at[:, -1].multiply(50.0)})
    w = tp["_semantic_head"]["w"].clone()
    w[:, -1] *= 50.0
    return jp, dict(tp, _semantic_head={"w": w})


@pytest.mark.parametrize("name,im_end", [("plain", False), ("plain", True),
                                         ("mixed", False)])
def test_pool_step_greedy_columns_match_jax_decode_chunk_multi(tokenizer, name,
                                                               im_end):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    if im_end:
        jp, tp = _bias_im_end(jp, tp)
    sampling = (0.7, 0.9, 1)
    st, jc, start = _pool(cfg, quant, seed=3, sampling=sampling)
    scfg = TSamplingConfig()
    got, want = [], []
    for n in CHUNKS:
        st.step.zero_()
        for _ in range(n):
            tgen.pool_decode_step(tp, cfg, scfg, st)
        assert int(st.step) == n
        got.append(st.cols[:n].clone().numpy())
        cols, jc["token"], jc["cache"], jc["pos"], jc["window"], jc["keys"], \
            jc["active"] = jgen.decode_chunk_multi(
                jp, jcfg, SamplingConfig(), n, jc["token"], jc["cache"],
                jc["pos"], jc["window"], jc["keys"], jc["active"],
                jnp.full((P,), sampling[0], jnp.float32),
                jnp.full((P,), sampling[1], jnp.float32),
                jnp.full((P,), sampling[2], jnp.int32))
        want.append(np.asarray(cols))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(jc["active"]))
    np.testing.assert_array_equal(st.window.numpy(), np.asarray(jc["window"]))
    ended = ~st.active.numpy()
    assert ended[1] and (ended.sum() > 1) == im_end
    # the inactive row's cache stays as it was
    for n, t in st.cache.items():
        np.testing.assert_array_equal(t[:, 1].float().numpy(),
                                      _torch_cache(start)[n][:, 1].float().numpy())
    _cache_close(st.cache, jc["cache"], quant)


def test_sampled_pool_row_is_independent_of_slot_and_neighbours(tokenizer):
    """A row's sampled columns (top_k 30) are the same in a pool of P rows
    and alone in a pool of one, in another slot."""
    _, cfg, _, tp, _ = _models(tokenizer, "plain")
    scfg = TSamplingConfig()
    st, _, start = _pool(cfg, False, seed=4, sampling=(0.8, 0.9, 30))
    one = tgen.PoolState(cfg, scfg, 1, cfg.max_seq_len + 16, max(CHUNKS),
                         torch.float32, torch.float32, "cpu", False)
    for n, t in _torch_cache(start).items():
        one.cache[n].copy_(t[:, 2:3])
    for name in ("token", "pos", "active", "seed", "window", "draw"):
        getattr(one, name).copy_(getattr(st, name)[2:3])
    one.sampling.copy_(st.sampling[:, 2:3])
    cols = {}
    for key, state in (("pool", st), ("alone", one)):
        out = []
        for n in CHUNKS:
            state.step.zero_()
            for _ in range(n):
                tgen.pool_decode_step(tp, cfg, scfg, state)
            out.append(state.cols[:n].clone())
        cols[key] = torch.cat(out)
    np.testing.assert_array_equal(cols["pool"][:, 2].numpy(), cols["alone"][:, 0].numpy())
    greedy = _pool(cfg, False, seed=4, sampling=(0.8, 0.9, 1))[0]
    greedy.step.zero_()
    for _ in range(CHUNKS[0]):
        tgen.pool_decode_step(tp, cfg, scfg, greedy)
    assert not np.array_equal(greedy.cols[:CHUNKS[0], 2].numpy(),
                              cols["pool"][:CHUNKS[0], 2].numpy())


def _group_inputs(cfg, k, bucket, t_ends):
    inp = np.zeros((k, cfg.num_codebooks + 1, bucket), np.int32)
    rng = np.random.default_rng(sum(t_ends))
    for j, t in enumerate(t_ends):
        inp[j, 0, :t] = rng.integers(0, 256, t)
        inp[j, 1:, :t] = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, t))
    return inp


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_group_prefill_body_matches_prefill_group_parked(tokenizer, name):
    jcfg, cfg, jp, tp, quant = _models(tokenizer, name)
    k, bucket = 4, 64
    t_ends = [37, 20, 61, 1]  # the last row pads the group of 3 to 4
    inp = _group_inputs(cfg, k, bucket, t_ends[:3])
    temps, top_ps, top_ks = [0.7, 0.7, 0.7, 1.0], [0.9, 0.9, 0.9, 1.0], [1, 1, 1, 1]
    gs = tgen.GroupState(cfg, TSamplingConfig(), k, 128, torch.float32,
                         torch.float32, "cpu", quant)
    gs.prompt(bucket).copy_(torch.from_numpy(inp))
    gs.t_end.copy_(torch.tensor(t_ends))
    gs.seed.copy_(torch.tensor([7, 8, 9, 0]))
    gs.sampling.copy_(torch.tensor([temps, top_ps, top_ks], dtype=torch.float32))
    tgen.prefill_group_body(tp, cfg, TSamplingConfig(), gs, bucket)

    jc = jdual.init_kv_cache(jcfg, k, bucket, jnp.float32, quant=quant)
    column, _, jc = jgen.prefill_group_parked(
        jp, jcfg, SamplingConfig(), jnp.asarray(inp), jc,
        jnp.asarray(t_ends, jnp.int32), jax.random.split(jax.random.PRNGKey(1), k),
        jnp.asarray(temps, jnp.float32), jnp.asarray(top_ps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32))
    np.testing.assert_array_equal(gs.column.numpy(), np.asarray(column))
    _cache_close({n: t[:, :, :bucket] for n, t in gs.cache.items()}, jc, quant,
                 rows=slice(0, 3))


@pytest.mark.parametrize("quant", [False, True])
def test_scatter_parked_rows_matches_jax(tokenizer, quant):
    _, cfg, _, _, _ = _models(tokenizer, "plain")
    pool = _cache(cfg, 5, 80, quant, seed=5)
    parked = _cache(cfg, 4, 64, quant, seed=6)
    src, rows = [2, 0, 3], [4, 1, 2]
    perm = rows + [r for r in range(5) if r not in rows]
    src_idx = np.zeros(5, np.int32)
    take = np.zeros(5, bool)
    src_idx[:3], take[:3] = src, True
    want = jgen.scatter_parked_rows(_jax_cache(pool), _jax_cache(parked),
                                    jnp.asarray(src_idx), jnp.asarray(perm, jnp.int32),
                                    jnp.asarray(take))
    got = _torch_cache(pool)
    tgen.scatter_parked_rows(got, _torch_cache(parked), torch.tensor(src),
                             torch.tensor(rows))
    for n in got:
        np.testing.assert_array_equal(got[n].float().numpy(),
                                      np.asarray(jnp.asarray(want[n], jnp.float32)))


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_pool_bodies_make_no_host_sync(tokenizer, name):
    _, cfg, _, tp, quant = _models(tokenizer, name)
    scfg = TSamplingConfig()
    st, _, _ = _pool(cfg, quant, seed=7, sampling=(0.8, 0.9, 30))
    gs = tgen.GroupState(cfg, scfg, 4, 64, torch.float32, torch.float32, "cpu",
                         quant)
    gs.prompt(64).copy_(torch.from_numpy(_group_inputs(cfg, 4, 64, [20, 9, 33, 1])))
    gs.t_end.copy_(torch.tensor([20, 9, 33, 1]))
    rows = torch.tensor([1, 3])
    ints = torch.tensor([[9, 5] + [0] * (cfg.num_codebooks + 1)] * 2)
    floats = torch.ones((3, 2))
    with _NoHostSync():
        tgen.prefill_group_body(tp, cfg, scfg, gs, 64)
        tgen.scatter_parked_rows(st.cache, {n: t[:, :2, :64] for n, t in gs.cache.items()},
                                 torch.tensor([0, 1]), rows)
        tgen.apply_admission(st, rows, ints, floats)
        tgen.pool_decode_step(tp, cfg, scfg, st)
    assert st.active.all() and st.pos.tolist() == [10, 10, 18, 10]
    assert st.draw.tolist() == [1, 2, 1, 2]
