"""The port's voice-clone prefix cache against the JAX package, on the CPU.

At tiny float32 configs with numpy prompts from a seed:

  * `PrefixStore` makes JAX's decisions (store, reuse, longest match, LRU)
    and counts JAX's hits and misses over one request sequence;
  * `flash_suffix_reference` (the suffix kernels' plain version) equals
    JAX's masked einsum over the cache, `gqa_attention` and
    `gqa_attention_kv8`, and the wrapper runs it for CPU tensors without
    counting a launch; the wrapper's contract raises on what the kernels
    do not take;
  * `dual_ar.prefill_suffix` gives JAX's `prefill_suffix` logits within
    1e-4 and writes the same cache rows, over a plain and an int8 cache;
  * greedy columns of hit requests equal JAX's hit path and the port's
    cold path, in the session (with and without `kv_quant`) and in the
    `ContinuousBatcher` over a same-speaker burst;
  * a stored entry is a copy: a later request that overwrites the cache
    leaves it as it was;
  * the suffix buckets `precompile` captures ahead (`hit_suffix_buckets`,
    the session's `hit_buckets`) are every one a hit can take;
  * the suffix bodies read nothing on the host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
from fish_speech_tpu.engine import batcher as jbatch
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.ops import attention as jattn
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.engine import batcher as tbatch
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import flash_prefill as tfp

from tests.test_torch_graph_step import _NoHostSync

torch.set_num_threads(1)
ATOL = 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _f32(a):
    return np.array(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
                        max_seq_len=256)
    jp = jdual.init_dual_ar(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    return jcfg, config_from_jax(jcfg, DualARConfig), jp, tp


def _cols(cfg, t, seed):
    """(C+1, t) prompt columns: text ids, a third of them semantic."""
    rng = np.random.default_rng(seed)
    inp = np.zeros((cfg.num_codebooks + 1, t), np.int32)
    inp[0] = rng.integers(4, 200, size=t)
    sem = rng.random(t) < 0.3
    inp[0, sem] = cfg.semantic_begin_id + rng.integers(
        0, cfg.semantic_end_id - cfg.semantic_begin_id + 1, size=sem.sum())
    inp[1:] = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
    return inp


def _speaker(cfg, tails, shared=140, seed=1):
    """Prompts of one speaker: a shared prefix, then each tail's columns."""
    head = _cols(cfg, shared, seed)
    return [np.concatenate([head, _cols(cfg, n, 100 + i)], axis=1)
            for i, n in enumerate(tails)]


# -- PrefixStore -------------------------------------------------------------


def test_prefix_store_decisions_match_jax(models):
    _, cfg, _, _ = models
    a, b, c = _speaker(cfg, (12, 30, 5))
    other = _cols(cfg, 150, seed=7)
    short = _cols(cfg, 100, seed=8)
    near = a.copy()
    near[0, 70] += 1  # shares only 70 columns with a
    seq = [a, b, short, other, c, near, _cols(cfg, 60, 9), a[:, :64], b]
    stores = {"jax": jgen.PrefixStore(2), "port": tgen.PrefixStore(2)}
    results = {}
    for name, store in stores.items():
        out = []
        for p in seq:
            hit = store.lookup(p)
            if hit is None:
                store.misses += 1
                out.append(None)
                if store.accepts(p):
                    store.store(p, {"k": p[:1]}, 256)
            else:
                store.hits += 1
                out.append((hit[0], hit[1]["k"].shape[1]))
        results[name] = (out, store.hits, store.misses, len(store),
                         [store._store[k]["cols"].shape[1] for k in store._order])
    assert results["port"] == results["jax"]
    hits = [r for r in results["port"][0] if r is not None]
    assert hits and results["port"][1] == len(hits)
    assert (70, 152) in hits  # the partial match reuses its 70 columns
    assert not tgen.PrefixStore(0).accepts(a)


# -- the suffix attention's plain version -------------------------------------


def _suffix_case(rng, kv8, b=2, ts=8, s=48, h=4, hkv=2, d=16, layers=2):
    q = rng.normal(size=(b, ts, h, d)).astype(np.float32)
    if kv8:
        cache = {"k": rng.integers(-127, 128, size=(layers, b, s, hkv, d)),
                 "v": rng.integers(-127, 128, size=(layers, b, s, hkv, d)),
                 "ks": rng.uniform(0.001, 0.02, size=(layers, b, s, hkv)),
                 "vs": rng.uniform(0.001, 0.02, size=(layers, b, s, hkv))}
        tc = {n: torch.from_numpy(x).to(torch.int8 if n in "kv" else torch.bfloat16)
              for n, x in cache.items()}
    else:
        cache = {n: rng.normal(size=(layers, b, s, hkv, d)).astype(np.float32)
                 for n in ("k", "v")}
        tc = {n: torch.from_numpy(x) for n, x in cache.items()}
    return q, tc


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("start", [0, 17, 40])
def test_flash_suffix_reference_matches_jax_einsum(kv8, start):
    rng = np.random.default_rng(start + 3 * kv8)
    q, tc = _suffix_case(rng, kv8)
    layer, ts = 1, q.shape[1]
    kv_len = start + ts
    i, j = np.arange(ts), np.arange(kv_len)
    mask = jnp.asarray((j[None, :] <= start + i[:, None])[None])
    jc = {n: jnp.asarray(_f32(x[layer]))[:, :kv_len] for n, x in tc.items()}
    if kv8:
        want = jattn.gqa_attention_kv8(jnp.asarray(q), jc["k"], jc["ks"],
                                       jc["v"], jc["vs"], mask)
    else:
        want = jattn.gqa_attention(jnp.asarray(q), jc["k"], jc["v"], mask)
    st = torch.tensor([start], dtype=torch.int32)
    got = tfp.flash_suffix_reference(torch.from_numpy(q), tc, layer, st)
    _close(got, want, atol=1e-5)
    tfp.reset_launches()
    _close(tfp.flash_suffix_attention(torch.from_numpy(q), tc, layer, st), got,
           atol=0)
    assert tfp.flash_suffix_attention.launches == 0


def test_flash_suffix_contract():
    rng = np.random.default_rng(0)
    q, tc = _suffix_case(rng, kv8=True)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    st = torch.tensor([3], dtype=torch.int32)
    assert tfp._suffix_route(torch.bfloat16, True) == "suffix_kv8_wgmma"
    assert tfp._suffix_route(torch.float32, False) == "suffix_cuda_cores"
    assert tfp._suffix_route(torch.float16, True) == "suffix_kv8_wgmma_f16"
    assert set(tfp.SUFFIX_ROUTES) == {tfp._suffix_route(d, k)
                                      for d in (torch.float32, torch.bfloat16,
                                                torch.float16)
                                      for k in (False, True)}
    with pytest.raises(TypeError, match="start"):
        tfp._check_suffix(qt, tc, 0, st.long())
    with pytest.raises(TypeError, match="cache"):
        tfp._check_suffix(qt, {"k": tc["k"].float(), "v": tc["v"].float()}, 0, st)
    with pytest.raises(ValueError, match="layer"):
        tfp._check_suffix(qt, tc, 5, st)
    with pytest.raises(ValueError, match="head dim"):
        tfp._check_suffix(qt, tc, 0, st)  # D = 16: the kernels take 64 or 128
    q64 = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    c64 = {"k": torch.zeros((2, 2, 48, 2, 64), dtype=torch.int8),
           "v": torch.zeros((2, 2, 48, 2, 64), dtype=torch.int8),
           "ks": torch.zeros((2, 2, 48, 2), dtype=torch.bfloat16),
           "vs": torch.zeros((2, 2, 48, 2), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="CUDA"):
        tfp._check_suffix(q64, c64, 1, st)


# -- prefill_suffix ------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_suffix_matches_jax(models, quant):
    jcfg, cfg, jp, tp = models
    prompts = _speaker(cfg, (9, 23))
    m, s, sb = 140, 224, 32
    jc = jdual.init_kv_cache(jcfg, 2, s, jnp.float32, quant=quant)
    full = np.stack([p[:, :m] for p in prompts])  # both rows share the prefix
    _, _, jc = jdual.prefill(jp, jcfg, jnp.asarray(full), jc,
                             jnp.zeros((2,), jnp.int32), jnp.int32(m))
    tc = tdual.init_kv_cache(cfg, 2, s, torch.float32, quant=quant)
    for n in tc:  # both start from JAX's stored prefix
        tc[n].copy_(torch.from_numpy(_f32(jc[n])).to(tc[n].dtype))
    ts = np.asarray([p.shape[1] - m for p in prompts], np.int32)
    inp = np.zeros((2, cfg.num_codebooks + 1, sb), np.int32)
    for r, p in enumerate(prompts):
        inp[r, :, : ts[r]] = p[:, m:]
    jl, jh, jc = jdual.prefill_suffix(jp, jcfg, jnp.asarray(inp), jc,
                                      jnp.int32(m), jnp.asarray(ts), s)
    tl, th, tc = tdual.prefill_suffix(tp, cfg, torch.from_numpy(inp), tc,
                                      torch.tensor([m], dtype=torch.int32),
                                      torch.from_numpy(ts).long())
    _close(tl, jl)
    _close(th, jh)
    rows = slice(m, m + sb)
    for n in tc:
        got, want = _f32(tc[n][:, :, rows]), _f32(jc[n][:, :, rows])
        if quant and n in ("k", "v"):
            assert np.abs(got - want).max() <= 1  # JAX's reciprocal, ROADMAP §3
        elif quant:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
        else:
            _close(got, want)


# -- the session's hit path ----------------------------------------------------


def _sessions(models, quant):
    jcfg, cfg, jp, tp = models
    kw = dict(max_batch=1, decode_chunk_size=4, kv_quant=quant)
    js = jgen.GenerationSession(jp, jcfg, SamplingConfig(), dtype=jnp.float32,
                                prefix_cache_size=2, **kw)
    warm = tgen.GenerationSession(tp, cfg, TSamplingConfig(), dtype=torch.float32,
                                  prefix_cache_size=2, **kw)
    cold = tgen.GenerationSession(tp, cfg, TSamplingConfig(), dtype=torch.float32,
                                  prefix_cache_size=0, **kw)
    return js, warm, cold


@pytest.mark.parametrize("quant", [False, True])
def test_session_hit_columns_match_jax_and_the_cold_path(models, quant):
    _, cfg, _, _ = models
    # the fourth shares the prefix, but 140 + its suffix bucket (128)
    # overruns the cache (256 + 4): JAX's rule makes it a miss
    prompts = _speaker(cfg, (12, 20, 12, 70)) + [_cols(cfg, 150, seed=50)]
    js, warm, cold = _sessions(models, quant)
    kw = dict(max_new_tokens=8, temperature=0.7, top_p=0.9, top_k=1)
    for i, p in enumerate(prompts):
        want = js.generate(p, jax.random.PRNGKey(i), **kw)
        got = warm.generate(p, warm.new_generator(i), **kw)
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
        np.testing.assert_array_equal(
            cold.generate(p, cold.new_generator(i), **kw), got,
            err_msg=f"request {i} cold")
    assert (warm.prefix_hits, warm.prefix_misses) == (js.prefix_hits,
                                                      js.prefix_misses) == (2, 3)
    assert warm.eager_runs["suffix_64"] == 2
    assert cold.prefix_hits == 0 and not any(
        n.startswith("suffix") for n in cold.eager_runs)


def test_stored_entries_are_copies(models):
    _, cfg, _, tp = models
    a, b = _speaker(cfg, (12, 20))
    session = tgen.GenerationSession(tp, cfg, TSamplingConfig(), max_batch=1,
                                     dtype=torch.float32, decode_chunk_size=4,
                                     prefix_cache_size=2)
    kw = dict(max_new_tokens=6, top_k=1)
    session.generate(a, 0, **kw)
    (entry,) = session.prefix._store.values()
    saved = {n: r.clone() for n, r in entry["rows"].items()}
    assert all(r.data_ptr() != session.cache[n].data_ptr()
               for n, r in entry["rows"].items())
    session.generate(_cols(cfg, 90, seed=3), 1, **kw)  # rewrites [0, 128)
    session.generate(b, 2, **kw)  # a hit: restores, then writes the suffix
    assert session.prefix_hits == 1
    for n, r in entry["rows"].items():
        assert torch.equal(r, saved[n]), n


def test_repeated_seed_gives_equal_codes_on_a_hit(models):
    _, cfg, _, tp = models
    (a,) = _speaker(cfg, (15,))
    session = tgen.GenerationSession(tp, cfg, TSamplingConfig(), max_batch=1,
                                     dtype=torch.float32, decode_chunk_size=4,
                                     prefix_cache_size=2)
    kw = dict(max_new_tokens=10, temperature=0.8, top_p=0.9, top_k=30)
    runs = [session.generate(a, 11, **kw) for _ in range(3)]
    assert session.prefix_hits == 2
    np.testing.assert_array_equal(runs[1], runs[2])
    # the hit restores what the miss computed: the sampled codes agree too
    np.testing.assert_array_equal(runs[0], runs[1])


def _reachable_suffix_buckets(max_seq_len, cache_len, room):
    """The suffix buckets of every hit a prompt below max_seq_len can be:
    m >= MIN_MATCH reused columns, and prefix plus bucketed suffix within
    `room` (the session's rule: the cache; the pool's: the cache and
    max_seq_len)."""
    out = set()
    for t in range(tgen.PrefixStore.MIN_MATCH + 1, max_seq_len):
        for m in range(tgen.PrefixStore.MIN_MATCH, t):
            sbucket = tgen.pick_bucket(t - m, cache_len)
            if m + sbucket <= room:
                out.add(sbucket)
    return sorted(out)


@pytest.mark.parametrize("max_seq_len", [256, 1000])
def test_precompiled_suffix_buckets_are_every_reachable_one(models, max_seq_len):
    """What `precompile` captures ahead of the hits, `hit_suffix_buckets`
    (the pool's, from its default prompt buckets) and the session's
    `hit_buckets` (what `warm_up` passes), is every suffix bucket a hit
    can take, and no other; with the cache off the session has none."""
    _, cfg, _, tp = models
    cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    chunk = 16
    cache_len = max_seq_len + chunk
    buckets = [b for b in tgen.PROMPT_BUCKETS if b < max_seq_len]
    assert tgen.hit_suffix_buckets(max(buckets), min(cache_len, max_seq_len)) == (
        _reachable_suffix_buckets(max_seq_len, cache_len,
                                  min(cache_len, max_seq_len)))
    for size in (0, 2):
        session = tgen.GenerationSession(tp, cfg, TSamplingConfig(),
                                         dtype=torch.float32,
                                         decode_chunk_size=chunk,
                                         prefix_cache_size=size)
        assert session.cache_len == cache_len
        assert session.hit_buckets == (_reachable_suffix_buckets(
            max_seq_len, cache_len, cache_len) if size else [])


@pytest.mark.parametrize("quant", [False, True])
def test_suffix_bodies_make_no_host_sync(models, quant):
    _, cfg, _, tp = models
    tp = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg))
    st = tgen.StepState(cfg, TSamplingConfig(), 260, 4, torch.float32,
                        torch.float32, "cpu", quant)
    st.start.fill_(140)
    st.t_end.fill_(9)
    st.sampling.copy_(torch.tensor([0.8, 0.9, 30.0]))
    gs = tgen.GroupState(cfg, TSamplingConfig(), 4, 256, torch.float32,
                         torch.float32, "cpu", quant)
    gs.start.fill_(140)
    with _NoHostSync():
        tgen.suffix_body(tp, cfg, TSamplingConfig(), st, 32)
        tgen.prefill_group_suffix_body(tp, cfg, TSamplingConfig(), gs, 64)
    assert int(st.pos) == 149 and int(st.draw) == 1


# -- the batcher's hit path ----------------------------------------------------


def _drain(out, timeout=120):
    chunks = []
    while True:
        item = out.get(timeout=timeout)
        if item is None or isinstance(item, BaseException):
            assert item is None, item
            return np.concatenate(chunks, axis=0).T
        chunks.append(item)


def _port_burst(b, prompts, seed0, **kw):
    """Every prompt queued before the worker's next pass, request i with
    seed seed0 + i."""
    with b._state_lock:
        outs = [b.submit(tbatch.BatchRequest(prompt=p, seed=seed0 + i, **kw))
                for i, p in enumerate(prompts)]
    return [_drain(o) for o in outs]


def _jax_burst(b, prompts, seed0, **kw):
    import threading

    results = [None] * len(prompts)

    def go(i):
        results[i] = b.generate(prompts[i], seed=seed0 + i, **kw)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


@pytest.mark.parametrize("quant", [False, True])
def test_batcher_same_speaker_burst_matches_jax(models, quant):
    jcfg, cfg, jp, tp = models
    first, *burst = _speaker(cfg, (10, 14, 6, 21, 9), seed=4)
    kw = dict(max_new_tokens=7, top_k=1)
    bk = dict(pool_size=4, decode_chunk_size=4, kv_quant=quant)
    jb = jbatch.ContinuousBatcher(jp, jcfg, SamplingConfig(), dtype=jnp.float32,
                                  prefix_cache_size=4, **bk)
    try:
        want = [jb.generate(first, seed=0, **kw)] + _jax_burst(jb, burst, 1, **kw)
        # JAX's threads may reach its worker in more than one group
        assert jb.prefix.hits >= 1 and jb.prefix.misses == 1
    finally:
        jb.shutdown()
    runs = {}
    for size in (4, 0):
        tb = tbatch.ContinuousBatcher(tp, cfg, TSamplingConfig(),
                                      dtype=torch.float32,
                                      prefix_cache_size=size, **bk)
        try:
            runs[size] = _port_burst(tb, [first], 0, **kw) + _port_burst(
                tb, burst, 1, **kw)
            counts = (tb.prefix.hits, tb.prefix.misses)
            suffix_runs = {n: c for n, c in tb.eager_runs.items()
                           if n.startswith("suffix")}
            entries = [e["rows"] for e in tb.prefix._store.values()]
        finally:
            tb.shutdown()
        if size:
            assert counts == (1, 1)  # the burst is one group of 4: one hit
            assert suffix_runs == {"suffix_4_64": 1}
            assert len(entries) == 1 and entries[0]["k"].shape[1] == 1
    for i, (g, w, c) in enumerate(zip(runs[4], want, runs[0])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, c, err_msg=f"request {i} cold")
