"""The port's continuous batcher and its engine path against the JAX
package, on the CPU.

Tiny float32 models with JAX's random weights, bridged:

  * five concurrent greedy requests in a 3-slot pool, the overflow parked,
    give each request the columns the JAX `ContinuousBatcher` gives it;
  * a sampled request gives the same codes alone and inside a burst (its
    uniforms come from its seed, not from its slot or its neighbours);
  * a cancelled request frees its slot, a queued cancelled one never runs,
    and closing a `BatcherSession` stream frees its slot;
  * a worker crash reaches every client, active, parked and queued, and
    later submissions fail at once;
  * `admit_every < 0` and `prefix_cache_size > 0` raise;
  * the two engines over batcher sessions give the same results for
    concurrent greedy streamed requests: the same segments' audio within
    1e-5, whatever the partials' boundaries;
  * `generate.GUARD`: a capture waits for every launching section and
    keeps new ones out, and a capture inside a launching section raises.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import SamplingConfig, dac_tiny, dual_ar_tiny
from fish_speech_tpu.engine import batcher as jbatch
from fish_speech_tpu.engine import tts as jtts
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dac_decoder_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.engine import batcher as tbatch
from fish_speech_tpu_torch.engine import tts as ttts
from fish_speech_tpu_torch.generate import LaunchGuard

from tests.test_dual_ar import random_prompt

torch.set_num_threads(1)
ATOL = 1e-5


def _tiny(max_seq_len=128):
    jcfg = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
                        max_seq_len=max_seq_len)
    jp = jdual.init_dual_ar(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    return jcfg, config_from_jax(jcfg, DualARConfig), jp, tp


def _port(tp, cfg, scfg=None, **kw):
    kw = {"pool_size": 3, "decode_chunk_size": 4, **kw}
    return tbatch.ContinuousBatcher(tp, cfg, scfg or TSamplingConfig(),
                                    dtype=torch.float32, **kw)


def _drain(out, timeout=120):
    chunks = []
    while True:
        item = out.get(timeout=timeout)
        if item is None or isinstance(item, BaseException):
            return chunks, item
        chunks.append(item)


def _burst(b, prompts, held=None, **kw):
    """Every prompt at once, request i with seed i and 8 + i new tokens:
    from one thread each, or, with the lock `held` (the port batcher's
    `_state_lock`), all queued before the worker's next pass. Returns each
    request's (C+1, N) columns."""
    if held is not None:
        with held:
            outs = [b.submit(tbatch.BatchRequest(prompt=p, seed=i,
                                                 max_new_tokens=8 + i, **kw))
                    for i, p in enumerate(prompts)]
        return [np.concatenate(_drain(o)[0], axis=0).T for o in outs]
    results = [None] * len(prompts)

    def go(i):
        results[i] = b.generate(prompts[i], seed=i, max_new_tokens=8 + i, **kw)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


def _prompts(cfg, n=5):
    return [random_prompt(cfg, 6 + 9 * i, np.random.default_rng(i)) for i in range(n)]


def test_greedy_burst_matches_the_jax_batcher():
    jcfg, cfg, jp, tp = _tiny()
    prompts = _prompts(cfg)
    jb = jbatch.ContinuousBatcher(jp, jcfg, SamplingConfig(), pool_size=3,
                                  dtype=jnp.float32, decode_chunk_size=4)
    try:
        want = _burst(jb, prompts, top_k=1)
    finally:
        jb.shutdown()
    tb = _port(tp, cfg)
    try:
        got = _burst(tb, prompts, held=tb._state_lock, top_k=1)
        stats = tb.stats()
    finally:
        tb.shutdown()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert 1 <= g.shape[1] <= 8 + i
    # all five arrived in one pass: three admitted, two parked
    assert stats["parked_groups"] == 2 and stats["active_slots"] == 0
    assert tb.precompile() == {}


def test_sampled_request_is_the_same_alone_and_in_a_burst():
    _, cfg, _, tp = _tiny()
    prompts = _prompts(cfg)
    b = _port(tp, cfg, admit_every=2)
    try:
        alone = [b.generate(p, seed=i, max_new_tokens=8 + i, top_k=30)
                 for i, p in enumerate(prompts)]
        burst = _burst(b, prompts, held=b._state_lock, top_k=30)
        greedy = b.generate(prompts[0], seed=0, max_new_tokens=8, top_k=1)
    finally:
        b.shutdown()
    for i, (a, c) in enumerate(zip(alone, burst)):
        np.testing.assert_array_equal(a, c, err_msg=f"request {i}")
    assert not np.array_equal(alone[0], greedy)  # sampled, not greedy


def test_cancel_frees_the_slot():
    """im_end is masked, so only a cancel ends a request early."""
    _, cfg, _, tp = _tiny(256)
    b = _port(tp, cfg, TSamplingConfig(mask_im_end=True), pool_size=2)
    try:
        prompt = random_prompt(cfg, 8)
        req = tbatch.BatchRequest(prompt=prompt, max_new_tokens=200, seed=7)
        out = b.submit(req)
        first = out.get(timeout=120)
        req.cancelled.set()
        b._wake.set()
        chunks, end = _drain(out)
        assert end is None and first.shape[0] + sum(len(c) for c in chunks) < 200

        queued = tbatch.BatchRequest(prompt=prompt, max_new_tokens=8, seed=9)
        queued.cancelled.set()
        assert b.submit(queued).get(timeout=60) is None

        gen = tbatch.BatcherSession(b).generate_stream(
            prompt, np.random.default_rng(3), max_new_tokens=200)
        next(gen)
        gen.close()
        deadline = time.monotonic() + 60
        while b.stats()["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert b.stats()["active_slots"] == 0
        assert b.generate(prompt, max_new_tokens=6, seed=11).shape[1] == 6
    finally:
        b.shutdown()


@pytest.mark.parametrize("where", ["_dispatch_steps", "_prefill_dispatch"])
def test_worker_crash_reaches_every_client(where):
    """A fault in a decode dispatch (two requests active, two parked) or
    in an admission prefill (all four taken from the queue)."""
    _, cfg, _, tp = _tiny()
    b = _port(tp, cfg, pool_size=2)
    boom = RuntimeError("simulated device fault")

    def crash(*args):
        raise boom

    try:
        setattr(b, where, crash)
        with b._state_lock:  # all four arrive in one pass
            outs = [b.submit(tbatch.BatchRequest(prompt=p, max_new_tokens=20, seed=i))
                    for i, p in enumerate(_prompts(cfg, 4))]
        for out in outs:
            assert _drain(out, timeout=60)[1] is boom
        b.thread.join(timeout=10)
        assert not b.thread.is_alive() and b._worker_error is boom
        late = b.submit(tbatch.BatchRequest(prompt=random_prompt(cfg, 5)))
        assert late.get(timeout=5) is boom
        with pytest.raises(RuntimeError, match="worker failed"):
            b.generate(random_prompt(cfg, 5), max_new_tokens=4)
    finally:
        b.shutdown()


@pytest.mark.parametrize("kw,error", [({"admit_every": -1}, ValueError),
                                      ({"prefix_cache_size": 4},
                                       NotImplementedError)])
def test_unsupported_options_raise(kw, error):
    _, cfg, _, tp = _tiny()
    with pytest.raises(error):
        _port(tp, cfg, **kw)


def _engines(tokenizer, tmp_path):
    dac_cfg = dac_tiny()
    jdac = init_dac(jax.random.PRNGKey(1), dac_cfg, dtype=jnp.float32)
    tdac = dac_decoder_from_jax(jax.tree_util.tree_map(np.asarray, jdac),
                                dtype=torch.float32, device="cpu")
    jcfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id,
                        num_codebooks=dac_cfg.rvq.total_codebooks,
                        attention_qk_norm=True, max_seq_len=160)
    jp = jdual.init_dual_ar(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    kw = dict(pool_size=2, decode_chunk_size=4, first_chunk_size=2)
    jb = jbatch.ContinuousBatcher(jp, jcfg, SamplingConfig(), dtype=jnp.float32, **kw)
    tb = tbatch.ContinuousBatcher(tp, config_from_jax(jcfg, DualARConfig),
                                  TSamplingConfig(), dtype=torch.float32, **kw)
    jeng = jtts.TTSInferenceEngine(jbatch.BatcherSession(jb), tokenizer, jdac,
                                   dac_cfg, references_dir=str(tmp_path))
    teng = ttts.TTSInferenceEngine(tbatch.BatcherSession(tb), tokenizer, tdac,
                                   dac_cfg, references_dir=str(tmp_path))
    return (jb, jeng, jtts), (tb, teng, ttts)


def _serve(engine, mod, texts):
    out = [None] * len(texts)

    def go(i):
        out[i] = list(engine.inference(mod.TTSRequest(
            text=texts[i], streaming=True, max_new_tokens=9 + i, top_k=1,
            seed=i)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_engines_over_batcher_sessions_match(tokenizer, tmp_path):
    texts = ["Hello world.", "A second request.", "Three at once, in a pool of two."]
    results = {}
    for name, (b, eng, mod) in zip(("jax", "port"), _engines(tokenizer, tmp_path)):
        try:
            results[name] = _serve(eng, mod, texts)
        finally:
            b.shutdown()
    for got, want in zip(results["port"], results["jax"]):
        codes = [r.code for r in got]
        assert codes[0] == "header" and codes[-1] == "final", got[-1].error
        assert [r.code for r in want][-1] == "final"
        final = got[-1].audio[1]
        np.testing.assert_allclose(final, want[-1].audio[1], atol=ATOL, rtol=0)
        streamed = np.concatenate([r.audio[1] for r in got if r.code == "segment"])
        np.testing.assert_allclose(streamed, final, atol=ATOL, rtol=0)
        assert np.isfinite(final).all() and len(final) > 0


def test_launch_guard_keeps_captures_alone():
    guard = LaunchGuard()
    events = []
    entered = threading.Event()
    release = threading.Event()

    def launcher():
        with guard.launching():
            entered.set()
            events.append("launch")
            release.wait(10)
            with guard.launching():  # re-entrant within a thread
                events.append("nested")
        events.append("left")

    def capturer():
        with guard.capturing():
            events.append("capture")

    t1 = threading.Thread(target=launcher)
    t1.start()
    assert entered.wait(10)
    t2 = threading.Thread(target=capturer)
    t2.start()
    time.sleep(0.2)
    assert events == ["launch"]  # the capture waits for the launcher
    release.set()
    t1.join(10)
    t2.join(10)
    assert events == ["launch", "nested", "left", "capture"]
    with guard.launching():
        with pytest.raises(RuntimeError, match="wait for itself"):
            with guard.capturing():
                pass
