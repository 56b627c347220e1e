"""Tensor-parallel serving of the port (two gloo ranks on the CPU) against
the JAX package's session on the (1, 2) mesh of
`tests/test_sharded_inference.py`, on the same weights and inputs: greedy
codes equal (plain and int8 KV cache), both ranks' codes equal (sampled
too), the teacher-forced forward's logits within 1e-5, and each rank's
caches and kernels at its own heads. In fp16 (`--half` under a mesh) the
tp=2 greedy codes equal the unsharded port's fp16 session's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
from fish_speech_tpu.generate import GenerationSession
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.parallel.mesh import (dual_ar_param_specs, kv_cache_specs,
                                           make_mesh, to_named)
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.generate import GenerationSession as TGenerationSession
from tests.torch_dist_worker import _half, spawn_ranks

torch.set_num_threads(1)


def _cfg():
    # tests/test_sharded_inference.py's config
    return dual_ar_tiny(
        semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
        n_head=4, n_local_heads=2, head_dim=32, dim=128,
        intermediate_size=256,
        fast_n_head=2, fast_n_local_heads=2, fast_head_dim=16, fast_dim=64,
        fast_intermediate_size=128,
    )


def _prompt(cfg, t=10):
    rng = np.random.default_rng(0)
    p = np.zeros((cfg.num_codebooks + 1, t), dtype=np.int32)
    p[0] = rng.integers(4, 200, size=t)
    return p


def _forward_inp(cfg):
    rng = np.random.default_rng(1)
    inp = np.zeros((2, cfg.num_codebooks + 1, 12), dtype=np.int32)
    inp[:, 0] = rng.integers(4, 200, size=(2, 12))
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results on the (1, 2) and (2, 2) meshes, the two port ranks')."""
    cfg = _cfg()
    params = jdual.init_dual_ar(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    prompt = _prompt(cfg)
    mesh = make_mesh(jax.devices()[:2], dp=1, tp=2)
    sharded = jax.tree_util.tree_map(
        jax.device_put, params, to_named(mesh, dual_ar_param_specs(cfg)))
    want = {}
    for kv_quant in (False, True):
        s = GenerationSession(sharded, cfg, SamplingConfig(), dtype=jnp.float32,
                              decode_chunk_size=8, kv_quant=kv_quant)
        s.cache = jax.tree_util.tree_map(
            jax.device_put, s.cache, to_named(mesh, kv_cache_specs(kv_quant)))
        want[kv_quant] = s.generate(prompt, jax.random.PRNGKey(5),
                                    max_new_tokens=12, top_k=1)
    mesh4 = make_mesh(jax.devices()[:4], dp=2, tp=2)
    inp = _forward_inp(cfg)
    sh4 = jax.tree_util.tree_map(
        jax.device_put, params, to_named(mesh4, dual_ar_param_specs(cfg)))
    want["logits"] = jax.jit(lambda p, x: jdual.forward_train(
        p, cfg, x, remat=False))(sh4, jnp.asarray(inp))

    tparams = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               dtype=torch.float32, device="cpu")
    tcfg = config_from_jax(cfg, DualARConfig)
    for kv_quant in (False, True):  # the unsharded port in fp16
        s = TGenerationSession(_half(tparams), tcfg, TSamplingConfig(),
                               dtype=torch.float16, decode_chunk_size=8,
                               kv_quant=kv_quant)
        want["fp16", kv_quant] = s.generate(prompt, 5, top_k=1, max_new_tokens=12)
    work = tmp_path_factory.mktemp("tp_serving")
    torch.save({"cfg": tcfg,
                "params": tparams,
                "prompt": prompt, "forward_inp": torch.from_numpy(inp),
                "dp": 1, "tp": 2}, work / "inputs.pt")
    return want, spawn_ranks("serve", 2, work)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_tp2_greedy_codes_equal_jax_on_the_1x2_mesh(runs, kv_quant):
    want, got = runs
    assert want[kv_quant].shape[1] > 1
    np.testing.assert_array_equal(got[0]["codes"][kv_quant], want[kv_quant])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp16_cache", "int8_cache"])
def test_tp2_fp16_greedy_codes_equal_the_unsharded_port(runs, kv_quant):
    want, got = runs
    assert want["fp16", kv_quant].shape[1] > 1
    for rank in (0, 1):
        np.testing.assert_array_equal(got[rank]["codes"]["fp16", kv_quant],
                                      want["fp16", kv_quant])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_both_ranks_draw_the_same_codes(runs, kv_quant, mode):
    _, got = runs
    key = kv_quant if mode == "greedy" else (kv_quant, "sampled")
    np.testing.assert_array_equal(got[0]["codes"][key], got[1]["codes"][key])


@pytest.mark.parametrize("rank", [0, 1])
def test_tp2_forward_logits_within_1e_5_of_jax(runs, rank):
    want, got = runs
    for g, w in zip(got[rank]["logits"], want["logits"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_each_rank_holds_its_heads_and_runs_eagerly_under_gloo(runs):
    _, got = runs
    for out in got:
        assert out["cache_heads"] == 1  # Hkv 2 over tp 2
        # gloo: no graphs, every body eager (the CPU would be eager anyway)
        assert out["eager_runs"][False]["decode"] > 0
