"""fp16 serving (`--half`) in the port against the JAX package in float16,
on the CPU.

The port's kernels have fp16 forms on the card; here each one's plain
version takes fp16 and is held to the JAX function it ports, in fp16, with
tolerances in fp16 ulps (`_ulp`: 2^(e - 10) at |y| in [2^e, 2^(e+1)), the
subnormal step 2^-24 below 2^-14):

  * the prefill and decode attention against the Pallas kernels in
    interpret mode, within 2 ulps of max |out| (both round the softmax
    weights to fp16 once, or keep them in fp32, and round out once);
  * the int8-KV decode's plain version, and a replay of the kernel's split
    with p * vs carried as two fp16 terms, against JAX's
    `gqa_attention_kv8` in fp16 (which rounds p * vs once), within 2 ulps
    of max |out|;
  * the int8 matvec (one rounding of the fp32 sum times the fp32 scale)
    against the Pallas matvec bodies of `scripts/microbench/` in interpret
    mode with an fp16 output, within 1 ulp, and against JAX's `mm` within
    2 ulps of each output (measured 2: JAX rounds `x @ q` and the product
    with the fp16 scale); the fused FFN against the Pallas FFN kernel with
    x fp16 (g rounded to fp16 once), within 2 ulps of max |y|, and against
    JAX's `_ffn` within 4;
  * JAX's `mm` in fp16 overflows to inf at I = 2560 (x = 8, q = 127) where
    the port's one-rounding product stays finite (ROADMAP §3 records it);
  * greedy codes of the fp16 single session and of the fp16 pool burst
    equal JAX's, with the plain and the int8 KV cache;
  * the fp16 `--int8` session teacher-forced: prefill logits and each
    step's slow and fast logits within 4 ulps of max |logit| of JAX's (the
    int8 products round once here, twice in JAX: greedy codes may part);
  * quantizing fp16 params gives fp32 scales, and a quantized checkpoint
    read in fp16 has fp16 scales that `fp32_scales` widens exactly;
  * the fp16 codec against JAX's on codes whose audio lies in fp16's normal
    range (its last convolution scaled up), within 4 ulps of max |audio|;
  * `build_engine --half`: the LM and the codec in fp16, greedy codes equal
    JAX's engine on the same checkpoint; the bf16 engine's codec is bf16
    too (as JAX's), its waveform within 2 bf16 ulps of max |audio| of
    JAX's; `--half` over int4 leaves raises, naming ROADMAP §1 item 12b;
    `check_args` takes `--half` with every serving flag and under a mesh;
    `tools/batch_tts.py --half` serves a job through an fp16 pool.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig
from fish_speech_tpu.config import dac_tiny
from fish_speech_tpu.engine import batcher as jbatch
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.models.dac import model as jdac_model
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu.ops.attention import gqa_attention_kv8 as j_gqa_kv8
from fish_speech_tpu.ops.pallas_attention import \
    flash_prefill_attention as j_flash_prefill
from fish_speech_tpu.ops.pallas_decode import \
    flash_decode_attention as j_flash_decode
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.audio.io import read_wav
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax, dac_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.engine import batcher as tbatch
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.models.dac import model as tdac_model
from fish_speech_tpu_torch.models.dual_ar import _kv_quant
from fish_speech_tpu_torch.ops import flash_decode as tfd
from fish_speech_tpu_torch.ops import flash_prefill as tfp
from fish_speech_tpu_torch.ops import int8 as tint8
from fish_speech_tpu_torch.ops import int8_ffn as tffn
from fish_speech_tpu_torch.ops import quant as tquant
from fish_speech_tpu_torch.ops.flash_decode import (decode_split_count,
                                                    flash_decode_kv8_reference,
                                                    flash_decode_reference)
from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_reference
from fish_speech_tpu_torch.ops.int8 import int8_matmul_reference
from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn_reference

from tests.test_torch_batcher import _burst
from tests.test_torch_batcher import _prompts as _burst_prompts
from tests.test_torch_batcher import _tiny as _batcher_tiny
from tests.test_dual_ar import random_prompt
from tests.test_torch_decode_split import H100_SMS, _kv8_split_replay
from tests.test_torch_int8 import _inputs, _script as _matvec_script
from tests.test_torch_int8_ffn import (_fused, _jax_ffn_layer, _script as _ffn_script,
                                       _weights, _x)
from tests.test_torch_kv8 import _cfgs as _kv8_cfgs
from tests.test_torch_kv8 import _prompt as _kv8_prompt

torch.set_num_threads(1)


def _ulp(y):
    """One fp16 ulp at |y|: 2^(e - 10) for |y| in [2^e, 2^(e+1)), the
    subnormal step 2^-24 below 2^-14."""
    e = np.floor(np.log2(np.maximum(np.abs(np.asarray(y, np.float64)), 2.0 ** -14)))
    return 2.0 ** (e - 10)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _max_ulps(got, want):
    """max |got - want| in fp16 ulps of max |want|."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / _ulp(np.abs(want).max()))


def _half(rng, *shape, scale=1.0):
    """N(0, scale^2) values rounded to fp16, as fp32 numpy (both packages
    read the same fp16 numbers)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float16)
    return x.astype(np.float32)


@pytest.mark.parametrize("b,t,h,hkv,d,offsets", [
    (1, 64, 4, 2, 64, [0]),
    (2, 128, 4, 1, 128, [0, 37]),
])
def test_prefill_plain_fp16_matches_pallas_interpret(b, t, h, hkv, d, offsets):
    rng = np.random.default_rng(t + h)
    q, k, v = _half(rng, b, t, h, d), _half(rng, b, t, hkv, d), _half(rng, b, t, hkv, d)
    off = np.asarray(offsets, np.int32)
    want = j_flash_prefill(*(jnp.asarray(a, jnp.float16) for a in (q, k, v)),
                           jnp.asarray(off), interpret=True)
    assert want.dtype == jnp.float16
    args = [torch.from_numpy(a).half() for a in (q, k, v)] + [torch.from_numpy(off)]
    got = flash_prefill_reference(*args)
    assert got.dtype == torch.float16
    assert _max_ulps(got, want) <= 2
    n0 = tfp.flash_prefill_attention.launches
    assert torch.equal(tfp.flash_prefill_attention(*args), got)  # CPU: plain
    assert tfp.flash_prefill_attention.launches == n0
    assert tfp._route(torch.float16) == "wgmma_f16"


@pytest.mark.parametrize("g,lengths", [(4, [1, 300]), (3, [257, 10])])
def test_decode_plain_fp16_matches_pallas_interpret(g, lengths):
    rng = np.random.default_rng(g)
    n_layer, b, s, hkv, d, gp = 2, 2, 512, 2, 64, 8
    q = np.zeros((b, hkv, gp, d), np.float32)  # JAX side: G padded to Gp
    q[:, :, :g] = _half(rng, b, hkv, g, d)
    k, v = _half(rng, n_layer, b, s, hkv, d), _half(rng, n_layer, b, s, hkv, d)
    lens = np.asarray(lengths, np.int32)
    for layer in range(n_layer):
        want = j_flash_decode(jnp.asarray(q, jnp.float16), jnp.asarray(k, jnp.float16),
                              jnp.asarray(v, jnp.float16), jnp.int32(layer),
                              jnp.asarray(lens), interpret=True)[:, :, :g]
        args = (torch.from_numpy(q[:, :, :g].copy()).half(),
                torch.from_numpy(k).half(), torch.from_numpy(v).half(), layer,
                torch.from_numpy(lens))
        got = flash_decode_reference(*args)
        assert got.dtype == torch.float16
        assert _max_ulps(got, want) <= 2
        n0 = (tfd.flash_decode_attention.launches,
              tfd.flash_decode_attention.launches_f16)
        assert torch.equal(tfd.flash_decode_attention(*args), got)
        assert (tfd.flash_decode_attention.launches,
                tfd.flash_decode_attention.launches_f16) == n0


@pytest.mark.parametrize("g", [1, 4, 8])
def test_kv8_decode_fp16_plain_and_split_match_jax(g):
    """Row b attends its first b + 1 positions (every len in 1..S); the
    kernel's split replayed with p * vs as two fp16 terms, and the plain
    version, against JAX's `gqa_attention_kv8` in fp16."""
    rng = np.random.default_rng(200 + g)
    n_layer, s, hkv, d = 2, 80, 2, 64
    b = s
    q = torch.from_numpy(_half(rng, b, hkv, g, d)).half()
    k, ks = _kv_quant(torch.from_numpy(_half(rng, n_layer, b, s, hkv, d)))
    v, vs = _kv_quant(torch.from_numpy(_half(rng, n_layer, b, s, hkv, d)))
    lengths = torch.arange(1, s + 1, dtype=torch.int32)
    z = decode_split_count(s, hkv, 1, H100_SMS)
    mask = jnp.asarray((np.arange(s)[None, :] < lengths.numpy()[:, None])[:, None])
    for layer in range(n_layer):
        want = j_gqa_kv8(
            jnp.asarray(q.float().numpy().reshape(b, 1, hkv * g, d), jnp.float16),
            jnp.asarray(k[layer].numpy()),
            jnp.asarray(ks[layer].float().numpy(), jnp.bfloat16),
            jnp.asarray(v[layer].numpy()),
            jnp.asarray(vs[layer].float().numpy(), jnp.bfloat16), mask)
        assert want.dtype == jnp.float16
        want = np.asarray(want.astype(jnp.float32)).reshape(b, hkv, g, d)
        plain = flash_decode_kv8_reference(q, k, ks, v, vs, layer, lengths)
        split = _kv8_split_replay(q, k, ks, v, vs, layer, lengths, s, z)
        assert plain.dtype == split.dtype == torch.float16
        assert _max_ulps(plain, want) <= 2
        assert _max_ulps(split, want) <= 2
        # two fp16 terms carry p * vs to within 2^-22 of it: the split is
        # the fp32 fold of the plain version, up to the final rounding
        assert _max_ulps(split, plain) <= 1


def _pallas_matvec(kernel, x, q, s, o_tile=512):
    """The microbench scripts' grid and BlockSpecs around `kernel`, with an
    fp16 output (their wrappers fix bf16)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    d, o = q.shape
    m = x.shape[0]
    return pl.pallas_call(
        kernel, grid=(o // o_tile,),
        in_specs=[
            pl.BlockSpec((m, d), lambda j: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((d, o_tile), lambda j: (0, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, o_tile), lambda j: (0, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((m, o_tile), lambda j: (0, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, o), jnp.float16), interpret=True,
    )(x, q, s)


@pytest.mark.parametrize("m,i,o", [(1, 256, 1024), (16, 384, 512), (32, 640, 1536)])
@pytest.mark.parametrize("script", ["matvec_pallas", "ffn_per_op_pallas"])
def test_int8_matvec_fp16_plain_matches_pallas_and_jax_mm(script, m, i, o):
    kernel, _ = _matvec_script(script)
    x, q, s = _inputs(m, i, o, seed=m + i + o)
    xt = torch.from_numpy(x).half()
    got = int8_matmul_reference(xt, torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float16
    want = _pallas_matvec(kernel, jnp.asarray(xt.float().numpy(), jnp.float16),
                          jnp.asarray(q), jnp.asarray(s[None]))
    got, want = _f32(got), _f32(want)
    assert (np.abs(got - want) <= _ulp(want)).all()
    # JAX's `mm` in fp16 (two roundings, the scale in fp16) on the same weight
    jw = {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    jmm = _f32(jquant.mm(jnp.asarray(xt.float().numpy(), jnp.float16), jw))
    assert (np.abs(got - jmm) <= 2 * _ulp(jmm)).all()
    assert tint8._route(m, torch.float16) == ("gemv_cluster_f16" if m >= 17
                                              else "gemv_mma_f16")


def test_jax_mm_fp16_overflows_where_the_kernels_product_stays_finite():
    """ROADMAP §3 (JAX faults, record only): JAX's `mm` rounds `x @ q` to
    fp16 before the scale, so x = 8 against q = 127 over I = 2560 (a sum of
    2,600,960) is inf; the port sums in fp32 and rounds once after the
    scale, so y = 2600.96 stays finite."""
    i, o = 2560, 16
    x = np.full((1, i), 8.0, np.float32)
    q = np.full((i, o), 127, np.int8)
    s = np.full((o,), 1e-3, np.float32)
    jmm = np.asarray(jquant.mm(jnp.asarray(x, jnp.float16),
                               {"q": jnp.asarray(q), "s": jnp.asarray(s)}))
    assert np.isinf(jmm).all()
    xt = torch.from_numpy(x).half()
    got = tquant.mm(xt, {"q": torch.from_numpy(q), "s": torch.from_numpy(s)})
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got), 2600.96, atol=_ulp(2600.96))


@pytest.mark.parametrize("b", [1, 4, 32])
def test_int8_ffn_fp16_plain_matches_pallas_and_jax_ffn(b):
    ffn_fused, pack = _ffn_script()
    d, i = 256, 512
    w1, w3, w2 = _weights(d, i, seed=b + 5)
    x = _x(b, d, seed=3 * b, dtype=torch.float16)
    got = int8_ffn_reference(x, _fused(w1, w3), w2)
    assert got.dtype == torch.float16
    stack = {name: {"q": jnp.asarray(w["q"].numpy()[None]),
                    "s": jnp.asarray(w["s"].numpy()[None, None])}
             for name, w in (("w1", w1), ("w3", w3), ("w2", w2))}
    p = jax.tree.map(lambda a: a[0], pack(stack, 128))
    want = ffn_fused(jnp.asarray(x.float().numpy(), jnp.float16), p["w1p"],
                     p["s1"], p["w3p"], p["s3"], p["w2p"], p["s2"])
    assert want.dtype == jnp.float16
    assert _max_ulps(got, want) <= 2
    spec = (1, 1, 16, 1e-5, 1.0)
    jy = jdual._ffn(_jax_ffn_layer(w1, w3, w2), spec,
                    jnp.asarray(x.float().numpy(), jnp.float16)[:, None])
    assert jy.dtype == jnp.float16
    assert _max_ulps(got, jy[:, 0]) <= 4
    assert tffn._route(b, torch.float16) == "mma_f16"


# --- sessions -------------------------------------------------------------


def _to_half(tree):
    """A JAX tree with its float leaves in fp16 (int8 and int4 leaves and
    fp32 scales of quantized weights as they are, as JAX's `load_dual_ar`
    under `--half` leaves them to `fp32_scales`)."""
    def cast(path, a):
        quant_scale = path and getattr(path[-1], "key", None) in ("s", "gs")
        if jnp.issubdtype(a.dtype, jnp.floating) and not quant_scale:
            return a.astype(jnp.float16)
        return a
    return jax.tree_util.tree_map_with_path(cast, tree)


def _half_models(tokenizer, seed=2, **kw):
    """test_torch_kv8's tiny config with JAX's random weights in fp16, and
    the same numbers bridged into the port in fp16."""
    jcfg, cfg = _kv8_cfgs(tokenizer, **kw)
    jp = _to_half(jdual.init_dual_ar(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float16, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_fp16_session_matches_jax(tokenizer, kv_quant):
    jcfg, cfg, jp, tp = _half_models(tokenizer)
    kw = dict(max_batch=1, decode_chunk_size=4, first_chunk_size=2,
              kv_quant=kv_quant)
    js = jgen.GenerationSession(jp, jcfg, SamplingConfig(), dtype=jnp.float16, **kw)
    ts = tgen.GenerationSession(tp, cfg, TSamplingConfig(), dtype=torch.float16, **kw)
    assert ts.params["layers"]["w13"].dtype == torch.float16
    assert ts.cache["k"].dtype == (torch.int8 if kv_quant else torch.float16)
    prompt = _kv8_prompt(cfg, 29, seed=3)[0]
    gen = dict(max_new_tokens=24, temperature=0.7, top_p=0.9, top_k=1)
    want = list(js.generate_stream(prompt, jax.random.PRNGKey(0), **gen))
    got = list(ts.generate_stream(prompt, ts.new_generator(7), **gen))
    assert len(got) == len(want) and want[-1].shape[1] > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_fp16_pool_burst_matches_the_jax_batcher(kv_quant):
    """test_torch_batcher's burst (five greedy requests in a 3-slot pool,
    two parked) on its tiny model in fp16."""
    jcfg, cfg, jp, _ = _batcher_tiny()
    jp = _to_half(jp)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float16, device="cpu")
    prompts = _burst_prompts(cfg)
    kw = dict(pool_size=3, decode_chunk_size=4, kv_quant=kv_quant)
    jb = jbatch.ContinuousBatcher(jp, jcfg, SamplingConfig(), dtype=jnp.float16, **kw)
    try:
        want = _burst(jb, prompts, top_k=1)
    finally:
        jb.shutdown()
    tb = tbatch.ContinuousBatcher(tp, cfg, TSamplingConfig(), dtype=torch.float16, **kw)
    try:
        assert tb.params["layers"]["wqkv"].dtype == torch.float16
        got = _burst(tb, prompts, held=tb._state_lock, top_k=1)
    finally:
        tb.shutdown()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def _jax_int8(jcfg, seed):
    """JAX's random weights in fp16, quantized by JAX (fp32 scales, as
    `quantize_dual_ar_lowmem` gives on fp16 params), and the same tree in
    the port."""
    jp = _to_half(jdual.init_dual_ar(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    jq = jquant.quantize_dual_ar_lowmem(jp, mode="int8")
    tq = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                          dtype=torch.float16, device="cpu")
    return jq, tq


def test_fp16_quantizing_gives_fp32_scales_and_fp32_scales_widens_fp16(tokenizer):
    jcfg, cfg, jp, tp = _half_models(tokenizer)
    tq = tquant.quantize_dual_ar_lowmem(tp, mode="int8")
    jq = jquant.quantize_dual_ar_lowmem(jp, mode="int8")
    for name in ("wqkv", "w1", "w2"):
        assert tq["layers"][name]["s"].dtype == torch.float32
        assert jq["layers"][name]["s"].dtype == jnp.float32
        np.testing.assert_array_equal(tq["layers"][name]["q"].numpy(),
                                      np.asarray(jq["layers"][name]["q"]))
    # a checkpoint read in fp16 has fp16 scales; `fp32_scales` widens them
    # exactly and leaves the fp16 leaves alone
    read = {"layers": {"w1": {"q": tq["layers"]["w1"]["q"],
                              "s": tq["layers"]["w1"]["s"].half()}},
            "embeddings": tp["embeddings"]}
    wide = tquant.fp32_scales(read)
    assert wide["layers"]["w1"]["s"].dtype == torch.float32
    assert torch.equal(wide["layers"]["w1"]["s"].half(), read["layers"]["w1"]["s"])
    assert wide["embeddings"] is read["embeddings"]


def test_fp16_int8_session_teacher_forced_logits_match_jax(tokenizer):
    """Prefill, then three slow steps and each step's fast stack fed the
    same tokens: the logits stay within 4 fp16 ulps of max |logit| of JAX's
    (measured 2; JAX's `mm` rounds twice, the port's int8 products once)."""
    jcfg, cfg = _kv8_cfgs(tokenizer)
    jq, tq = _jax_int8(jcfg, seed=2)
    jq = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jq, jcfg))
    tq = tquant.fp32_scales(tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tq, cfg)))
    inp = _kv8_prompt(cfg, 32, seed=1)
    t_end = 24
    jc = jdual.init_kv_cache(jcfg, 1, 48, jnp.float16)
    tc = tdual.init_kv_cache(cfg, 1, 48, torch.float16)
    jl, _, jc = jdual.prefill(jq, jcfg, jnp.asarray(inp), jc,
                              jnp.zeros((1,), jnp.int32), jnp.int32(t_end))
    tl, _, tc = tdual.prefill(tq, cfg, torch.from_numpy(inp), tc,
                              torch.zeros((1,), dtype=torch.int32), t_end)
    assert _max_ulps(tl, jl) <= 4
    for pos in range(t_end, t_end + 3):
        token = _kv8_prompt(cfg, 1, seed=pos)[:, :, 0]
        jhid, jslow, jc = jdual.decode_slow_step(jq, jcfg, jnp.asarray(token), jc,
                                                 jnp.int32(pos))
        thid, tslow, tc = tdual.decode_slow_step(tq, cfg, torch.from_numpy(token),
                                                 tc, pos)
        assert _max_ulps(tdual.semantic_head_logits(tq, cfg, tslow),
                         jdual.semantic_head_logits(jq, jcfg, jslow)) <= 4
        # the fast stack from JAX's hidden state, fed the token's codes
        jfc = jdual.init_fast_kv_cache(jcfg, 1, jnp.float16)
        tfc = tdual.init_fast_kv_cache(cfg, 1, torch.float16)
        jx = jdual.fast_project_in(jq, jcfg, jhid)
        tx = tdual.fast_project_in(tq, cfg, torch.tensor(_f32(jhid)).half())
        for i in range(cfg.num_codebooks):
            jlog, jfc = jdual.fast_decode_step(jq, jcfg, jx, jfc, jnp.int32(i))
            tlog, tfc = tdual.fast_decode_step(tq, cfg, tx, tfc, i)
            assert _max_ulps(tlog, jlog) <= 4
            code = int(token[0, 1 + i])
            jx = jdual.fast_embed(jq, jcfg, jnp.asarray([code], jnp.int32))
            tx = tdual.fast_embed(tq, cfg, torch.tensor([code]))


# --- the codec and the engine ---------------------------------------------


CODEC_GAIN = 6.0  # each decoder convolution's weight times this: audio ~1e-2


def _loud_codec():
    """dac_tiny with JAX's random weights (seed 1), every decoder
    convolution's weight scaled by CODEC_GAIN: its audio (and each layer's
    activations) lies in fp16's normal range, where the unscaled codec's
    ~3e-8 is below fp16's smallest subnormal."""
    cfg = dac_tiny()
    p = init_dac(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    return cfg, jax.tree_util.tree_map_with_path(
        lambda path, a: a * CODEC_GAIN
        if path[0].key == "decoder" and path[-1].key == "w" else a, p)


def test_fp16_codec_matches_jax():
    cfg, jp = _loud_codec()
    codes = np.random.default_rng(0).integers(
        0, 16, (2, cfg.rvq.total_codebooks, 12)).astype(np.int32)
    j16 = jax.tree.map(lambda a: a.astype(jnp.float16), jp)
    want = jdac_model.dac_from_indices(j16, cfg, jnp.asarray(codes))
    assert want.dtype == jnp.float16
    tp = dac_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype=torch.float16,
                      device="cpu")
    got = tdac_model.dac_from_indices(tp, config_from_jax(cfg, DACConfig),
                                      torch.from_numpy(codes))
    assert got.dtype == torch.float16
    want = _f32(want)
    assert 1e-3 < np.abs(want).max() < 1.0 and (want != 0).mean() > 0.99
    assert _max_ulps(got, want) <= 4


def _checkpoint(tmp_path, tokenizer):
    """A tiny fp32 LM and codec written by the port's writers (the codec
    with CODEC_GAIN, so its fp16 audio is not all zeros)."""
    from fish_speech_tpu_torch.config import dual_ar_tiny
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

    dac_cfg, jp = _loud_codec()
    cfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                       semantic_begin_id=tokenizer.semantic_begin_id,
                       semantic_end_id=tokenizer.semantic_end_id,
                       im_end_id=tokenizer.im_end_id, attention_qk_norm=True,
                       tie_word_embeddings=False, max_seq_len=256,
                       num_codebooks=dac_cfg.rvq.total_codebooks)
    ckpt = tmp_path / "ckpt"
    save_dual_ar(ckpt, init_dual_ar(3, cfg, torch.float32, "cpu"), cfg, tokenizer)
    save_codec(ckpt, dac_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu"), config_from_jax(dac_cfg, DACConfig))
    return ckpt


def _engines(ckpt, tmp_path, *flags):
    from fish_speech_tpu.server import main as jmain
    from fish_speech_tpu_torch.server import main as tmain

    argv = ["--checkpoint-path", str(ckpt), "--cpu", "--references-dir",
            str(tmp_path / "refs"), *flags]
    return jmain.build_engine(jmain.parse_args(argv)), tmain.build_engine(
        tmain.parse_args(argv))


def _leaf_dtypes(tree):
    out = set()
    jax.tree_util.tree_map(lambda a: out.add(a.dtype), tree)
    return out


@pytest.mark.parametrize("half", [False, True])
def test_build_engine_dtypes_codes_and_waveform_follow_jax(tmp_path, tokenizer, half):
    """`build_engine` loads the LM and the codec in bf16, or fp16 under
    `--half`, as JAX's does. Under `--half` greedy codes equal JAX's
    engine's on the same checkpoint over 12 new tokens (in bf16, with 8
    significant bits, a near tie of this random model's logits parts them;
    from ~19 tokens on it repeats itself, and RAS draws its high-temperature
    sample from each package's own uniforms). The codec's
    waveform of the same codes is within 2 ulps of max |audio| (fp16 or
    bf16 ulps) of JAX's engine's."""
    ckpt = _checkpoint(tmp_path, tokenizer)
    jeng, teng = _engines(ckpt, tmp_path, *(["--half"] if half else []))
    want_t, want_j = (torch.float16, jnp.float16) if half else (torch.bfloat16,
                                                                 jnp.bfloat16)
    assert teng.session.dtype == want_t
    assert teng.session.params["layers"]["wqkv"].dtype == want_t
    assert _leaf_dtypes(teng.codec_params) == {want_t}
    assert _leaf_dtypes(jeng.codec_params) == {jnp.dtype(want_j)}
    prompt = random_prompt(teng.session.cfg, 40, np.random.default_rng(5))
    gen = dict(max_new_tokens=12, temperature=0.7, top_p=0.9, top_k=1)
    got = np.concatenate(list(teng.session.generate_stream(
        prompt, teng.session.new_generator(0), **gen)), axis=1)
    if half:
        want = np.concatenate(list(jeng.session.generate_stream(
            prompt, jax.random.PRNGKey(0), **gen)), axis=1)
        np.testing.assert_array_equal(got, want)
    codes = got[1:]
    audio = teng.decode_vq_tokens(codes)
    assert audio.dtype == np.float32
    ref = np.asarray(jeng.decode_vq_tokens(codes), np.float32)
    peak = np.abs(ref).max()
    step = _ulp(peak) if half else 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert 0 < peak and np.abs(audio - ref).max() <= 2 * step


def test_half_over_int4_leaves_raises_naming_item_12b(tmp_path, tokenizer):
    from fish_speech_tpu_torch.server import main as tmain
    from fish_speech_tpu_torch.utils.checkpoint import (load_params,
                                                        save_dual_ar)
    from fish_speech_tpu_torch.config import DualARConfig as TCfg

    ckpt = _checkpoint(tmp_path, tokenizer)
    params = load_params(ckpt, dtype=torch.float32, device="cpu")
    quant = tquant.quantize_dual_ar_lowmem(params, mode="int4")
    save_dual_ar(tmp_path / "int4", quant, TCfg.from_json(str(ckpt / "config.json")),
                 tokenizer)
    argv = ["--checkpoint-path", str(tmp_path / "int4"), "--cpu",
            "--decoder-checkpoint-path", str(ckpt)]
    with pytest.raises(NotImplementedError, match="item 12b"):
        tmain.build_engine(tmain.parse_args(argv + ["--half"]))
    assert tmain.has_int4_leaves(quant) and not tmain.has_int4_leaves(params)
    # the same checkpoint in bf16 is served
    assert tmain.build_engine(tmain.parse_args(argv)).session.dtype == torch.bfloat16


def test_check_args_takes_half_with_every_serving_flag():
    from fish_speech_tpu_torch.server import main as tmain

    for extra in ([], ["--int8"], ["--kv-int8"], ["--pool-size", "32"],
                  ["--prefix-cache", "4"],
                  ["--int8", "--kv-int8", "--pool-size", "32", "--prefix-cache", "4"]):
        tmain.check_args(tmain.parse_args(["--half", *extra]))
    multi = ["--coordinator", "h:1", "--num-hosts", "2", "--host-id", "0"]
    tmain.check_args(tmain.parse_args(multi + ["--half", "--kv-int8"]), multihost=True)


def test_batch_tts_serves_half_through_build_engine(tmp_path, tokenizer):
    """`tools/batch_tts.py --half` on the checkpoint: a two-item job through
    an fp16 pool of two slots, every item ok with audio."""
    from fish_speech_tpu_torch.tools.batch_tts import main

    ckpt = _checkpoint(tmp_path, tokenizer)
    job = tmp_path / "job.tsv"
    job.write_text("first\tThe first line.\nsecond\tThe second line.\n")
    out = tmp_path / "out"
    rc = main(["--input", str(job), "--output-dir", str(out), "--checkpoint-path",
               str(ckpt), "--half", "--cpu", "--pool-size", "2",
               "--decode-chunk-size", "4", "--max-new-tokens", "8",
               "--references-dir", str(tmp_path / "refs")])
    assert rc == 0
    rows = [json.loads(line) for line in (out / "manifest.jsonl").read_text().splitlines()]
    assert sorted(r["id"] for r in rows) == ["first", "second"]
    assert all(r["status"] == "ok" for r in rows)
    for name in ("first", "second"):
        audio, _ = read_wav(out / f"{name}.wav")
        assert audio.shape[1] > 0 and np.isfinite(audio).all()
