"""The port's weight quantization against the JAX package's, on the CPU.

Inputs come from numpy with a seed; both packages get the same arrays.

  * `quantize_int8` / `quantize_int4` give bitwise-equal leaves (the same
    fp32 division and round-half-even on both sides);
  * `mm` over int8 and int4 weights agrees with JAX's `mm` to 1e-5 abs
    (fp32, only the summation order differs);
  * `int4_matmul_reference` (the CUDA kernel's plain version) agrees with
    JAX's `int4_matmul_reference` to 1e-5 and with the Pallas kernel in
    interpret mode to the kernel's bf16 rounding of the scales (2^-8 of
    |x| @ |W|, elementwise);
  * quantized and fused trees have JAX's structure, a quantized JAX tree
    crosses the bridge leaf for leaf, and a quantized checkpoint written by
    JAX's `save_dual_ar` reads back equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import DualARConfig as JDualARConfig
from fish_speech_tpu.config import dual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu.ops.pallas_int4 import int4_matmul as j_int4_matmul
from fish_speech_tpu.ops.pallas_int4 import \
    int4_matmul_reference as j_int4_reference
from fish_speech_tpu.utils.checkpoint import save_dual_ar
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import quant as tquant
from fish_speech_tpu_torch.ops.int4 import int4_matmul, int4_matmul_reference
from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

torch.set_num_threads(1)
ATOL = 1e-5


def _w(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


def _tree_close(got, want, path=""):
    """Equal integers, floating leaves within 1 fp32 ulp (rtol 2^-23)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, path
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0, err_msg=path)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (128, 7)])
def test_quantize_int8_is_bitwise_jax(shape):
    w = _w(shape, seed=1)
    w[..., 0, :] = 0.0  # a zero row; and a zero column below
    w[..., 3] = 0.0
    got = tquant.quantize_int8(torch.from_numpy(w))
    want = jquant.quantize_int8(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    _tree_equal(got, want)
    _tree_equal(tquant.dequantize_int8(got, torch.float32),
                jquant.dequantize_int8(want, jnp.float32))


@pytest.mark.parametrize("shape,g", [((64, 48), 32), ((2, 256, 40), 128),
                                     ((128, 200), 64), ((96, 24), 16)])
def test_quantize_int4_is_bitwise_jax(shape, g):
    w = _w(shape, seed=2)
    got = tquant.quantize_int4(torch.from_numpy(w), group_size=g)
    want = jquant.quantize_int4(jnp.asarray(w), group_size=g)
    assert got["p"].dtype == torch.uint8
    _tree_equal(got, want)
    _tree_equal(tquant._int4_effective_weight(got, torch.float32),
                jquant._int4_effective_weight(want, jnp.float32))


@pytest.mark.parametrize("i,g_want", [(256, 128), (192, 32), (96, 16), (64, 32)])
def test_group_halving_rule_matches_jax(i, g_want):
    w = _w((i, 8), seed=3)
    got = tquant._quantize_weight(torch.from_numpy(w), "int4")
    want = jquant._quantize_weight(jnp.asarray(w), "int4", tquant.GROUP_SIZE)
    _tree_equal(got, want)
    assert 2 * got["p"].shape[0] // got["gs"].shape[0] == g_want


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_mm_matches_jax(mode, lead):
    w = _w((128, 72), seed=4)
    x = _w((*lead, 128), seed=5, scale=1.0)
    tw = tquant._quantize_weight(torch.from_numpy(w), mode)  # g = 64 (I/2)
    jw = jquant._quantize_weight(jnp.asarray(w), mode, tquant.GROUP_SIZE)
    got = tquant.mm(torch.from_numpy(x), tw)
    want = jquant.mm(jnp.asarray(x), jw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,i,o,g", [(1, 256, 200, 64), (1, 512, 384, 128),
                                     (300, 256, 136, 128), (300, 128, 264, 64)])
def test_int4_plain_matches_jax_reference_and_interpret_kernel(b, i, o, g):
    x = _w((b, i), seed=6, scale=1.0)
    qw = jquant.quantize_int4(jnp.asarray(_w((i, o), seed=7)), group_size=g)
    p, gs = np.asarray(qw["p"]), np.asarray(qw["gs"])
    got = int4_matmul_reference(torch.from_numpy(x), torch.from_numpy(p),
                                torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_int4_reference(x, p, gs)),
                               atol=ATOL, rtol=0)
    # the Pallas kernel rounds the scales to bf16: 2^-8 of each term's size
    kern = np.asarray(j_int4_matmul(jnp.asarray(x), jnp.asarray(p),
                                    jnp.asarray(gs), interpret=True))
    w_abs = np.abs(np.asarray(jquant._int4_effective_weight(qw, jnp.float32)))
    bound = 2.0 ** -8 * (np.abs(x) @ w_abs) + ATOL
    assert (np.abs(got - kern) <= bound).all()
    # a CPU tensor takes the plain version and counts no launch
    n0 = int4_matmul.launches
    np.testing.assert_array_equal(
        int4_matmul(torch.from_numpy(x), torch.from_numpy(p),
                    torch.from_numpy(gs)).numpy(), got)
    assert int4_matmul.launches == n0


def test_int4_rejects_a_group_that_straddles_the_half_split():
    p = torch.zeros((48, 8), dtype=torch.uint8)  # I = 96, I/2 = 48
    gs = torch.ones((3, 8))  # g = 32: 48 % 32 != 0
    with pytest.raises(ValueError, match="straddle"):
        int4_matmul_reference(torch.ones((1, 96)), p, gs)
    with pytest.raises(AssertionError, match="straddle"):
        j_int4_matmul(jnp.ones((1, 96)), jnp.asarray(p.numpy()),
                      jnp.asarray(gs.numpy()), interpret=True)


def _cfg(tokenizer, **kw):
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id,
                        tie_word_embeddings=False, **kw)


def _params(jcfg, seed=0):
    jp = jdual.init_dual_ar(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jp, dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                dtype=torch.float32)


@pytest.mark.parametrize("mode,fast_mode", [("int8", None), ("int4", None),
                                            ("int8", "int4")])
def test_quantized_and_fused_trees_match_jax(tokenizer, mode, fast_mode):
    jcfg = _cfg(tokenizer)
    cfg = config_from_jax(jcfg, DualARConfig)
    jp, tp = _params(jcfg)
    # whole trees: equal integers, scales within 1 ulp. XLA may compile
    # `absmax / 127.0` as a product with the reciprocal (always under the
    # lowmem path's jit), which moves some scales by 1 ulp; the per-leaf
    # tests above hold the quantizers bit for bit. The eager trees come
    # first: JAX's lowmem path donates the source buffers.
    jeager = dict(jquant.quantize_dual_ar(jp, mode=mode))
    jeager["fast"] = jquant.quantize_dual_ar(jp, mode=fast_mode or mode)["fast"]
    assert tquant.TARGETS == jquant.DEFAULT_TARGETS
    got = tquant.quantize_dual_ar_lowmem(tp, mode=mode, fast_mode=fast_mode)
    _tree_close(got, jeager)
    want = jquant.quantize_dual_ar_lowmem(jp, mode=mode, fast_mode=fast_mode)
    _tree_close(got, want)
    jf = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(want, jcfg))
    tf = tdual.fuse_ffn_weights(tdual.precompute_semantic_head(got, cfg))
    assert _structure(tf) == jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), jf,
        is_leaf=lambda a: hasattr(a, "shape"))
    _tree_close(tf, jf)


def test_bridge_carries_quantized_leaves(tokenizer):
    jcfg = _cfg(tokenizer)
    jp, _ = _params(jcfg, seed=1)
    jq = jquant.quantize_dual_ar(jp, mode="int4")
    jq["fast"]["output"]["s"] = jq["fast"]["output"]["s"].astype(jnp.bfloat16)
    leaves = jax.tree_util.tree_map(np.asarray, jq)
    _tree_equal(dual_ar_from_jax(leaves, dtype=torch.float32), jq)
    tq = dual_ar_from_jax(leaves, dtype=torch.bfloat16)
    assert tq["layers"]["wqkv"]["p"].dtype == torch.uint8
    assert tq["layers"]["wqkv"]["gs"].dtype == torch.float32
    assert tq["output"]["q"].dtype == torch.int8
    assert tq["output"]["s"].dtype == torch.float32
    assert tq["fast"]["output"]["s"].dtype == torch.bfloat16
    assert tq["embeddings"].dtype == torch.bfloat16  # plain leaves take dtype
    _tree_equal(tq["layers"]["w2"], jq["layers"]["w2"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_checkpoint_reads_back(tokenizer, tmp_path, dtype):
    jcfg = _cfg(tokenizer)
    jp, _ = _params(jcfg, seed=2)
    jq = jquant.quantize_dual_ar_lowmem(jp, mode="int8", fast_mode="int4")
    save_dual_ar(tmp_path, jax.tree_util.tree_map(np.asarray, jq), jcfg)
    tq, cfg = load_dual_ar(tmp_path, dtype=getattr(torch, dtype))
    assert isinstance(cfg, DualARConfig)
    assert config_from_jax(cfg, JDualARConfig) == jcfg.resolve()
    from fish_speech_tpu.utils.checkpoint import load_dual_ar as j_load
    want, _ = j_load(tmp_path, dtype=getattr(jnp, dtype))
    assert tq["layers"]["w1"]["q"].dtype == torch.int8
    assert tq["fast"]["layers"]["w1"]["p"].dtype == torch.uint8
    assert tq["layers"]["w1"]["s"].dtype == getattr(torch, dtype)
    _tree_equal(tq, want)
