"""The port's naive single-AR model (`models/naive.py`) against the JAX
package's on the same weights (CPU, fp32): `forward_train_naive` on
parameters bridged from JAX's `init_naive`, with and without a pad mask,
gives both logits within 1e-4 of JAX's; `init_naive` draws JAX's shapes
and dtypes, and the bridge carries the naive tree (`codebook_norm`,
`codebook_output`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dual_ar_tiny
from fish_speech_tpu.models import naive as jnaive
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.convert.from_jax import config_from_jax, dual_ar_from_jax
from fish_speech_tpu_torch.models import naive as tnaive

torch.set_num_threads(1)

CASES = {
    "tied": dict(),
    "untied_qk_norm_biases": dict(tie_word_embeddings=False,
                                  attention_qk_norm=True,
                                  attention_qkv_bias=True, attention_o_bias=True),
}


def _cfg(tokenizer, case):
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id, max_seq_len=128,
                        **CASES[case])


def _inputs(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    inp = np.zeros((b, cfg.num_codebooks + 1, t), np.int32)
    inp[:, 0] = rng.integers(0, cfg.vocab_size, (b, t))
    semantic = rng.random((b, t)) < 0.5
    inp[:, 0][semantic] = rng.integers(cfg.semantic_begin_id,
                                       cfg.semantic_end_id + 1, semantic.sum())
    inp[:, 1:] = rng.integers(0, cfg.codebook_size, (b, cfg.num_codebooks, t))
    pad = np.zeros((b, t), bool)
    pad[1, t - 9:] = True  # row 1 right-padded
    return inp, pad


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_train_naive_matches_jax(tokenizer, case, padded):
    jcfg = _cfg(tokenizer, case)
    cfg = config_from_jax(jcfg, DualARConfig)
    jp = jnaive.init_naive(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32, device="cpu")
    assert {"codebook_norm", "codebook_output"} <= tp.keys()
    inp, pad = _inputs(cfg, 2, 24, seed=1)
    jl, jc = jnaive.forward_train_naive(
        jp, jcfg, jnp.asarray(inp), pad_mask=jnp.asarray(pad) if padded else None)
    with torch.no_grad():
        tl, tc = tnaive.forward_train_naive(
            tp, cfg, torch.from_numpy(inp),
            pad_mask=torch.from_numpy(pad) if padded else None)
    assert tl.dtype == tc.dtype == torch.float32
    assert tuple(tc.shape) == (2, 24, cfg.num_codebooks, cfg.codebook_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)


def test_init_naive_has_jax_shapes(tokenizer):
    for case in CASES:
        jcfg = _cfg(tokenizer, case)
        jp = jnaive.init_naive(jax.random.PRNGKey(0), jcfg)
        tp = tnaive.init_naive(0, config_from_jax(jcfg, DualARConfig),
                               device="cpu")
        want = jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype.name), jp)
        got = jax.tree_util.tree_map(
            lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]), tp)
        assert got == want


def test_init_naive_refuses_cuda_without_a_card(tokenizer):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnaive.init_naive(0, config_from_jax(_cfg(tokenizer, "tied"), DualARConfig))
