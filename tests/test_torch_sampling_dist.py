"""The port's sampler draws from the JAX package's filtered distribution.

`sample_topk` (top-k / top-p on the untempered softmax, then temperature,
then the exponential race) is held to `logits_to_probs` of the JAX package
on the same logits: N draws in one batched call with a seeded
`torch.Generator`, a token that JAX gives probability 0 is never drawn,
and a chi-square goodness-of-fit test of the counts against N * probs
gives a p-value above 1e-3 (seeded, so the outcome is fixed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fish_speech_tpu.ops.sampling import logits_to_probs
from fish_speech_tpu_torch.ops.sampling import sample_topk, topk_state

VOCAB = 200
N_DRAWS = 40_000


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.7, 0.8, 30),
    (1.0, 1.0, 64),
    (0.3, 0.5, 10),
    (1.5, 0.95, 64),
    (1.0, 0.9, 5),
])
def test_sample_topk_matches_jax_distribution(temperature, top_p, top_k):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal(VOCAB) * 2.0).astype(np.float32)
    # no cumulative probability lies near the top-p cut, so fp32 sums in
    # another order cannot move a token across it
    cum = np.cumsum(np.sort(np.exp(logits - logits.max()))[::-1].astype(np.float64))
    assert np.abs(cum / cum[-1] - top_p).min() > 1e-4 or top_p == 1.0

    probs = np.asarray(logits_to_probs(jnp.asarray(logits), temperature, top_p,
                                       top_k), dtype=np.float64)
    state = topk_state(torch.from_numpy(np.tile(logits, (N_DRAWS, 1))))
    gen = torch.Generator().manual_seed(11)
    tokens = sample_topk(state, temperature, top_p, top_k, generator=gen)
    assert tokens.shape == (N_DRAWS,) and tokens.dtype == torch.int32
    counts = np.bincount(tokens.numpy(), minlength=VOCAB)

    assert counts[probs == 0].sum() == 0, np.nonzero(counts * (probs == 0))
    kept = probs > 0
    assert kept.sum() >= 2
    expected = probs[kept] * N_DRAWS
    # bins expected below 5 draws are pooled into one
    small = expected < 5
    obs = np.append(counts[kept][~small], counts[kept][small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    p_value = stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue
    assert p_value > 1e-3, (p_value, int(kept.sum()))
