"""Top-k / top-p / temperature sampling and Repetition-Aware Sampling (RAS).

Port of the decode fast path of `fish_speech_tpu/ops/sampling.py`: top-p and
top-k are applied to the untempered softmax over the top-`TOP_K_CAP`
logits, rank 0 is always kept, then temperature is applied and the
exponential race `argmax(p / -log u)` draws the sample. The uniforms come
from a `torch.Generator`, or are passed in as `u` so that a test can feed
both packages the same numbers (JAX's threefry and torch's Philox give
different bits from one seed).
"""

from typing import Optional

import torch

TOP_K_CAP = 64  # static top-k width of the fast path (runtime top_k <= cap)
_TINY = torch.finfo(torch.float32).tiny  # minval of the uniforms, as in JAX


def check_top_k(top_k, k_cap: int = TOP_K_CAP):
    """Reject a runtime top_k above the fast path's cap (the top-p cutoff is
    evaluated over only the top-`k_cap` logits)."""
    if int(top_k) > k_cap:
        raise ValueError(
            f"top_k={int(top_k)} exceeds the decode fast path's static cap "
            f"{k_cap} (top-p is evaluated over the top-{k_cap} logits). "
            f"Use top_k <= {k_cap}."
        )


def topk_state(logits: torch.Tensor, k_cap: int = TOP_K_CAP):
    """(vals (..., k) descending, idx (..., k), lse (...)) of fp32 logits,
    shared by the several samples drawn from one row."""
    lf = logits.float()
    vals, idx = torch.topk(lf, min(k_cap, lf.shape[-1]), dim=-1)
    return vals, idx, torch.logsumexp(lf, dim=-1)


def sample_topk(state, temperature: float, top_p: float, top_k: int,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw one token from a `topk_state`. Returns int32 vocab indices (...,)."""
    vals, idx, lse = state
    k_cap = vals.shape[-1]
    top_k = min(int(top_k), k_cap)
    probs = torch.exp(vals - lse[..., None])  # true softmax probs of the top-k
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(k_cap, device=vals.device)
    remove = (cum > top_p) | (ranks >= top_k)
    remove[..., 0] = False
    filtered = vals.masked_fill(remove, float("-inf")) / max(temperature, 1e-5)
    p = torch.softmax(filtered, dim=-1)
    if u is None:  # uniforms in [tiny, 1)
        u = torch.rand(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32).clamp_(min=_TINY)
    choice = torch.argmax(p / -torch.log(u), dim=-1)
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


def ras_select(token_normal, token_high, prev_window, semantic_begin_id: int,
               semantic_end_id: int):
    """Use the high-temperature sample where the normal one is a semantic
    token already in the rolling window (B, W)."""
    in_window = (prev_window == token_normal[:, None]).any(dim=-1)
    is_semantic = (token_normal >= semantic_begin_id) & (
        token_normal <= semantic_end_id
    )
    return torch.where(in_window & is_semantic, token_high, token_normal)
