"""Top-k / top-p / temperature sampling and Repetition-Aware Sampling (RAS).

Port of the decode fast path of `fish_speech_tpu/ops/sampling.py`: top-p and
top-k are applied to the untempered softmax over the top-`TOP_K_CAP`
logits, rank 0 is always kept, then temperature is applied and the
exponential race `argmax(p / -log u)` draws the sample. The uniforms come
from a `torch.Generator`, or are passed in as `u` so that a test can feed
both packages the same numbers (JAX's threefry and torch's Philox give
different bits from one seed).

The decode pool (`engine/batcher.py`) samples each row with its own
parameters (`sample_topk` on (B,) tensors: JAX's `sample_topk_rows`) and
its own uniforms, which `counter_uniforms` computes on the device from the
row's request seed and draw index: a counter-based hash, so what a request draws does not depend
on its slot, its neighbours or how its steps were cut into chunks (CUDA's
Philox generator rounds its offset per call, so one fill of 8 steps does
not draw what two fills of 4 draw).
"""

from typing import Optional

import torch

TOP_K_CAP = 64  # static top-k width of the fast path (runtime top_k <= cap)
_TINY = torch.finfo(torch.float32).tiny  # minval of the uniforms, as in JAX
UNIFORM_SLOW, UNIFORM_RAS, UNIFORM_FAST = 0, 1, 2  # rows of a step's block


def uniform_rows(num_codebooks: int) -> int:
    """Rows of uniforms one decode step reads: the slow head's two samples
    and one for each of the fast stack's num_codebooks - 1 codebooks."""
    return UNIFORM_FAST + num_codebooks - 1


def fill_uniforms(block: torch.Tensor, generator: torch.Generator):
    """Fill `block` in place with uniforms in [tiny, 1) from `generator`."""
    return block.uniform_(generator=generator).clamp_(min=_TINY)


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


def _per_row(x):
    """A (B,) tensor of per-row values as a (B, 1) column; numbers and 0-d
    tensors as they are."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() else x


def sample_topk(state, temperature: float, top_p: float, top_k: int,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw one token from a `topk_state`. Returns int32 vocab indices (...,).

    temperature, top_p, top_k: numbers, 0-d tensors, or (B,) tensors of
    per-row values (JAX's `sample_topk_rows`). `u` may be wider than the
    state's k (a row of the uniform block): its first k values are used."""
    vals, idx, lse = state
    k_cap = vals.shape[-1]
    temperature, top_p, top_k = map(_per_row, (temperature, top_p, top_k))
    probs = torch.exp(vals - lse[..., None])  # true softmax probs of the top-k
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(k_cap, device=vals.device)
    remove = (cum > top_p) | (ranks >= top_k)  # top_k above k_cap keeps all
    remove[..., 0] = False
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.clamp(min=1e-5)
    else:
        temperature = max(temperature, 1e-5)
    p = torch.softmax(vals.masked_fill(remove, float("-inf")) / temperature,
                      dim=-1)
    if u is None:  # uniforms in [tiny, 1)
        u = torch.rand(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32).clamp_(min=_TINY)
    else:
        u = u[..., :k_cap]
    choice = torch.argmax(p / -torch.log(u), dim=-1)
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32 for int64 x in [0, 2**32), in 16-bit halves of c so
    that no int64 product overflows (CPU and CUDA give the same bits)."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniforms(seed: torch.Tensor, draw: torch.Tensor, n_rows: int,
                     k: int = TOP_K_CAP) -> torch.Tensor:
    """(B, n_rows, k) fp32 uniforms in (0, 1) for draw `draw[b]` of the
    request seeded `seed[b]` (both (B,) int64 on the device): element e is
    a keyed hash of (draw * n_rows * k + e), its top 24 bits centred in
    their interval. A pure function of (seed, draw), computed on the
    device, so a CUDA graph of a step draws a row's next uniforms from the
    row's own counter and the same request draws the same numbers whatever
    its slot, its neighbours or its chunks."""
    width = n_rows * k
    e = torch.arange(width, device=seed.device, dtype=torch.int64)
    key = _mix32((seed & _M32) ^ 0x9E3779B9)[:, None]
    key2 = _mix32(key ^ 0x85EBCA6B)
    ctr = (draw[:, None] * width + e) & _M32
    h = _mix32(_mix32(ctr ^ key) ^ key2)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return u.reshape(-1, n_rows, k)


def ras_select(token_normal, token_high, prev_window, semantic_begin_id: int,
               semantic_end_id: int):
    """Use the high-temperature sample where the normal one is a semantic
    token already in the rolling window (B, W)."""
    in_window = (prev_window == token_normal[:, None]).any(dim=-1)
    is_semantic = (token_normal >= semantic_begin_id) & (
        token_normal <= semantic_end_id
    )
    return torch.where(in_window & is_semantic, token_high, token_normal)
