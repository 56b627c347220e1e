"""Rotary position embeddings, adjacent-pair layout.

Head dims are grouped as (d/2, 2) adjacent real/imag pairs (NOT rotate-half)
and the table stores [cos, sin] on a trailing axis of size 2, as in
`fish_speech_tpu/ops/rope.py`.
"""

import functools

import numpy as np
import torch


def precompute_rope(seq_len: int, n_elem: int, base: float = 10000.0,
                    dtype=torch.bfloat16, device=None):
    """Returns the rope table (seq_len, n_elem // 2, 2).

    Built in float64 numpy and rounded once to `dtype` (bf16 by default, as
    the JAX package does), so both packages hold the same rounded angles.
    """
    freqs = 1.0 / (
        base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float64) / n_elem)
    )
    t = np.arange(seq_len, dtype=np.float64)
    angles = np.outer(t, freqs)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table).to(dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def rope_table(seq_len: int, n_elem: int, base: float, device) -> torch.Tensor:
    """The default bf16 table, built once per (shape, base, device): the
    decode loop reads one row per step and must not rebuild it, and a CUDA
    graph reads the tensor it was captured with, so no entry is ever
    evicted (the keys are the few lengths the models run: max_seq_len, the
    codebooks, the codec's buckets). Callers only read the shared tensor."""
    return precompute_rope(seq_len, n_elem, base, device=device)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, D) by the table slice freqs (S, D//2, 2); the
    table is upcast to fp32 and the result cast back to x's dtype."""
    *lead, s, h, d = x.shape
    xf = x.float().reshape(*lead, s, h, d // 2, 2)
    fr = freqs.float().reshape(*([1] * len(lead)), s, 1, d // 2, 2)
    real = xf[..., 0] * fr[..., 0] - xf[..., 1] * fr[..., 1]
    imag = xf[..., 1] * fr[..., 0] + xf[..., 0] * fr[..., 1]
    return torch.stack([real, imag], dim=-1).reshape(x.shape).to(x.dtype)
