"""Attention ops in (B, T, H, D) layout, plain PyTorch.

`gqa_attention` is the einsum attention of `fish_speech_tpu/ops/attention.py`
(fp32 scores and softmax, weights cast to v's dtype before P.V). The prefill
and decode paths of the LM call the hand-written kernels in
`flash_prefill.py` and `flash_decode.py` instead; the codec's windowed
attention stays here, as it was plain XLA in the JAX package.
"""

import math

import torch

NEG_INF = -1e30  # large-negative instead of -inf: a row with no visible key
# softmaxes to a uniform average instead of NaN (it is masked downstream)


def gqa_attention(q, k, v, mask=None, scale=None):
    """Grouped-query attention.

    Args:
      q: (B, T, H, D)
      k, v: (B, S, Hkv, D) with H % Hkv == 0
      mask: bool, broadcastable to (B, T, S) or (T, S); True = attend.
      scale: defaults to 1/sqrt(D).

    Returns: (B, T, H, D) in q's dtype.
    """
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if mask is not None:
        while mask.dim() < 3:
            mask = mask[None]
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v)
    return out.reshape(b, t, h, d).to(q.dtype)


def causal_mask(t: int, device=None):
    i = torch.arange(t, device=device)
    return i[None, :] <= i[:, None]


def windowed_causal_mask(t: int, window: int, device=None):
    """Causal band: position i attends [max(0, i-window+1), i]."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return (j <= i) & (j >= i - (window - 1))


def gqa_attention_kv8(q, kq, ks, vq, vs, mask=None, scale=None):
    """Grouped-query attention over an int8 KV cache
    (`fish_speech_tpu/ops/attention.py:gqa_attention_kv8`).

    kq/vq: (B, S, Hkv, D) int8; ks/vs: (B, S, Hkv) per-(position, head)
    absmax scales (`dual_ar._kv_quant`). The scales fold into the scores
    and the probabilities: q.(k ks) == (q.k) ks and sum_j p_j (v_j vs_j) ==
    sum_j (p_j vs_j) v_j; p * vs is rounded to q's dtype before P.V, as in
    the JAX package."""
    b, t, h, d = q.shape
    hkv = kq.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          kq.to(q.dtype).float())
    ks_b = ks.float().permute(0, 2, 1)[:, :, None, None, :]
    scores = scores * (ks_b * scale)
    if mask is not None:
        while mask.dim() < 3:
            mask = mask[None]
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    vs_b = vs.float().permute(0, 2, 1)[:, :, None, None, :]
    weights = (weights * vs_b).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights.float(),
                       vq.to(q.dtype).float())
    return out.reshape(b, t, h, d).to(q.dtype)
