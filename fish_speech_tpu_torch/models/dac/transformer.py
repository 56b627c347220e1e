"""Window-limited causal transformer used inside the codec (port of
`fish_speech_tpu/models/dac/transformer.py`). Its windowed attention was
plain XLA in the JAX package, so it is plain PyTorch here."""

from __future__ import annotations

import torch.nn.functional as F

from fish_speech_tpu_torch.config import CodecTransformerConfig
from fish_speech_tpu_torch.ops.attention import (causal_mask, gqa_attention,
                                                 windowed_causal_mask)
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.rope import apply_rope, precompute_rope


def codec_transformer(params, cfg: CodecTransformerConfig, x):
    """x: (B, T, C_in) -> (B, T, C_in)."""
    cfg = cfg.resolve()
    if "input_proj" in params:
        x = x @ params["input_proj"]["w"] + params["input_proj"]["b"]
    t = x.shape[1]
    # bf16 table on purpose: the trained codec saw bf16-rounded angles
    freqs = precompute_rope(t, cfg.head_dim, cfg.rope_base, device=x.device)
    if cfg.window_size is not None:
        mask = windowed_causal_mask(t, cfg.window_size, device=x.device)
    else:
        mask = causal_mask(t, device=x.device)

    n_head, n_kv, head_dim = cfg.n_head, cfg.n_local_heads, cfg.head_dim
    q_size = n_head * head_dim
    kv_size = n_kv * head_dim
    layers = params["layers"]
    for i in range(layers["wqkv"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        qkv = h @ lp["wqkv"]
        b, s, _ = qkv.shape
        q = qkv[..., :q_size].reshape(b, s, n_head, head_dim)
        k = qkv[..., q_size : q_size + kv_size].reshape(b, s, n_kv, head_dim)
        v = qkv[..., q_size + kv_size :].reshape(b, s, n_kv, head_dim)
        q = apply_rope(q, freqs)
        k = apply_rope(k, freqs)
        y = gqa_attention(q, k, v, mask).reshape(b, s, -1) @ lp["wo"]
        x = x + y * lp["attn_scale"]
        h2 = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        ffn = (F.silu(h2 @ lp["w1"]) * (h2 @ lp["w3"])) @ lp["w2"]
        x = x + ffn * lp["ffn_scale"]
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if "output_proj" in params:
        x = x @ params["output_proj"]["w"] + params["output_proj"]["b"]
    return x
