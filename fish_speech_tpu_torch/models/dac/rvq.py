"""Residual vector quantization, decode half (port of
`fish_speech_tpu/models/dac/rvq.py`): codes -> summed codebook vectors ->
post transformer -> causal upsample with ConvNeXt blocks. Channels-last."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import RVQConfig
from fish_speech_tpu_torch.models.dac.conv import (causal_conv1d,
                                                   causal_conv_transpose1d,
                                                   layer_norm)
from fish_speech_tpu_torch.models.dac.transformer import codec_transformer


def vq_decode(params, codes):
    """codes (B, T) -> (B, T, D)."""
    z = F.embedding(codes.long(), params["codebook"])
    return z @ params["out_proj"]["w"] + params["out_proj"]["b"]


def rvq_decode(stack, codes):
    """codes (B, N, T) -> (B, T, D) summed over codebooks."""
    z_q = None
    for i, vq in enumerate(stack):
        zi = vq_decode(vq, codes[:, i])
        z_q = zi if z_q is None else z_q + zi
    return z_q


def convnext_block(params, x):
    """x: (B, T, C). Causal depthwise conv k7 -> LN -> MLP -> layer scale."""
    inp = x
    x = causal_conv1d(x, params["dwconv"]["w"], params["dwconv"]["b"],
                      groups=x.shape[-1])
    x = layer_norm(x, params["norm_w"], params["norm_b"], eps=1e-6)
    x = x @ params["pw1"]["w"] + params["pw1"]["b"]
    x = F.gelu(x)  # exact erf form, as jax.nn.gelu(approximate=False)
    x = x @ params["pw2"]["w"] + params["pw2"]["b"]
    return inp + x * params["gamma"]


def _upsample(params, cfg: RVQConfig, z):
    for stage, f in zip(params["upsample"], reversed(cfg.downsample_factor)):
        z = causal_conv_transpose1d(z, stage["conv"]["w"], stage["conv"]["b"],
                                    stride=f)
        z = convnext_block(stage["convnext"], z)
    return z


def downsample_rvq_decode(params, cfg: RVQConfig, codes):
    """codes (B, 1+N, T') -> z (B, T'*downsample, D)."""
    semantic = torch.clamp(codes[:, :1], 0, cfg.semantic_codebook_size - 1)
    residual = torch.clamp(codes[:, 1:], 0, cfg.codebook_size - 1)
    z_q = rvq_decode(params["semantic"], semantic) + rvq_decode(
        params["residual"], residual
    )
    if "post" in params:
        z_q = codec_transformer(params["post"], cfg.post_transformer, z_q)
    return _upsample(params, cfg, z_q)
