"""Normalization ops (fp32 internal math, cast back to input dtype)."""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm over the last axis: normalize in fp32, cast back to x's dtype,
    THEN scale by the (possibly bf16) weight (`fish_speech_tpu/ops/norms.py`)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight
