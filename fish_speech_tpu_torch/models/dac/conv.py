"""Causal 1D convolution primitives, channels-last (B, T, C).

Port of `fish_speech_tpu/models/dac/conv.py`: a causal conv left-pads
`k_eff - stride` and right-pads just enough for an integral frame count; a
causal transposed conv trims `kernel - stride` from the right.

Weights are in torch layout (the bridge converts the JAX package's):
  conv:            w (Cout, Cin/groups, K), b (Cout,)
  conv_transpose:  w (Cin, Cout, K),        b (Cout,)

The (B, T, C) <-> (B, C, T) swaps are views: a conv's output is returned as
a transposed view of its (B, C, T) result, elementwise ops keep that
memory order, and the next conv's swap is free.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def causal_pad_amounts(length: int, kernel: int, stride: int, dilation: int = 1):
    """(pad_left, pad_right) for a causal conv over `length` samples."""
    k_eff = (kernel - 1) * dilation + 1
    pad_left = k_eff - stride
    n_frames = (length - k_eff + pad_left) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_left)
    return pad_left, max(ideal - length, 0)


def causal_conv1d(x, w, b=None, stride: int = 1, dilation: int = 1,
                  groups: int = 1):
    """x: (B, T, Cin) -> (B, T', Cout)."""
    pad_left, pad_right = causal_pad_amounts(x.shape[1], w.shape[-1], stride,
                                             dilation)
    xc = F.pad(x.transpose(1, 2), (pad_left, pad_right))
    y = F.conv1d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def causal_conv_transpose1d(x, w, b=None, stride: int = 1):
    """x: (B, T, Cin) -> (B, T*stride, Cout)."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), stride=stride)
    pad = w.shape[-1] - stride
    if pad > 0:
        y = y[..., :-pad]
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def snake(x, alpha):
    """x + (1/(a+eps)) * sin(a x)^2 with per-channel a, in fp32."""
    xf = x.float()
    a = alpha.float()
    s = torch.sin(a * xf)
    return (xf + (1.0 / (a + 1e-9)) * s * s).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)
