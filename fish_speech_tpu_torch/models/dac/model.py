"""Modded-DAC codec decoder (port of the decode half of
`fish_speech_tpu/models/dac/model.py`): (B, 1+N, T') codes -> (B, 1, T)
waveform. The encoder (`dac_encode`) is a ROADMAP item."""

from __future__ import annotations

import torch

from fish_speech_tpu.config import DACConfig
from fish_speech_tpu_torch.models.dac.conv import (causal_conv1d,
                                                   causal_conv_transpose1d,
                                                   snake)
from fish_speech_tpu_torch.models.dac.rvq import downsample_rvq_decode

_DILATIONS = (1, 3, 9)


def residual_unit(params, x, dilation):
    y = snake(x, params["alpha1"])
    y = causal_conv1d(y, params["conv1"]["w"], params["conv1"]["b"],
                      dilation=dilation)
    y = snake(y, params["alpha2"])
    y = causal_conv1d(y, params["conv2"]["w"], params["conv2"]["b"])
    return x + y


def decoder_forward(params, cfg: DACConfig, z):
    """z: (B, T', latent) -> (B, T'*hop, 1) waveform in [-1, 1]."""
    x = causal_conv1d(z, params["conv_in"]["w"], params["conv_in"]["b"])
    for block, stride in zip(params["blocks"], cfg.decoder_rates):
        x = snake(x, block["alpha"])
        x = causal_conv_transpose1d(x, block["conv"]["w"], block["conv"]["b"],
                                    stride=stride)
        for unit, dil in zip(block["units"], _DILATIONS):
            x = residual_unit(unit, x, dil)
    x = snake(x, params["alpha_out"])
    x = causal_conv1d(x, params["conv_out"]["w"], params["conv_out"]["b"])
    return torch.tanh(x)


def dac_from_indices(params, cfg: DACConfig, codes):
    """codes (B, 1+N, T') -> audio (B, 1, T'*frame_length)."""
    z = downsample_rvq_decode(params["quantizer"], cfg.rvq, codes)
    return decoder_forward(params["decoder"], cfg, z).transpose(1, 2)
