"""Modded-DAC codec (port of `fish_speech_tpu/models/dac/model.py`):
`dac_encode` (B, 1, T) waveform -> (B, 1+N, T') codes through the causal
conv encoder and the RVQ, `dac_from_indices` codes -> waveform through the
causal conv decoder; `init_dac` draws random weights for both halves.
`dac_forward` is the training round trip (audio -> codes -> audio and the
VQ losses), `dac_decode` a latent's decode."""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.config import CodecTransformerConfig, DACConfig
from fish_speech_tpu_torch.models.dac.conv import (causal_conv1d,
                                                   causal_conv_transpose1d,
                                                   snake)
from fish_speech_tpu_torch.models.dac.rvq import (downsample_rvq_codes,
                                                  downsample_rvq_decode,
                                                  downsample_rvq_encode)
from fish_speech_tpu_torch.models.dac.transformer import codec_transformer
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_DILATIONS = (1, 3, 9)


def residual_unit(params, x, dilation):
    y = snake(x, params["alpha1"])
    y = causal_conv1d(y, params["conv1"]["w"], params["conv1"]["b"],
                      dilation=dilation)
    y = snake(y, params["alpha2"])
    y = causal_conv1d(y, params["conv2"]["w"], params["conv2"]["b"])
    return x + y


def _encoder_block_tcfg(cfg: DACConfig, d_out: int, n_t: int):
    """Per-block transformer config (`modded_dac.py:638-649`): n_head =
    dim // 64, intermediate = 3*dim, encoder window size."""
    return CodecTransformerConfig(
        n_layer=n_t,
        n_head=max(d_out // 64, 1),
        dim=d_out,
        intermediate_size=d_out * 3,
        head_dim=64 if d_out >= 64 else d_out,
        window_size=cfg.encoder_transformer_window,
    ).resolve()


def encoder_forward(params, cfg: DACConfig, x):
    """x: (B, T, 1) audio -> (B, T/hop, latent_dim)."""
    x = causal_conv1d(x, params["conv_in"]["w"], params["conv_in"]["b"])
    d = cfg.encoder_dim
    for block, stride, n_t in zip(params["blocks"], cfg.encoder_rates,
                                  cfg.encoder_transformer_layers):
        d *= 2
        for unit, dil in zip(block["units"], _DILATIONS):
            x = residual_unit(unit, x, dil)
        x = snake(x, block["alpha"])
        x = causal_conv1d(x, block["conv"]["w"], block["conv"]["b"], stride=stride)
        if "transformer" in block:
            x = codec_transformer(block["transformer"],
                                  _encoder_block_tcfg(cfg, d, n_t), x)
    x = snake(x, params["alpha_out"])
    return causal_conv1d(x, params["conv_out"]["w"], params["conv_out"]["b"])


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


def dac_encode(params, cfg: DACConfig, audio, audio_lengths=None):
    """Encode audio to codes (`modded_dac.py:874-923`): right-pad to a
    multiple of `frame_length`; code_lengths = ceil(len / frame_length),
    computed in float32 as JAX does.

    Args:
      audio: (B, 1, T) or (B, T) waveform.
      audio_lengths: optional (B,) true lengths.

    Returns (codes (B, 1+N, T'), code_lengths (B,) int32). Runs the encoder
    and the quantizer up to the residual RVQ (`downsample_rvq_codes`).
    """
    if audio.dim() == 3:
        audio = audio[:, 0, :]
    b, t = audio.shape
    right_pad = math.ceil(t / cfg.frame_length) * cfg.frame_length - t
    x = torch.nn.functional.pad(audio, (0, right_pad))[..., None]  # (B, T, 1)
    if audio_lengths is None:
        audio_lengths = torch.full((b,), t + right_pad, dtype=torch.int32,
                                   device=audio.device)
    z = encoder_forward(params["encoder"], cfg, x)
    codes = downsample_rvq_codes(params["quantizer"], cfg.rvq, z)
    code_lengths = torch.ceil(audio_lengths.to(torch.float32)
                              / cfg.frame_length).to(torch.int32)
    return codes, code_lengths


def dac_decode(params, cfg: DACConfig, z):
    """Latent (B, T', D) -> audio (B, 1, T)."""
    return decoder_forward(params["decoder"], cfg, z).transpose(1, 2)


def dac_forward(params, cfg: DACConfig, audio, generator=None):
    """Training-style round trip: audio (B, 1, T) or (B, T), right-padded to
    a multiple of `hop_length` -> encoder -> the full quantizer forward
    (`downsample_rvq_encode`, under quantizer dropout drawn from
    `generator` when given) -> decoder. Returns (audio (B, 1, T) cropped to
    the input length, the quantizer's dict: z, codes, latents and the
    commitment and codebook losses)."""
    if audio.dim() == 3:
        audio = audio[:, 0, :]
    t = audio.shape[-1]
    right_pad = math.ceil(t / cfg.hop_length) * cfg.hop_length - t
    x = torch.nn.functional.pad(audio, (0, right_pad))[..., None]
    z = encoder_forward(params["encoder"], cfg, x)
    result = downsample_rvq_encode(params["quantizer"], cfg.rvq, z, generator)
    audio_out = decoder_forward(params["decoder"], cfg, result["z"])
    return audio_out.transpose(1, 2)[..., :t], result


def decode_half(params):
    """The part of a codec tree that `dac_from_indices` reads: the decoder
    and the quantizer's codebooks, out-projections, upsample and post
    transformer (no encoder, downsample, pre transformer or in-projections).
    Takes the JAX package's tree or the port's."""
    q = params["quantizer"]
    quantizer = {k: v for k, v in q.items() if k not in ("downsample", "pre")}
    for name in ("semantic", "residual"):
        quantizer[name] = [{k: v for k, v in vq.items() if k != "in_proj"}
                           for vq in q[name]]
    return {"quantizer": quantizer, "decoder": params["decoder"]}


# ---------------------------------------------------------------------------
# Random initialisation, in torch layout
# ---------------------------------------------------------------------------


def init_dac(seed: int, cfg: DACConfig, dtype=torch.float32,
             device=DEFAULT_DEVICE):
    """Random codec weights with the JAX `init_dac`'s shapes and scales
    (truncated-normal convs and transformer weights at std 0.02, normal
    codebooks, in/out projections at std 0.02, unit snake alphas), in the
    bridge's torch layout (`convert/from_jax.py:dac_from_jax`), drawn on
    `device` from a torch.Generator seeded with `seed`. Raises without CUDA
    unless `device` is the CPU."""
    device = resolve_device(device, "init_dac")
    gen = torch.Generator(device=device).manual_seed(seed)

    def trunc(shape, std=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * std).to(dtype)

    def normal(shape, std=1.0):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, std, generator=gen).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def conv(c_out, c_in, k):  # torch conv layout
        return {"w": trunc((c_out, c_in, k)), "b": full((c_out,), 0.0)}

    def conv_t(c_in, c_out, k):  # torch conv-transpose layout
        return {"w": trunc((c_in, c_out, k)), "b": full((c_out,), 0.0)}

    def unit(dim):
        return {"alpha1": full((dim,), 1.0), "conv1": conv(dim, dim, 7),
                "alpha2": full((dim,), 1.0), "conv2": conv(dim, dim, 1)}

    def transformer(tcfg, input_dim):
        tcfg = tcfg.resolve()
        n = tcfg.n_layer
        total_qkv = (tcfg.n_head + 2 * tcfg.n_local_heads) * tcfg.head_dim
        p = {
            "layers": {
                "attn_norm": full((n, tcfg.dim), 1.0),
                "wqkv": trunc((n, tcfg.dim, total_qkv)),
                "wo": trunc((n, tcfg.n_head * tcfg.head_dim, tcfg.dim)),
                "attn_scale": full((n, tcfg.dim), 1e-2),
                "ffn_norm": full((n, tcfg.dim), 1.0),
                "w1": trunc((n, tcfg.dim, tcfg.intermediate_size)),
                "w3": trunc((n, tcfg.dim, tcfg.intermediate_size)),
                "w2": trunc((n, tcfg.intermediate_size, tcfg.dim)),
                "ffn_scale": full((n, tcfg.dim), 1e-2),
            },
            "norm": full((tcfg.dim,), 1.0),
        }
        if input_dim != tcfg.dim:
            p["input_proj"] = {"w": trunc((input_dim, tcfg.dim)),
                               "b": full((tcfg.dim,), 0.0)}
            p["output_proj"] = {"w": trunc((tcfg.dim, input_dim)),
                                "b": full((input_dim,), 0.0)}
        return p

    d = cfg.encoder_dim
    blocks = []
    for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
        block = {"units": [unit(d) for _ in _DILATIONS],
                 "alpha": full((d,), 1.0), "conv": conv(2 * d, d, 2 * stride)}
        if n_t > 0:
            block["transformer"] = transformer(
                _encoder_block_tcfg(cfg, 2 * d, n_t), 2 * d)
        blocks.append(block)
        d *= 2
    encoder = {"conv_in": conv(cfg.encoder_dim, 1, 7), "blocks": blocks,
               "alpha_out": full((d,), 1.0),
               "conv_out": conv(cfg.resolved_latent_dim, d, 3)}

    rvq = cfg.rvq
    d = rvq.input_dim

    def vq(size):
        return {"in_proj": {"w": normal((d, rvq.codebook_dim), 0.02),
                            "b": full((rvq.codebook_dim,), 0.0)},
                "out_proj": {"w": normal((rvq.codebook_dim, d), 0.02),
                             "b": full((d,), 0.0)},
                "codebook": normal((size, rvq.codebook_dim))}

    def convnext(dim):
        return {
            "dwconv": conv(dim, 1, 7),
            "norm_w": full((dim,), 1.0),
            "norm_b": full((dim,), 0.0),
            "pw1": {"w": normal((dim, 4 * dim), 0.02), "b": full((4 * dim,), 0.0)},
            "pw2": {"w": normal((4 * dim, dim), 0.02), "b": full((dim,), 0.0)},
            "gamma": full((dim,), 1e-6),
        }

    quantizer = {
        "semantic": [vq(rvq.semantic_codebook_size)],
        "residual": [vq(rvq.codebook_size) for _ in range(rvq.n_codebooks)],
        "downsample": [{"conv": conv(d, d, f), "convnext": convnext(d)}
                       for f in rvq.downsample_factor],
        "upsample": [{"conv": conv_t(d, d, f), "convnext": convnext(d)}
                     for f in reversed(rvq.downsample_factor)],
    }
    if rvq.pre_transformer is not None:
        quantizer["pre"] = transformer(rvq.pre_transformer, d)
    if rvq.post_transformer is not None:
        quantizer["post"] = transformer(rvq.post_transformer, d)

    channels = cfg.decoder_dim
    dec_blocks = []
    for i, stride in enumerate(cfg.decoder_rates):
        d_in, d_out = channels // 2**i, channels // 2 ** (i + 1)
        dec_blocks.append({"alpha": full((d_in,), 1.0),
                           "conv": conv_t(d_in, d_out, 2 * stride),
                           "units": [unit(d_out) for _ in _DILATIONS]})
    decoder = {
        "conv_in": conv(channels, cfg.resolved_latent_dim, 7),
        "blocks": dec_blocks,
        "alpha_out": full((d_out,), 1.0),
        "conv_out": conv(1, d_out, 7),
    }
    return {"encoder": encoder, "quantizer": quantizer, "decoder": decoder}
