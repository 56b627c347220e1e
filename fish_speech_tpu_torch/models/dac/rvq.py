"""Residual vector quantization (port of `fish_speech_tpu/models/dac/rvq.py`).

Encode: causal x4 downsample with ConvNeXt blocks -> pre transformer ->
semantic RVQ (1 codebook) -> residual RVQ (N codebooks), each codebook
picked by argmax over L2-normalised vectors. Decode: codes -> summed
codebook vectors -> post transformer -> causal upsample. Channels-last.
In training (`dac_forward` with a generator) the residual quantizer keeps
a random number of its codebooks per sample (`quantizer_dropout_mask`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import RVQConfig
from fish_speech_tpu_torch.models.dac.conv import (causal_conv1d,
                                                   causal_conv_transpose1d,
                                                   layer_norm)
from fish_speech_tpu_torch.models.dac.transformer import codec_transformer


def _l2_normalize(x, eps=1e-12):
    # x * rsqrt(sum(x^2) + eps), as JAX: `F.normalize` clamps the norm
    # instead, which moves near ties of the argmax below
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def vq_encode(params, z):
    """Quantize z (B, T, D).

    Returns dict: z_q (B,T,D) straight-through + out-projected, codes (B,T),
    latents z_e (B,T,d), commitment/codebook losses (B,).
    """
    z_e = z @ params["in_proj"]["w"] + params["in_proj"]["b"]  # (B,T,d)
    codebook = params["codebook"]
    e = _l2_normalize(z_e.float())
    c = _l2_normalize(codebook.float())
    # argmax similarity == argmin L2-normalised distance; first index on ties
    codes = torch.argmax(torch.einsum("btd,kd->btk", e, c), dim=-1).to(torch.int32)
    z_q_latent = F.embedding(codes.long(), codebook)  # raw codebook rows

    z_ef = z_e.float()
    z_qf = z_q_latent.float()
    commitment = torch.mean((z_ef - z_qf.detach()) ** 2, dim=(1, 2))
    codebook_loss = torch.mean((z_qf - z_ef.detach()) ** 2, dim=(1, 2))

    # straight-through estimator, with JAX's rounding: z_e + (z_q - z_e)
    z_q_st = z_e + (z_q_latent.to(z_e.dtype) - z_e).detach()
    z_q = z_q_st @ params["out_proj"]["w"] + params["out_proj"]["b"]
    return {"z_q": z_q, "codes": codes, "latents": z_e,
            "commitment_loss": commitment, "codebook_loss": codebook_loss}


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


def rvq_encode(stack, z, n_active=None, dropout_mask=None):
    """Residual quantization. z: (B, T, D).

    Args:
      n_active: optional int — use only the first n codebooks (eval).
      dropout_mask: optional (B, len(stack)) float mask for quantizer dropout
        during training (1 = active).

    Returns dict with z_q, codes (B, N, T), latents (B, T, N*d), losses (B,).
    """
    z_q = torch.zeros_like(z)
    residual = z
    codes, latents = [], []
    commitment = 0.0
    codebook_loss = 0.0
    for i, vq in enumerate(stack):
        if n_active is not None and i >= n_active:
            break
        r = vq_encode(vq, residual)
        if dropout_mask is not None:
            m = dropout_mask[:, i][:, None, None].to(z_q.dtype)
            z_q = z_q + r["z_q"] * m
            ml = dropout_mask[:, i].float()
            commitment = commitment + r["commitment_loss"] * ml
            codebook_loss = codebook_loss + r["codebook_loss"] * ml
        else:
            z_q = z_q + r["z_q"]
            commitment = commitment + r["commitment_loss"]
            codebook_loss = codebook_loss + r["codebook_loss"]
        residual = residual - r["z_q"]
        codes.append(r["codes"])
        latents.append(r["latents"])
    return {"z_q": z_q, "codes": torch.stack(codes, dim=1),  # (B, N, T)
            "latents": torch.cat(latents, dim=-1),
            "commitment_loss": commitment, "codebook_loss": codebook_loss}


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


def _downsample(params, cfg: RVQConfig, z):
    for stage, f in zip(params["downsample"], cfg.downsample_factor):
        z = causal_conv1d(z, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        z = convnext_block(stage["convnext"], z)
    return z


def _upsample(params, cfg: RVQConfig, z):
    for stage, f in zip(params["upsample"], reversed(cfg.downsample_factor)):
        z = causal_conv_transpose1d(z, stage["conv"]["w"], stage["conv"]["b"],
                                    stride=f)
        z = convnext_block(stage["convnext"], z)
    return z


def quantizer_dropout_mask(cfg: RVQConfig, batch: int, generator):
    """Quantizer dropout (descript semantics, JAX's draw): with probability
    `cfg.quantizer_dropout` a sample keeps the first n of the residual
    codebooks, n uniform in [1, N], else all N. Returns (batch, N) fp32, 1
    where a codebook is active, on the generator's device; None when the
    config drops nothing."""
    if cfg.quantizer_dropout <= 0:
        return None
    n_full = cfg.n_codebooks
    dev = generator.device
    rand_n = torch.randint(1, n_full + 1, (batch,), generator=generator,
                           device=dev)
    use_dropout = (torch.rand((batch,), generator=generator, device=dev)
                   < cfg.quantizer_dropout)
    n_per_sample = torch.where(use_dropout, rand_n,
                               torch.full_like(rand_n, n_full))
    return (torch.arange(n_full, device=dev)[None, :]
            < n_per_sample[:, None]).to(torch.float32)


def _quantize(params, cfg: RVQConfig, z, dropout_mask=None):
    """Downsample, pre transformer, semantic then residual RVQ (the residual
    under `dropout_mask`, (B, N), if given): their two result dicts."""
    z = _downsample(params, cfg, z)
    if "pre" in params:
        z = codec_transformer(params["pre"], cfg.pre_transformer, z)
    sem = rvq_encode(params["semantic"], z)
    if dropout_mask is not None:
        dropout_mask = dropout_mask.to(z.device)
    return sem, rvq_encode(params["residual"], z - sem["z_q"],
                           dropout_mask=dropout_mask)


def downsample_rvq_codes(params, cfg: RVQConfig, z):
    """z (B, T, D) at the encoder frame rate -> codes (B, 1+N, T/downsample):
    `downsample_rvq_encode`'s codes, without the post transformer and the
    upsample that only its `z` needs (what `dac_encode` runs)."""
    sem, res = _quantize(params, cfg, z)
    return torch.cat([sem["codes"], res["codes"]], dim=1)


def downsample_rvq_encode(params, cfg: RVQConfig, z, generator=None):
    """Full quantizer forward. z: (B, T, D) at the encoder frame rate.

    Returns dict: z (B, T, D) reconstructed (padded/cropped on the left to
    the input length), codes (B, 1+N, T/downsample), latents, and the
    commitment and codebook losses (B,).

    Training: with `generator` (a `torch.Generator`) the residual quantizer
    runs under a quantizer-dropout mask drawn from it
    (`quantizer_dropout_mask`).
    """
    orig_t = z.shape[1]
    mask = (None if generator is None
            else quantizer_dropout_mask(cfg, z.shape[0], generator))
    sem, res = _quantize(params, cfg, z, mask)
    zq = sem["z_q"] + res["z_q"]
    if "post" in params:
        zq = codec_transformer(params["post"], cfg.post_transformer, zq)
    zq = _upsample(params, cfg, zq)
    diff = orig_t - zq.shape[1]
    if diff > 0:
        zq = F.pad(zq, (0, 0, diff, 0))
    elif diff < 0:
        zq = zq[:, -diff:, :]
    return {
        "z": zq,
        "codes": torch.cat([sem["codes"], res["codes"]], dim=1),  # (B, 1+N, T')
        "latents": torch.cat([sem["latents"], res["latents"]], dim=-1),
        "commitment_loss": sem["commitment_loss"] + res["commitment_loss"],
        "codebook_loss": sem["codebook_loss"] + res["codebook_loss"],
    }


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
