"""Decode attention: one query position over a stacked KV cache.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_decode.py`
(`flash_decode_attention`). On the single-stream path it computes exactly
what the JAX decode's einsum over the cache computes under the mask
`j <= pos` (`lengths = pos + 1`), for both the slow stack (S = max_seq_len +
chunk) and the fast stack (S = num_codebooks). The kernel is hand-written
CUDA for Hopper (`csrc/flash_decode.cu`). The TPU kernel padded the G query
heads of a KV head to Gp >= 8; this one takes any G <= 8 unpadded.
`flash_decode_reference` is the plain PyTorch version: the wrapper runs it
for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                 load_kernels)
from fish_speech_tpu_torch.ops.attention import NEG_INF

MAX_GROUP = 8  # query heads per KV head one kernel block serves


def flash_decode_reference(q, k_all, v_all, layer: int, lengths):
    """q (B, Hkv, G, D); k_all/v_all (L, B, S, Hkv, D); lengths (B,) = the
    visible prefix per row (pos + 1), in [1, S]. Returns (B, Hkv, G, D):
    fp32 scores, softmax and P.V (`pallas_decode.flash_decode_reference`)."""
    d = q.shape[-1]
    k = k_all[layer].float()
    v = v_all[layer].float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(d)
    j = torch.arange(k.shape[1], device=q.device)
    mask = j[None, :] < lengths.to(q.device)[:, None]  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w, v).to(q.dtype)


def _check(q, k_all, v_all, layer, lengths):
    if not (q.is_cuda and k_all.device == q.device and v_all.device == q.device
            and lengths.device == q.device):
        raise ValueError("flash_decode_attention: q, k_all, v_all and lengths "
                         "must lie on one CUDA device")
    if (q.dtype not in DTYPE_CODES or k_all.dtype != q.dtype
            or v_all.dtype != q.dtype):
        raise TypeError(f"flash_decode_attention: bf16 or fp32 of one dtype, "
                        f"got {q.dtype}/{k_all.dtype}/{v_all.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode_attention: lengths must be int32")
    if q.dim() != 4 or k_all.dim() != 5 or k_all.shape != v_all.shape:
        raise ValueError("flash_decode_attention: q (B,Hkv,G,D), "
                         "k_all/v_all (L,B,S,Hkv,D)")
    b, hkv, g, d = q.shape
    n_layer, kb, _, khkv, kd = k_all.shape
    if (kb, khkv, kd) != (b, hkv, d):
        raise ValueError(f"flash_decode_attention: cache {tuple(k_all.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"flash_decode_attention: layer {layer} out of range")
    if d not in (64, 128) or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode_attention: D={d} not in (64, 128) or "
                         f"G={g} not in [1, {MAX_GROUP}]")
    if tuple(lengths.shape) != (b,):
        raise ValueError("flash_decode_attention: lengths must be (B,)")
    for name, x in (("q", q), ("k_all", k_all), ("v_all", v_all),
                    ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode_attention: {name} must be contiguous")


def flash_decode_attention(q, k_all, v_all, layer: int, lengths):
    """Same contract as `flash_decode_reference`; on CUDA tensors runs the
    hand-written kernel, which reads only the first lengths[b] positions."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_all, v_all, layer, lengths)
    _check(q, k_all, v_all, layer, lengths)
    lib = load_kernels()
    b, hkv, g, d = q.shape
    layer_bytes = k_all.stride(0) * k_all.element_size() * layer
    out = torch.empty_like(q)
    rc = lib.fs_flash_decode(
        q.data_ptr(), k_all.data_ptr() + layer_bytes,
        v_all.data_ptr() + layer_bytes, lengths.data_ptr(), out.data_ptr(),
        b, k_all.shape[2], hkv, g, d, DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, "flash_decode")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
