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

`flash_decode_attention_kv8` is the same attention over the int8 KV cache
(int8 K/V, bf16 per-(position, head) scales): the JAX package computed it
with the einsum `gqa_attention_kv8` (no Pallas kernel); here it is a
hand-written kernel in the same source, and `flash_decode_kv8_reference`
(that einsum's semantics under `lengths`) is its plain version.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                 load_kernels)
from fish_speech_tpu_torch.ops.attention import NEG_INF, gqa_attention_kv8

MAX_GROUP = 8  # query heads per KV head one kernel block serves
KV8_CHUNK = 128  # cache positions per block of the int8-KV kernel


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


def flash_decode_kv8_reference(q, k_all, ks_all, v_all, vs_all, layer: int,
                               lengths):
    """q (B, Hkv, G, D); k_all/v_all (L, B, S, Hkv, D) int8; ks_all/vs_all
    (L, B, S, Hkv) scales; lengths (B,) in [1, S]. Returns (B, Hkv, G, D):
    `gqa_attention_kv8` of the one query position over the first
    lengths[b] positions of layer `layer`."""
    b, hkv, g, d = q.shape
    s = k_all.shape[2]
    j = torch.arange(s, device=q.device)
    mask = (j[None, :] < lengths.to(q.device)[:, None])[:, None, :]  # (B,1,S)
    y = gqa_attention_kv8(q.reshape(b, 1, hkv * g, d), k_all[layer],
                          ks_all[layer], v_all[layer], vs_all[layer], mask)
    return y.reshape(b, hkv, g, d)


def _check_kv8(q, k_all, ks_all, v_all, vs_all, layer, lengths):
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_all, ks_all, v_all, vs_all, lengths)):
        raise ValueError("flash_decode_attention_kv8: every tensor must lie on "
                         "one CUDA device")
    if (q.dtype not in DTYPE_CODES or k_all.dtype != torch.int8
            or v_all.dtype != torch.int8 or ks_all.dtype != torch.bfloat16
            or vs_all.dtype != torch.bfloat16):
        raise TypeError("flash_decode_attention_kv8: q bf16/fp32, K/V int8, "
                        "scales bf16")
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode_attention_kv8: lengths must be int32")
    if (q.dim() != 4 or k_all.dim() != 5 or k_all.shape != v_all.shape
            or ks_all.shape != k_all.shape[:-1] or vs_all.shape != ks_all.shape):
        raise ValueError("flash_decode_attention_kv8: q (B,Hkv,G,D), K/V "
                         "(L,B,S,Hkv,D), scales (L,B,S,Hkv)")
    b, hkv, g, d = q.shape
    n_layer, kb, _, khkv, kd = k_all.shape
    if (kb, khkv, kd) != (b, hkv, d):
        raise ValueError(f"flash_decode_attention_kv8: cache "
                         f"{tuple(k_all.shape)} does not match q {tuple(q.shape)}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"flash_decode_attention_kv8: layer {layer} out of range")
    if d not in (64, 128) or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode_attention_kv8: D={d} not in (64, 128) "
                         f"or G={g} not in [1, {MAX_GROUP}]")
    if tuple(lengths.shape) != (b,):
        raise ValueError("flash_decode_attention_kv8: lengths must be (B,)")
    for name, x in (("q", q), ("k_all", k_all), ("ks_all", ks_all),
                    ("v_all", v_all), ("vs_all", vs_all), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode_attention_kv8: {name} must be "
                             f"contiguous")


def flash_decode_attention_kv8(q, k_all, ks_all, v_all, vs_all, layer: int,
                               lengths):
    """Same contract as `flash_decode_kv8_reference`; on CUDA tensors runs
    the hand-written int8-KV kernel, which reads only the first lengths[b]
    positions, in chunks of KV8_CHUNK positions per block."""
    if q.device.type == "cpu":
        return flash_decode_kv8_reference(q, k_all, ks_all, v_all, vs_all,
                                          layer, lengths)
    _check_kv8(q, k_all, ks_all, v_all, vs_all, layer, lengths)
    lib = load_kernels()
    b, hkv, g, d = q.shape
    s = k_all.shape[2]
    n_split = -(-s // KV8_CHUNK)
    kv_off = k_all.stride(0) * layer  # int8: bytes
    sc_off = ks_all.stride(0) * ks_all.element_size() * layer
    part = torch.empty((b, hkv, n_split, g, d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    rc = lib.fs_flash_decode_kv8(
        q.data_ptr(), k_all.data_ptr() + kv_off, ks_all.data_ptr() + sc_off,
        v_all.data_ptr() + kv_off, vs_all.data_ptr() + sc_off,
        lengths.data_ptr(), part.data_ptr(), out.data_ptr(), b, s, hkv, g, d,
        DTYPE_CODES[q.dtype], KV8_CHUNK, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, "flash_decode_kv8")
    flash_decode_attention_kv8.launches += 1
    return out


flash_decode_attention_kv8.launches = 0
