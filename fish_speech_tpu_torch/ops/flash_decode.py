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

The kernel splits each row's positions over Z blocks and merges their
softmax states in the same launch. `decode_split_count` (Z, from S and the
SM count) and `decode_slice` (a block's positions, from the row's length)
state its slice arithmetic; `decode_partial_reference` and
`merge_decode_states` replay the split in plain PyTorch.

`flash_decode_attention_kv8` is the same attention over the int8 KV cache
(int8 K/V, bf16 per-(position, head) scales): the JAX package computed it
with the einsum `gqa_attention_kv8` (no Pallas kernel); here it is a
hand-written kernel in the same source, and `flash_decode_kv8_reference`
(that einsum's semantics under `lengths`) is its plain version.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels,
                                                 scratch, sm_count, stream_ptr)
from fish_speech_tpu_torch.ops.attention import NEG_INF, gqa_attention_kv8

MAX_GROUP = 8  # query heads per KV head one kernel block serves
KV8_CHUNK = 128  # cache positions per block of the int8-KV kernel
SLICE_ALIGN = 16  # a slice's length is a multiple of this (csrc: SLICE_ALIGN)
MAX_SPLIT = 64  # most blocks over one (batch row, KV head) (csrc: MAX_SPLIT)
BLOCKS_PER_SM = 1  # blocks the split aims for at batch 1
PARTIAL_HEAD = 2 * MAX_GROUP  # floats ahead of a slice's accumulator (csrc: ML)


def decode_split_count(s_len: int, n_kv: int, batch: int, n_sm: int) -> int:
    """Z, the blocks over each (batch row, KV head): about BLOCKS_PER_SM per
    SM over the grid, at most one per SLICE_ALIGN positions of S and at
    most MAX_SPLIT. It never reads `lengths`, so every step launches alike."""
    want = -(-BLOCKS_PER_SM * n_sm // (n_kv * batch))
    return max(1, min(want, -(-s_len // SLICE_ALIGN), MAX_SPLIT))


def decode_slice(z: int, n_split: int, length: int, s_len: int):
    """[start, end) of the positions block z of n_split reads in a row of
    `length`: chunks of ceil(S / Z) rounded up to SLICE_ALIGN (a chunk cut
    from the row's length measured slower at len 4000 and no faster at
    2048). Blocks past the length get an empty slice and do nothing."""
    per_block = -(-s_len // n_split)
    chunk = max(SLICE_ALIGN, -(-per_block // SLICE_ALIGN) * SLICE_ALIGN)
    start = min(z * chunk, length)
    return start, min(start + chunk, length)


def decode_partial_reference(q, k_all, v_all, layer: int, starts, ends):
    """The softmax state (m, l, acc) of each row over positions
    [starts[b], ends[b]) of layer `layer`, in fp32: m (B, Hkv, G) the
    largest score, l the sum of exp(score - m), acc (B, Hkv, G, D) the
    exp-weighted sum of V rows; an empty range gives (-inf, 0, 0)."""
    d = q.shape[-1]
    k = k_all[layer].float()
    v = v_all[layer].float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(d)
    j = torch.arange(k.shape[1], device=q.device)
    inside = ((j[None, :] >= torch.as_tensor(starts, device=q.device)[:, None])
              & (j[None, :] < torch.as_tensor(ends, device=q.device)[:, None]))
    s = s.masked_fill(~inside[:, None, None, :], -math.inf)
    m = s.amax(dim=-1)
    p = torch.exp(s - m.clamp_min(NEG_INF)[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", p, v)


def merge_decode_states(states, dtype):
    """Merge a row's per-slice states (m, l, acc) in split order, as the
    kernel's last block does; a row with no position gives 0."""
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    tot = torch.zeros_like(mx)
    out = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - mx.clamp_min(NEG_INF))
        tot = tot + l * f
        out = out + acc * f[..., None]
    return (out / tot.clamp_min(1e-38)[..., None]).to(dtype)


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
    check_aligned("flash_decode_attention", q=q, k_all=k_all, v_all=v_all)


_PLANS: dict = {}


def _plan(q, k_all, v_all, layer, lengths):
    """What a call of these shapes, dtypes and devices passes the kernel
    beyond its pointers: (Z, workspace, counters, layers, bytes per layer,
    dtype code, scale). The first call of a key runs every check of
    `_check` and keeps the plan; a later one repeats only the checks that
    the key does not fix (the layer, contiguity, alignment)."""
    key = (q.shape, k_all.shape, v_all.shape, lengths.shape, q.dtype,
           k_all.dtype, v_all.dtype, lengths.dtype, q.get_device(),
           k_all.get_device(), v_all.get_device(), lengths.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        _check(q, k_all, v_all, layer, lengths)
        b, hkv, g, d = q.shape
        z = decode_split_count(k_all.shape[2], hkv, b, sm_count(q.device))
        # per slice: the max and the sum of each head (PARTIAL_HEAD floats),
        # then the G x D accumulator
        work, counters = scratch("flash_decode", q.device,
                                 b * hkv * z * (PARTIAL_HEAD + g * d), b * hkv)
        plan = _PLANS[key] = (z, work.data_ptr(), counters.data_ptr(),
                              k_all.shape[0], k_all[0].numel() * k_all.element_size(),
                              DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d))
        return plan
    if not 0 <= layer < plan[3]:
        raise ValueError(f"flash_decode_attention: layer {layer} out of range")
    if not (q.is_contiguous() and k_all.is_contiguous() and v_all.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("flash_decode_attention: q, k_all, v_all and lengths "
                         "must be contiguous")
    if (q.data_ptr() | k_all.data_ptr() | v_all.data_ptr()) % 16:
        check_aligned("flash_decode_attention", q=q, k_all=k_all, v_all=v_all)
    return plan


def flash_decode_attention(q, k_all, v_all, layer: int, lengths):
    """Same contract as `flash_decode_reference`; on CUDA tensors runs the
    hand-written kernel, which reads only the first lengths[b] positions,
    split over `decode_split_count` blocks per row, in one launch."""
    if not q.is_cuda and q.device.type == "cpu":
        return flash_decode_reference(q, k_all, v_all, layer, lengths)
    z, work, counters, _, layer_bytes, code, scale = _plan(
        q, k_all, v_all, layer, lengths)
    b, hkv, g, d = q.shape
    out = torch.empty_like(q)
    rc = load_kernels().fs_flash_decode(
        q.data_ptr(), k_all.data_ptr() + layer_bytes * layer,
        v_all.data_ptr() + layer_bytes * layer, lengths.data_ptr(),
        out.data_ptr(), work, counters, b, k_all.shape[2], hkv, g, d, code, z,
        scale, stream_ptr(q))
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
