"""Prefill attention: causal GQA with a per-row key start offset, and its
suffix form over the KV cache.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_attention.py`
(`flash_prefill_attention`). The kernels are hand-written CUDA for Hopper
(`csrc/flash_prefill.cu`; its header note says what bounds them and how
they are tiled), picked by `_route` on the dtype, an explicit dispatch, not
a fallback: bf16 goes to "wgmma", the tensor-core kernel
(`prefill_wgmma_kernel`, `csrc/attn_wgmma.cuh`), fp32 to "cuda_cores", the
float32 kernel on the CUDA cores (`prefill_kernel`), which the small fp32
reference models use. `flash_prefill_reference` is their plain PyTorch
version: the wrapper runs it for CPU tensors only; for a CUDA tensor it
launches the route's kernel or raises, and counts the launches in
`.launches` and `.launches_<route>` (`reset_launches` zeroes them).

`flash_suffix_attention` is the same kernels extended to a prefix-cache
hit's suffix prefill (`models/dual_ar.py:prefill_suffix`, JAX's
`_run_stack_decode` under an absolute causal mask with `gqa_attention`, or
`gqa_attention_kv8` under the int8 cache): the Ts queries of row b sit at
positions start .. start + Ts - 1 and read keys [0, start + Ts) of one layer
of the stacked cache (row stride S), key j visible to query i iff j <=
start + i, with `start` read from device memory so that one CUDA graph
serves every start. Under the int8 cache the K/V tiles go from int8 to the
kernel's dtype exactly, `ks` scales the columns of Q K^T and `vs` those of P
before P V (the folding of `ops/attention.py:gqa_attention_kv8`). Its
routes are counted as "suffix_wgmma", "suffix_kv8_wgmma" (bf16 q) and
"suffix_cuda_cores", "suffix_kv8_cuda_cores" (fp32 q); the plain version is
`flash_suffix_reference`.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels)
from fish_speech_tpu_torch.ops.attention import gqa_attention, gqa_attention_kv8


def flash_prefill_reference(q, k, v, offsets):
    """q (B, T, H, D), k/v (B, T, Hkv, D), offsets (B,) int -> (B, T, H, D).

    Key j is visible to query i iff j <= i and j >= offsets[b]; fp32 scores
    and softmax, weights cast to v's dtype before P.V (the TPU kernel's
    numerics)."""
    t = q.shape[1]
    i = torch.arange(t, device=q.device)
    mask = (i[None, :] <= i[:, None])[None] & (
        i[None, None, :] >= offsets.to(q.device).long()[:, None, None]
    )
    return gqa_attention(q, k, v, mask)


ROUTES = ("cuda_cores", "wgmma")  # fs_flash_prefill picks one by the dtype


def _route(dtype: torch.dtype) -> str:
    """Which kernel `flash_prefill_attention` launches for `dtype`."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"flash_prefill_attention: bf16 or fp32 q/k/v, got {dtype}")


def _check(q, k, v, offsets):
    """What the kernels take; the device is checked last, so that the CPU
    tests can hold the rest of the contract."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill_attention: bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError("flash_prefill_attention: offsets must be int32")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_prefill_attention: q (B,T,H,D), k/v (B,T,Hkv,D)")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"flash_prefill_attention: k/v {tuple(k.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError("flash_prefill_attention: H must be a multiple of Hkv")
    if d not in (64, 128):
        raise ValueError(f"flash_prefill_attention: head dim {d} not in (64, 128)")
    if tuple(offsets.shape) != (b,):
        raise ValueError("flash_prefill_attention: offsets must be (B,)")
    for name, x in (("q", q), ("k", k), ("v", v), ("offsets", offsets)):
        if not x.is_contiguous():
            raise ValueError(f"flash_prefill_attention: {name} must be contiguous")
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and offsets.device == q.device):
        raise ValueError("flash_prefill_attention: q, k, v and offsets must "
                         "lie on one CUDA device")


def flash_prefill_attention(q, k, v, offsets):
    """Same contract as `flash_prefill_reference`; on CUDA tensors runs the
    kernel of `_route(q.dtype)` (D in {64, 128}, any T)."""
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, offsets)
    _check(q, k, v, offsets)
    route = _route(q.dtype)
    if route == "wgmma":
        check_aligned("flash_prefill_attention", q=q, k=k, v=v)
    lib = load_kernels()
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    rc = lib.fs_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), b, t, h, k.shape[2], d, DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, f"flash_prefill ({route})")
    flash_prefill_attention.launches += 1
    count = f"launches_{route}"
    setattr(flash_prefill_attention, count,
            getattr(flash_prefill_attention, count) + 1)
    return out


def flash_suffix_reference(q, cache, layer: int, start):
    """q (B, Ts, H, D); cache: the stacked slow cache, k/v (L, B, S, Hkv, D)
    (int8 with bf16 scales ks/vs (L, B, S, Hkv) under the int8 cache);
    start: a (1,) int tensor -> (B, Ts, H, D). Query i of row b sits at
    start + i and sees key j of the layer's row b iff j <= start + i: JAX's
    `gqa_attention` (or `gqa_attention_kv8`) over the cache under that
    mask. Nothing is read on the host (the mask spans all S keys; keys
    past start + Ts are masked)."""
    ts, s = q.shape[1], cache["k"].shape[2]
    i = torch.arange(ts, device=q.device)
    j = torch.arange(s, device=q.device)
    start = torch.as_tensor(start, device=q.device).reshape(1).long()
    mask = (j[None, :] <= (start + i)[:, None])[None]
    if "ks" in cache:
        return gqa_attention_kv8(q, cache["k"][layer], cache["ks"][layer],
                                 cache["v"][layer], cache["vs"][layer], mask)
    return gqa_attention(q, cache["k"][layer], cache["v"][layer], mask)


SUFFIX_ROUTES = ("suffix_cuda_cores", "suffix_wgmma", "suffix_kv8_cuda_cores",
                 "suffix_kv8_wgmma")


def _suffix_route(dtype: torch.dtype, kv8: bool) -> str:
    """Which kernel `flash_suffix_attention` launches for q's `dtype` and
    the cache's layout."""
    return "suffix_" + ("kv8_" if kv8 else "") + _route(dtype)


def _check_suffix(q, cache, layer, start):
    """What the suffix kernels take; the device is checked last, so that
    the CPU tests can hold the rest of the contract."""
    kv8 = "ks" in cache
    k, v = cache["k"], cache["v"]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_suffix_attention: bf16 or fp32 q, got {q.dtype}")
    want = torch.int8 if kv8 else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"flash_suffix_attention: a {want} cache for {q.dtype} "
                        f"q, got {k.dtype}/{v.dtype}")
    if kv8 and (cache["ks"].dtype != torch.bfloat16
                or cache["vs"].dtype != torch.bfloat16):
        raise TypeError("flash_suffix_attention: bf16 ks/vs scales")
    if start.dtype != torch.int32 or tuple(start.shape) != (1,):
        raise TypeError("flash_suffix_attention: start must be a (1,) int32 tensor")
    if q.dim() != 4 or k.dim() != 5 or k.shape != v.shape:
        raise ValueError("flash_suffix_attention: q (B,Ts,H,D), cache k/v "
                         "(L,B,S,Hkv,D)")
    b, ts, h, d = q.shape
    n_layer, kb, s, hkv, kd = k.shape
    if kb != b or kd != d or ts > s:
        raise ValueError(f"flash_suffix_attention: cache {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"flash_suffix_attention: layer {layer} outside 0.."
                         f"{n_layer - 1}")
    if h % hkv:
        raise ValueError("flash_suffix_attention: H must be a multiple of Hkv")
    if d not in (64, 128):
        raise ValueError(f"flash_suffix_attention: head dim {d} not in (64, 128)")
    if kv8 and tuple(cache["ks"].shape) != tuple(k.shape[:4]):
        raise ValueError("flash_suffix_attention: ks/vs must be (L,B,S,Hkv)")
    tensors = dict(q=q, start=start, **cache)
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"flash_suffix_attention: {name} must be contiguous")
    if not (q.is_cuda and all(x.device == q.device for x in tensors.values())):
        raise ValueError("flash_suffix_attention: q, the cache and start must "
                         "lie on one CUDA device")


def flash_suffix_attention(q, cache, layer: int, start):
    """Same contract as `flash_suffix_reference`; on CUDA tensors runs the
    kernel of `_suffix_route` (D in {64, 128}; the caller keeps start + Ts
    <= S). It reads keys [0, start + Ts) of the layer only."""
    if q.device.type == "cpu":
        return flash_suffix_reference(q, cache, layer, start)
    _check_suffix(q, cache, layer, start)
    kv8 = "ks" in cache
    route = _suffix_route(q.dtype, kv8)
    k, v = cache["k"], cache["v"]
    if route.endswith("wgmma"):
        check_aligned("flash_suffix_attention", q=q, k=k, v=v)
    lib = load_kernels()
    b, ts, h, d = q.shape
    s, hkv = k.shape[2], k.shape[3]
    kv_layer = b * s * hkv * d * k.element_size()
    sc_layer = b * s * hkv * 2
    ks = cache["ks"].data_ptr() + layer * sc_layer if kv8 else 0
    vs = cache["vs"].data_ptr() + layer * sc_layer if kv8 else 0
    out = torch.empty_like(q)
    rc = lib.fs_flash_suffix(
        q.data_ptr(), k.data_ptr() + layer * kv_layer,
        v.data_ptr() + layer * kv_layer, ks, vs, start.data_ptr(),
        out.data_ptr(), b, ts, h, hkv, d, s, DTYPE_CODES[q.dtype], int(kv8),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, f"flash_suffix ({route})")
    flash_suffix_attention.launches += 1
    count = f"launches_{route}"
    setattr(flash_suffix_attention, count,
            getattr(flash_suffix_attention, count) + 1)
    return out


def reset_launches():
    """Set the launch counts of `flash_prefill_attention` and
    `flash_suffix_attention` (all routes and each route) to 0."""
    for f, routes in ((flash_prefill_attention, ROUTES),
                      (flash_suffix_attention, SUFFIX_ROUTES)):
        f.launches = 0
        for route in routes:
            setattr(f, f"launches_{route}", 0)


reset_launches()
