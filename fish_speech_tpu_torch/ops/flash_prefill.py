"""Prefill attention: causal GQA with a per-row key start offset.

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
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels)
from fish_speech_tpu_torch.ops.attention import gqa_attention


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


def reset_launches():
    """Set `flash_prefill_attention`'s launch counts (all routes and each
    route) to 0."""
    flash_prefill_attention.launches = 0
    for route in ROUTES:
        setattr(flash_prefill_attention, f"launches_{route}", 0)


reset_launches()
