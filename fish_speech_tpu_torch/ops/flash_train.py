"""Training self-attention: causal GQA with a key-valid mask, trainable.

Port of the Pallas TPU kernels `fish_speech_tpu/ops/pallas_attention_train.py`
(`_fwd_kernel`, `_bwd_kernel`, and the `custom_vjp` wrapper
`flash_train_attention`). The kernels are hand-written CUDA for Hopper
(`csrc/flash_train.cu`; its header note says what bounds them and how they
are tiled); they read the model's (B, T, H, D) layout directly, so there
are no transposes.

The forward and the backward each have three routes, picked by `_route` on
the dtype and the head dim, an explicit dispatch, not a fallback: bf16 at
D in {64, 128} goes to "wgmma", the tensor-core kernels
(`train_fwd_wgmma_kernel`, `csrc/attn_wgmma.cuh`;
`train_bwd_dkdv_wgmma_kernel` and `train_bwd_dq_wgmma_kernel`,
`csrc/attn_bwd_wgmma.cuh`), fp32 to "fp32_tc", the fp32 products on the
tensor cores in 3xTF32 (the forward `csrc/flash_fp32.cu:attn_tf32_kernel`
in its training mode, the backward `csrc/flash_train.cu:
train_bwd_tf32_kernel`), which the small fp32 reference models, the parity
tool and the fp32 multi-device trainer use, and bf16 at D = 32 (JAX's tiny
model trained in bf16, the train CLI's default) to "bf16_tf32", the same
kernels on bf16 inputs, exact in TF32, with fp32 P and dS and one rounding
of O, dQ, dK and dV (so they sit closer to the fp32 function than the
plain version's bf16 P and dS). `HEAD_DIMS` lists the widths each route
takes; any other raises before a launch. The TF32 backward splits each
64-key tile's walk over the query rows into slices (`train_bwd_plan`, from
the shape and the SM count alone; `dkdv_slices` lists them) whose partial
dK and dV the tile's last slice sums in slice order.

`flash_train_attention` is a `torch.autograd.Function`: its forward runs
`flash_train_forward` and saves q, k, v, O and the fp32 row logsumexp; its
backward runs `flash_train_backward`. Each of those two wrappers runs its
plain PyTorch version for CPU tensors only; for a CUDA tensor it launches
the kernel or raises, and counts its launches in `.launches` and per route
in `.launches_<route>` (`reset_launches` zeroes them all).

Gradient contract (as the TPU kernel's): masked pairs get probability 0, so
their score gradient vanishes; a query row with no visible key (left
padding only) has a finite output and must receive a zero cotangent.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (BF16_FP32, DTYPE_CODES,
                                                check_aligned, check_launch,
                                                load_kernels, scratch, sm_count)
from fish_speech_tpu_torch.ops.attention import NEG_INF


def _scores(q, k, kvalid):
    """Masked fp32 scores (B, Hkv, G, T, T) of q (B,T,H,D), k (B,T,Hkv,D)."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / math.sqrt(d)
    i = torch.arange(t, device=q.device)
    mask = (i[None, :] <= i[:, None])[None] & (kvalid.to(q.device) != 0)[:, None, :]
    return s.masked_fill(~mask[:, None, None], NEG_INF)


def flash_train_forward_reference(q, k, v, kvalid):
    """(O (B,T,H,D) in q's dtype, lse (B,H,T) fp32) with `_fwd_kernel`'s
    numerics: fp32 scores and softmax, normalised weights cast to v's dtype
    before an fp32-accumulated P.V."""
    b, t, h, d = q.shape
    s = _scores(q, k, kvalid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / l).to(v.dtype).float()
    o = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(b, h, t)
    return o.reshape(b, t, h, d).contiguous().to(q.dtype), lse


def flash_train_backward_reference(q, k, v, kvalid, o, lse, do):
    """(dQ, dK, dV) from the saved lse, with `_bwd_kernel`'s formulas: P =
    exp(S - lse), dV = P^T dO, dS = P * (dO V^T - delta) * scale, dQ = dS K,
    dK = dS^T Q, where delta = rowsum(dO * O) in fp32; P is cast to v's dtype
    and dS to q's before their products, dK/dV sum over the G heads of a
    group in fp32 and are cast to k's dtype."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, kvalid)
    p = torch.exp(s - lse.reshape(b, hkv, g, t)[..., None])
    dog = do.reshape(b, t, hkv, g, d).float()
    delta = (do.float() * o.float()).sum(-1).reshape(b, t, hkv, g)
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(v.dtype).float(), dog)
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float())
    dk = torch.einsum("bkgts,btkgd->bskd", ds,
                      q.reshape(b, t, hkv, g, d).float())
    return dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# fs_flash_train_fwd and fs_flash_train_bwd pick one by the dtype and D
ROUTES = ("fp32_tc", "wgmma", "bf16_tf32")
# head widths each route takes: the wgmma kernels' 64-column swizzled
# blocks take 64 and 128; the TF32 kernels also the tiny model's 32, in
# fp32 and in bf16
HEAD_DIMS = {"fp32_tc": (32, 64, 128), "wgmma": (64, 128), "bf16_tf32": (32,)}


def _route(dtype: torch.dtype, d: int) -> str:
    """Which kernels `flash_train_forward` and `flash_train_backward` launch
    for q/k/v of `dtype` and head dim `d`."""
    if dtype == torch.bfloat16:
        return "bf16_tf32" if d in HEAD_DIMS["bf16_tf32"] else "wgmma"
    if dtype == torch.float32:
        return "fp32_tc"
    raise TypeError(f"flash_train: bf16 or fp32 q/k/v, got {dtype}")


# the TF32 backward (`csrc/flash_train.cu:train_bwd_tf32_kernel`): a dK/dV
# block owns BWD_KEYS keys of a KV head and walks the packed query rows
# (row m of (b, kv) is position m // G of head kv * G + m % G) that can see
# them, bwd_step(D) rows a step; a dQ block owns BWD_KEYS packed rows and
# walks the keys up to their causal limit, bwd_step(D) keys a step. The
# plan aims at BWD_BLOCKS_PER_SM blocks' worth of steps an SM.
BWD_KEYS = 64
BWD_BLOCKS_PER_SM = 2


def bwd_step(d: int) -> int:
    """Packed query rows a dK/dV step takes, keys a dQ step takes: 64, 32,
    16 at D = 32, 64, 128 (two blocks an SM in shared memory and registers)."""
    return 2048 // d


def dkdv_walk(t: int, n_group: int, d: int):
    """[lo, hi) row tiles (of `bwd_step(d)` packed rows) that each 64-key
    tile walks: from the tile holding packed row k0 * G (position k0, the
    first that sees a key of the tile) to the last."""
    step = bwd_step(d)
    n_rt = -(-t * n_group // step)
    return [(k0 * n_group // step, n_rt) for k0 in range(0, t, BWD_KEYS)]


def dq_walk(t: int, n_group: int, d: int):
    """Key steps (of `bwd_step(d)` keys) each dQ block walks: up to the
    causal limit of its last packed row."""
    step, rows = bwd_step(d), t * n_group
    return [((min(m0 + BWD_KEYS, rows) - 1) // n_group) // step + 1
            for m0 in range(0, rows, BWD_KEYS)]


def train_bwd_plan(b: int, t: int, h: int, hkv: int, d: int, n_sm: int):
    """(Z, row tiles per slice) of the dK/dV walks, from the shape and the
    SM count alone (never kvalid): slices as long as the steps of both
    kinds of block over BWD_BLOCKS_PER_SM blocks an SM, and no shorter than
    the longest dQ walk (the launch ends with its longest block); Z is the
    slices of the longest walk (key tile 0's), so every row tile of every
    walk lies in one slice."""
    g = h // hkv
    walks = [hi - lo for lo, hi in dkdv_walk(t, g, d)]
    dq = dq_walk(t, g, d)
    steps = (sum(walks) + sum(dq)) * hkv * b
    per = max(1, max(dq), -(-steps // (BWD_BLOCKS_PER_SM * n_sm)))
    per = min(per, walks[0])
    return -(-walks[0] // per), per


def dkdv_slices(t: int, n_group: int, d: int, kt: int, per: int):
    """The row-tile ranges [lo, hi) of key tile kt's active slices, in slice
    order (the order their partials are summed in); slices past them do
    nothing."""
    lo, hi = dkdv_walk(t, n_group, d)[kt]
    return [(r, min(r + per, hi)) for r in range(lo, hi, per)]


def _check(q, k, v, kvalid, name="flash_train"):
    """What the kernels take; the device is checked last, so that the CPU
    tests can hold the rest of the contract."""
    if q.dtype not in BF16_FP32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if kvalid.dtype != torch.int32:
        raise TypeError(f"{name}: kvalid must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,T,H,D), k/v (B,T,Hkv,D)")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{name}: H must be a multiple of Hkv")
    dims = HEAD_DIMS[_route(q.dtype, d)]
    if d not in dims:
        raise ValueError(f"{name}: head dim {d} is taken by no route of "
                         f"{q.dtype} (the routes' widths: {HEAD_DIMS})")
    if tuple(kvalid.shape) != (b, t):
        raise ValueError(f"{name}: kvalid must be (B, T)")
    for n, x in (("q", q), ("k", k), ("v", v), ("kvalid", kvalid)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and kvalid.device == q.device):
        raise ValueError(f"{name}: q, k, v and kvalid must lie on one CUDA device")


def _check_backward(q, k, v, kvalid, o, lse, do):
    """`_check`, and what the backward takes of the saved O and lse and of
    dO; the devices are checked last."""
    name = "flash_train_backward"
    for n, x, dtype in (("o", o, q.dtype), ("do", do, q.dtype),
                        ("lse", lse, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {dtype} tensor")
    if q.dim() == 4 and (o.shape != q.shape or do.shape != q.shape or tuple(
            lse.shape) != (q.shape[0], q.shape[2], q.shape[1])):
        raise ValueError(f"{name}: o/do (B,T,H,D), lse (B,H,T)")
    _check(q, k, v, kvalid, name)
    if any(x.device != q.device for x in (o, lse, do)):
        raise ValueError(f"{name}: o, lse and do must lie on {q.device}")


def flash_train_forward(q, k, v, kvalid):
    """Same contract as `flash_train_forward_reference`; on CUDA tensors runs
    the forward kernel of `_route(q.dtype, D)` (D in its `HEAD_DIMS`, any
    T). kvalid is (B, T) int32, nonzero where the key is real."""
    if q.device.type == "cpu":
        return flash_train_forward_reference(q, k, v, kvalid)
    _check(q, k, v, kvalid, "flash_train_forward")
    route = _route(q.dtype, q.shape[-1])
    check_aligned("flash_train_forward", q=q, k=k, v=v)
    lib = load_kernels()
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = lib.fs_flash_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, t, h, k.shape[2], d,
        DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, f"flash_train_fwd ({route})")
    _count(flash_train_forward, route)
    return out, lse


def flash_train_backward(q, k, v, kvalid, o, lse, do):
    """Same contract as `flash_train_backward_reference`; on CUDA tensors
    runs the dK/dV and dQ kernels of `_route(q.dtype, D)` (one launch of
    the pair counts once; the TF32 routes' pair is one kernel, split by
    `train_bwd_plan`, its partials in `scratch("flash_train_bwd")`)."""
    if q.device.type == "cpu":
        return flash_train_backward_reference(q, k, v, kvalid, o, lse, do)
    _check_backward(q, k, v, kvalid, o, lse, do)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    route = _route(q.dtype, d)
    check_aligned("flash_train_backward", q=q, k=k, v=v, do=do)
    lib = load_kernels()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_split, per, work, counters = 1, 1, 0, 0  # the wgmma route reads none
    if route != "wgmma":
        n_split, per = train_bwd_plan(b, t, h, hkv, d, sm_count(q.device))
        if n_split > 1:
            tiles = -(-t // BWD_KEYS) * hkv * b
            w, c = scratch("flash_train_bwd", q.device,
                           tiles * n_split * 2 * BWD_KEYS * d, tiles)
            work, counters = w.data_ptr(), c.data_ptr()
    rc = lib.fs_flash_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvalid.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), work, counters, n_split, per, b, t, h,
        hkv, d, DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(rc, f"flash_train_bwd ({route})")
    _count(flash_train_backward, route)
    return dq, dk, dv


def _count(wrapper, route):
    """One launch of `wrapper` on `route`: its total and its route's count."""
    wrapper.launches += 1
    count = f"launches_{route}"
    setattr(wrapper, count, getattr(wrapper, count) + 1)


def reset_launches():
    """Set the launch counts of the forward and of the backward (all routes
    and each route) to 0."""
    for wrapper in (flash_train_forward, flash_train_backward):
        wrapper.launches = 0
        for route in ROUTES:
            setattr(wrapper, f"launches_{route}", 0)


reset_launches()


class FlashTrainAttention(torch.autograd.Function):
    """Autograd wrapper of the forward and backward above."""

    @staticmethod
    def forward(ctx, q, k, v, kvalid):
        o, lse = flash_train_forward(q, k, v, kvalid)
        ctx.save_for_backward(q, k, v, kvalid, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kvalid, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_backward(q, k, v, kvalid, o, lse,
                                          do.to(q.dtype).contiguous())
        return dq, dk, dv, None


def flash_train_attention(q, k, v, kvalid):
    """Causal GQA self-attention with a key-valid mask, trainable.

    q (B, T, H, D); k, v (B, T, Hkv, D) with H % Hkv == 0; kvalid (B, T)
    bool or int, nonzero where the KEY position is real (`~pad_mask`).
    Returns (B, T, H, D) in q's dtype."""
    return FlashTrainAttention.apply(q, k, v, kvalid.to(torch.int32).contiguous())
