"""Prefill attention: causal GQA with a per-row key start offset, and the
prefix-cache suffix's attention over the KV cache.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_attention.py`
(`flash_prefill_attention`). The kernels are hand-written CUDA for Hopper
(`csrc/flash_prefill.cu`; its header note says what bounds them and how
they are tiled), picked by `_route` on the dtype, an explicit dispatch, not
a fallback: bf16 goes to "wgmma", the tensor-core kernel
(`prefill_wgmma_kernel`, `csrc/attn_wgmma.cuh`), fp16 (`--half` serving) to
"wgmma_f16", the same kernel on fp16 operands (P rounded to fp16), fp32 to
"cuda_cores", the float32 kernel on the CUDA cores (`prefill_kernel`),
which the small fp32 reference models use. `flash_prefill_reference` is
their plain PyTorch version: the wrapper runs it for CPU tensors only; for
a CUDA tensor it launches the route's kernel or raises, and counts the
launches in `.launches` and `.launches_<route>` (`reset_launches` zeroes
them).

`flash_suffix_attention` serves a prefix-cache hit's suffix prefill
(`models/dual_ar.py:prefill_suffix`, JAX's `_run_stack_decode` under an
absolute causal mask with `gqa_attention`, or
`gqa_attention_kv8` under the int8 cache): the Ts queries of row b sit at
positions start .. start + Ts - 1 and read keys [0, start + Ts) of one layer
of the stacked cache (row stride S), key j visible to query i iff j <=
start + i, with `start` read from device memory so that one CUDA graph
serves every start. Under the int8 cache the K/V tiles go from int8 to the
kernel's dtype exactly, `ks` scales the columns of Q K^T and `vs` those of P
before P V (the folding of `ops/attention.py:gqa_attention_kv8`). Its
routes are counted as "suffix_wgmma", "suffix_kv8_wgmma" (bf16 q),
"suffix_wgmma_f16", "suffix_kv8_wgmma_f16" (fp16 q; the int8 cache's
scales stay bf16) and "suffix_cuda_cores", "suffix_kv8_cuda_cores" (fp32
q); the plain version is `flash_suffix_reference`.

The tensor-core suffix kernel (`csrc/flash_prefill.cu:suffix_wgmma_kernel`)
is a decode over Ts * G query rows: a block takes 64 or 128 packed rows
(the G heads of a KV head at a run of positions, `suffix_row_tiles`) and
one slice of the keys; `suffix_plan` picks the rows a block and the
slices from the shape alone, and the last block of a row tile merges the
slices' softmax states in the launch. `suffix_states_reference` and
`merge_suffix_states` replay that packing, split and merge step by step
in plain PyTorch (the tests hold the replay to `flash_suffix_reference`
and to JAX).
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels,
                                                 scratch, sm_count)
from fish_speech_tpu_torch.ops.attention import (NEG_INF, gqa_attention,
                                                 gqa_attention_kv8)


def flash_prefill_reference(q, k, v, offsets):
    """q (B, T, H, D), k/v (B, T, Hkv, D), offsets (B,) int -> (B, T, H, D).

    Key j is visible to query i iff j <= i and j >= offsets[b]; fp32 scores
    and softmax, weights cast to v's dtype before P.V (the TPU kernel's
    numerics; the tensor-core kernels round the unnormalised weights to
    bf16 or fp16 instead and divide by their fp32 sum at the end: one
    rounding on each weight either way)."""
    t = q.shape[1]
    i = torch.arange(t, device=q.device)
    mask = (i[None, :] <= i[:, None])[None] & (
        i[None, None, :] >= offsets.to(q.device).long()[:, None, None]
    )
    return gqa_attention(q, k, v, mask)


# fs_flash_prefill picks one by the dtype: fp32, bf16, fp16
ROUTES = ("cuda_cores", "wgmma", "wgmma_f16")
_DTYPE_ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma",
                 torch.float16: "wgmma_f16"}


# head widths each route takes: the tensor-core kernels 64 and 128, the
# fp32 CUDA-core kernel also the tiny model's 32 (its slow stack; the fast
# stack never prefills)
HEAD_DIMS = {"cuda_cores": (32, 64, 128), "wgmma": (64, 128), "wgmma_f16": (64, 128)}


def _route(dtype: torch.dtype) -> str:
    """Which kernel `flash_prefill_attention` launches for `dtype`."""
    if dtype not in _DTYPE_ROUTES:
        raise TypeError(f"flash_prefill_attention: bf16, fp16 or fp32 q/k/v, "
                        f"got {dtype}")
    return _DTYPE_ROUTES[dtype]


def _check(q, k, v, offsets):
    """What the kernels take; the device is checked last, so that the CPU
    tests can hold the rest of the contract."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill_attention: bf16, fp16 or fp32 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
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
    dims = HEAD_DIMS[_route(q.dtype)]
    if d not in dims:
        raise ValueError(f"flash_prefill_attention: head dim {d} not in {dims} "
                         f"for {q.dtype}")
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
    kernel of `_route(q.dtype)` (D in its `HEAD_DIMS`, any T)."""
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, offsets)
    _check(q, k, v, offsets)
    route = _route(q.dtype)
    if route != "cuda_cores":
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
                 "suffix_kv8_wgmma", "suffix_wgmma_f16", "suffix_kv8_wgmma_f16")
SUFFIX_ROWS = 64  # packed query rows of a warpgroup (csrc: sfx::BQ)
SUFFIX_KEYS = 64  # keys of a tile (csrc: sfx::BK)
SUFFIX_MAX_SPLIT = 16  # most slices of the keys (csrc: sfx::MAX_SPLIT)
SUFFIX_BLOCKS_PER_SM = 2  # blocks the split aims for over all S keys


def suffix_row_tiles(ts: int, n_group: int, rows_per_block: int = SUFFIX_ROWS) -> int:
    """Blocks of `rows_per_block` packed rows over one (b, kv): Ts * G rows,
    row m at position m // G of head kv * G + m % G."""
    return -(-ts * n_group // rows_per_block)


def suffix_plan(s_len: int, n_kv: int, batch: int, ts: int, n_group: int,
                n_sm: int):
    """(rows a block, Z, tiles per slice), from the shape alone. 64 rows
    (the warpgroups take the tiles in turn: the keys walked twice as fast)
    while such blocks fit in one wave over the SMs, else 128 (each
    warpgroup its own 64, both on every tile: each K/V tile read for twice
    the rows, where the card's L2 bandwidth bounds the walk). Z slices of
    the S keys, each a run of whole 64-key tiles, as many as leave about
    one block with keys per SM when start + Ts is near S / 2 (about
    SUFFIX_BLOCKS_PER_SM blocks per SM over the grid), at most
    SUFFIX_MAX_SPLIT: a slice with keys costs its block's start-up and its
    partial's merge, so fewer blocks than SMs are better than a second
    wave (`scripts/suffix_bench.py`'s plan sweep). It never reads start,
    so every hit launches alike."""
    pair = 2 * SUFFIX_ROWS
    rows = pair if batch * n_kv * suffix_row_tiles(ts, n_group) > n_sm else SUFFIX_ROWS
    tiles = -(-s_len // SUFFIX_KEYS)
    blocks = batch * n_kv * suffix_row_tiles(ts, n_group, rows)
    want = max(1, min(SUFFIX_BLOCKS_PER_SM * n_sm // blocks, tiles, SUFFIX_MAX_SPLIT))
    per = -(-tiles // want)
    return rows, -(-tiles // per), per


def suffix_slices(start: int, ts: int, n_group: int, rt: int,
                  tiles_per_slice: int, rows_per_block: int = SUFFIX_ROWS):
    """The key ranges [lo, hi) of row tile rt's active slices, in slice
    order: slice z covers [z * chunk, (z + 1) * chunk) of the keys the row
    tile sees, [0, start + i_last + 1); the slices past them do nothing."""
    rows = ts * n_group
    last = min((rt + 1) * rows_per_block, rows) - 1
    lim = start + last // n_group + 1
    chunk = tiles_per_slice * SUFFIX_KEYS
    return [(lo, min(lo + chunk, lim)) for lo in range(0, lim, chunk)]


def _pack_rows(q, n_kv):
    """q (B, Ts, H, D) -> (B, Hkv, Ts * G, D): row m of (b, kv) is
    position m // G of head kv * G + m % G."""
    b, ts, h, d = q.shape
    g = h // n_kv
    return q.reshape(b, ts, n_kv, g, d).permute(0, 2, 1, 3, 4).reshape(b, n_kv, ts * g, d)


def suffix_states_reference(q, cache, layer: int, start: int, tiles_per_slice: int,
                            rows_per_block: int = SUFFIX_ROWS):
    """The kernel's softmax states, step by step: for each row tile rt and
    active slice (`suffix_slices`), an online softmax per 64-key tile, P
    rounded to q's dtype before P V (times vs under the int8 cache; l sums
    the unrounded, unscaled p): with 64 rows a block, the two warpgroups'
    walks (tiles n, n + 2, ... of the slice) joined in order; with 128, one
    walk of every tile (each warpgroup's rows). Returns {rt: [(m, l, o),
    ... per slice]}, m and l (B, Hkv, rows), o (B, Hkv, rows, D), all fp32,
    rows the row tile's packed rows."""
    kv8 = "ks" in cache
    b, ts, h, d = q.shape
    n_kv = cache["k"].shape[3]
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    k = cache["k"][layer].float().permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    v = cache["v"][layer].float().permute(0, 2, 1, 3)
    if kv8:
        ks = cache["ks"][layer].float().permute(0, 2, 1)  # (B, Hkv, S)
        vs = cache["vs"][layer].float().permute(0, 2, 1)
    qp = _pack_rows(q, n_kv).float()
    lim = start + ts
    out = {}
    turns = rows_per_block == SUFFIX_ROWS
    for rt in range(suffix_row_tiles(ts, g, rows_per_block)):
        r0, r1 = rt * rows_per_block, min((rt + 1) * rows_per_block, ts * g)
        qr = qp[:, :, r0:r1]
        vis = start + torch.arange(r0, r1) // g  # the last key of each row
        states = []
        for lo, hi in suffix_slices(start, ts, g, rt, tiles_per_slice, rows_per_block):
            walks = []
            for wg in ((0, 1) if turns else (0,)):
                m = torch.full(qr.shape[:3], -math.inf)
                l = torch.zeros(qr.shape[:3])
                o = torch.zeros(qr.shape)
                step = 2 * SUFFIX_KEYS if turns else SUFFIX_KEYS
                for k0 in range(lo + wg * SUFFIX_KEYS, hi, step):
                    key = torch.arange(k0, k0 + SUFFIX_KEYS)
                    kk = key.clamp_max(k.shape[2] - 1)
                    s = qr @ k[:, :, kk].transpose(-1, -2)
                    s = s * (ks[:, :, kk][:, :, None, :] * scale if kv8 else scale)
                    s = torch.where(key[None, :] <= vis[:, None], s,
                                    torch.tensor(NEG_INF))
                    s = torch.where(key >= lim, torch.tensor(-math.inf), s)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    pv = p * vs[:, :, kk][:, :, None, :] if kv8 else p
                    vv = torch.where((key < lim)[:, None], v[:, :, kk], torch.zeros(()))
                    o = o * alpha[..., None] + pv.to(q.dtype).float() @ vv
                    m = m_new
                walks.append((m, l, o))
            if not turns:
                states.append(walks[0])
                continue
            (m0, l0, o0), (m1, l1, o1) = walks
            mx = torch.maximum(m0, m1)
            f0, f1 = torch.exp(m0 - mx), torch.exp(m1 - mx)
            states.append((mx, l0 * f0 + l1 * f1, o0 * f0[..., None] + o1 * f1[..., None]))
        out[rt] = states
    return out


def merge_suffix_states(states, q, n_kv, rows_per_block: int = SUFFIX_ROWS):
    """Merge each row tile's slice states in slice order, as the kernel's
    last block does (one slice: its own O / l), unpacked to q's (B, Ts, H,
    D) layout in q's dtype."""
    b, ts, h, d = q.shape
    g = h // n_kv
    packed = torch.empty((b, n_kv, ts * g, d))
    for rt, sl in states.items():
        mx = torch.stack([m for m, _, _ in sl]).amax(0)
        tot = torch.zeros_like(mx)
        acc = torch.zeros_like(sl[0][2])
        for m, l, o in sl:
            f = torch.exp(m - mx)
            tot = tot + l * f
            acc = acc + o * f[..., None]
        r0 = rt * rows_per_block
        packed[:, :, r0:r0 + acc.shape[2]] = acc / tot[..., None]
    return packed.reshape(b, n_kv, ts, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, ts, h, d).to(q.dtype)


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
        raise TypeError(f"flash_suffix_attention: bf16, fp16 or fp32 q, got "
                        f"{q.dtype}")
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
    dims = HEAD_DIMS[_route(q.dtype)]
    if d not in dims:
        raise ValueError(f"flash_suffix_attention: head dim {d} not in {dims} "
                         f"for {q.dtype}")
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
    kernel of `_suffix_route` (D in `HEAD_DIMS` of q's dtype; the caller keeps start + Ts
    <= S). It reads keys [0, start + Ts) of the layer only: one launch,
    planned by `suffix_plan` on the tensor-core routes."""
    if q.device.type == "cpu":
        return flash_suffix_reference(q, cache, layer, start)
    _check_suffix(q, cache, layer, start)
    kv8 = "ks" in cache
    route = _suffix_route(q.dtype, kv8)
    k, v = cache["k"], cache["v"]
    if "wgmma" in route:
        check_aligned("flash_suffix_attention", q=q, k=k, v=v)
    lib = load_kernels()
    b, ts, h, d = q.shape
    s, hkv = k.shape[2], k.shape[3]
    kv_layer = b * s * hkv * d * k.element_size()
    sc_layer = b * s * hkv * 2
    ks = cache["ks"].data_ptr() + layer * sc_layer if kv8 else 0
    vs = cache["vs"].data_ptr() + layer * sc_layer if kv8 else 0
    rows, n_split, per = suffix_plan(s, hkv, b, ts, h // hkv, sm_count(q.device))
    work = counters = 0  # NULL: one slice, or the fp32 route
    if n_split > 1 and "wgmma" in route:
        tiles = b * hkv * suffix_row_tiles(ts, h // hkv, rows)
        w, c = scratch("flash_suffix", q.device, n_split * tiles * rows * (2 + d), tiles)
        work, counters = w.data_ptr(), c.data_ptr()
    out = torch.empty_like(q)
    rc = lib.fs_flash_suffix(
        q.data_ptr(), k.data_ptr() + layer * kv_layer,
        v.data_ptr() + layer * kv_layer, ks, vs, start.data_ptr(),
        out.data_ptr(), work, counters, b, ts, h, hkv, d, s,
        DTYPE_CODES[q.dtype], int(kv8), rows, n_split, per, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
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
