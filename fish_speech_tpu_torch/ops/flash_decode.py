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

q and the cache are bf16 (`decode_mma_kernel`), fp16 (the same kernel on
fp16 operands, the `--half` serving path) or fp32 (`decode_kernel`). The
16-bit kernels take heads 64 or 128 wide; the fp32 one also the tiny
model's 32 (slow stack) and 16 (fast stack) (`HEAD_DIMS`). The
tensor-core forms carry P as two terms of q's dtype, hi + lo (16
significant bits in bf16, 22 in fp16), so the plain version keeps p in
fp32. Each wrapper counts its launches in `.launches` and its fp16
launches also in `.launches_f16`.

Every entry takes an optional per-row `starts` (B,) int32 beside
`lengths`: row b then attends positions [starts[b], lengths[b]), the JAX
decode's `kv_valid` mask of the lockstep batch, whose prompts are
left-padded to a common end (`GenerationSession.generate_batch`). Without
it a row attends [0, lengths[b]), as before.

The kernel splits each row's positions over Z blocks and merges their
softmax states in the same launch. `decode_split_count` (Z, from S and the
SM count) and `decode_slice` (a block's positions, from the row's length)
state its slice arithmetic; `decode_partial_reference` and
`merge_decode_states` replay the split in plain PyTorch.

`flash_decode_attention_kv8` is the same attention over the int8 KV cache
(int8 K/V, bf16 per-(position, head) scales, bf16 under fp16 q too, as in
the JAX package): the JAX package computed it with the einsum
`gqa_attention_kv8` (no Pallas kernel); here it is a hand-written kernel in
the same source, with the same split and merge, and
`flash_decode_kv8_reference` (that einsum's semantics under `lengths`) is
its plain version. `decode_partial_kv8_reference` replays its slices.
"""

from __future__ import annotations

import math

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels,
                                                 scratch, sm_count, stream_ptr)
from fish_speech_tpu_torch.ops.attention import NEG_INF, gqa_attention_kv8

MAX_GROUP = 8  # query heads per KV head one kernel block serves
SLICE_ALIGN = 16  # a slice's length is a multiple of this (csrc: SLICE_ALIGN)
MAX_SPLIT = 64  # most blocks over one (batch row, KV head) (csrc: MAX_SPLIT)
BLOCKS_PER_SM = 1  # blocks the split aims for at batch 1
PARTIAL_HEAD = 2 * MAX_GROUP  # floats ahead of a slice's accumulator (csrc: ML)
# head widths the kernels take, by q's dtype: the 16-bit (tensor-core)
# kernels 64 and 128, the fp32 (CUDA-core) ones also the tiny model's 32
# (slow stack) and 16 (fast stack); the int8 cache is only ever the slow
# stack's, so its fp32 kernel takes 32 and not 16
_WIDE = (64, 128)
HEAD_DIMS = {torch.bfloat16: _WIDE, torch.float16: _WIDE,
             torch.float32: (16, 32) + _WIDE}
KV8_HEAD_DIMS = {torch.bfloat16: _WIDE, torch.float16: _WIDE,
                 torch.float32: (32,) + _WIDE}


def decode_split_count(s_len: int, n_kv: int, batch: int, n_sm: int) -> int:
    """Z, the blocks over each (batch row, KV head): about BLOCKS_PER_SM per
    SM over the grid, at most one per SLICE_ALIGN positions of S and at
    most MAX_SPLIT. It never reads `lengths`, so every step launches alike."""
    want = -(-BLOCKS_PER_SM * n_sm // (n_kv * batch))
    return max(1, min(want, -(-s_len // SLICE_ALIGN), MAX_SPLIT))


def decode_slice(z: int, n_split: int, length: int, s_len: int,
                 row_start: int = 0):
    """[start, end) of the positions block z of n_split reads in a row that
    attends [row_start, length): chunk z of ceil(S / Z) rounded up to
    SLICE_ALIGN (a chunk cut from the row's length measured slower at len
    4000 and no faster at 2048), cut to the row's positions. Blocks past
    the length or wholly before the start get an empty slice and do
    nothing; the kernel merges only the others."""
    per_block = -(-s_len // n_split)
    chunk = max(SLICE_ALIGN, -(-per_block // SLICE_ALIGN) * SLICE_ALIGN)
    start = min(max(z * chunk, row_start), length)
    return start, max(start, min(z * chunk + chunk, length))


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


def _visible(lengths, starts, s_len, device):
    """(B, S) bool: position j visible to row b, starts[b] <= j <
    lengths[b] (from 0 without `starts`)."""
    j = torch.arange(s_len, device=device)
    mask = j[None, :] < lengths.to(device)[:, None]
    if starts is not None:
        mask = mask & (j[None, :] >= starts.to(device)[:, None])
    return mask


def flash_decode_reference(q, k_all, v_all, layer: int, lengths, starts=None):
    """q (B, Hkv, G, D); k_all/v_all (L, B, S, Hkv, D); lengths (B,) = the
    visible prefix per row (pos + 1), in [1, S]; starts (B,) the first
    visible position of each row, below its length (None: 0). Returns (B,
    Hkv, G, D): fp32 scores, softmax and P.V
    (`pallas_decode.flash_decode_reference`, with JAX's `kv_valid` mask)."""
    d = q.shape[-1]
    k = k_all[layer].float()
    v = v_all[layer].float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) / math.sqrt(d)
    mask = _visible(lengths, starts, k.shape[1], q.device)  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w, v).to(q.dtype)


def _check_starts(name, lengths, starts):
    """`starts` as the kernels take it: None, or int32 shaped as `lengths`,
    contiguous (its device is checked with the other tensors')."""
    if starts is None:
        return
    if starts.dtype != torch.int32:
        raise TypeError(f"{name}: starts must be int32")
    if starts.shape != lengths.shape or not starts.is_contiguous():
        raise ValueError(f"{name}: starts must be a contiguous (B,) tensor")


def _check(q, k_all, v_all, layer, lengths, starts):
    """What the kernels take; the device is checked last, so that the CPU
    tests can hold the rest of the contract."""
    _check_starts("flash_decode_attention", lengths, starts)
    if (q.dtype not in DTYPE_CODES or k_all.dtype != q.dtype
            or v_all.dtype != q.dtype):
        raise TypeError(f"flash_decode_attention: bf16, fp16 or fp32 of one "
                        f"dtype, got {q.dtype}/{k_all.dtype}/{v_all.dtype}")
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
    if d not in HEAD_DIMS[q.dtype] or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode_attention: D={d} not in "
                         f"{HEAD_DIMS[q.dtype]} for {q.dtype} or G={g} not in "
                         f"[1, {MAX_GROUP}]")
    if tuple(lengths.shape) != (b,):
        raise ValueError("flash_decode_attention: lengths must be (B,)")
    for name, x in (("q", q), ("k_all", k_all), ("v_all", v_all),
                    ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode_attention: {name} must be contiguous")
    if not (q.is_cuda and k_all.device == q.device and v_all.device == q.device
            and lengths.device == q.device
            and (starts is None or starts.device == q.device)):
        raise ValueError("flash_decode_attention: q, k_all, v_all, lengths and "
                         "starts must lie on one CUDA device")
    check_aligned("flash_decode_attention", q=q, k_all=k_all, v_all=v_all)


_PLANS: dict = {}


def _plan(name, q, caches, lengths, starts, layer, check):
    """What a call of these shapes, dtypes and devices passes a decode
    kernel beyond its pointers: (Z, workspace, counters, layers, bytes per
    layer of each stacked cache tensor, dtype code, scale). The first call
    of a key (with or without `starts`) runs `check` and keeps the plan; a
    later one repeats only the checks that the key does not fix (the layer,
    contiguity, and the alignment of q and the K/V that the TMA reads,
    caches[0] and caches[-2])."""
    tensors = (q, *caches, lengths) + (() if starts is None else (starts,))
    key = (name,) + tuple((t.shape, t.dtype, t.get_device()) for t in tensors)
    plan = _PLANS.get(key)
    if plan is None:
        check()
        b, hkv, g, d = q.shape
        z = decode_split_count(caches[0].shape[2], hkv, b, sm_count(q.device))
        # per slice: the max and the sum of each head (PARTIAL_HEAD floats),
        # then the G x D accumulator
        work, counters = scratch("flash_decode", q.device,
                                 b * hkv * z * (PARTIAL_HEAD + g * d), b * hkv)
        plan = _PLANS[key] = (
            z, work.data_ptr(), counters.data_ptr(), caches[0].shape[0],
            tuple(c[0].numel() * c.element_size() for c in caches),
            DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d))
        return plan
    if not 0 <= layer < plan[3]:
        raise ValueError(f"{name}: layer {layer} out of range")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if (q.data_ptr() | caches[0].data_ptr() | caches[-2].data_ptr()) % 16:
        check_aligned(name, q=q, k_all=caches[0], v_all=caches[-2])
    return plan


def flash_decode_attention(q, k_all, v_all, layer: int, lengths, starts=None):
    """Same contract as `flash_decode_reference`; on CUDA tensors runs the
    hand-written kernel, which reads only positions [starts[b],
    lengths[b]), split over `decode_split_count` blocks per row, in one
    launch."""
    if not q.is_cuda and q.device.type == "cpu":
        return flash_decode_reference(q, k_all, v_all, layer, lengths, starts)
    z, work, counters, _, (layer_bytes, _), code, scale = _plan(
        "flash_decode_attention", q, (k_all, v_all), lengths, starts, layer,
        lambda: _check(q, k_all, v_all, layer, lengths, starts))
    b, hkv, g, d = q.shape
    out = torch.empty_like(q)
    rc = load_kernels().fs_flash_decode(
        q.data_ptr(), k_all.data_ptr() + layer_bytes * layer,
        v_all.data_ptr() + layer_bytes * layer, lengths.data_ptr(),
        None if starts is None else starts.data_ptr(), out.data_ptr(), work, counters, b, k_all.shape[2], hkv, g, d, code, z,
        scale, stream_ptr(q))
    check_launch(rc, "flash_decode")
    flash_decode_attention.launches += 1
    if q.dtype == torch.float16:
        flash_decode_attention.launches_f16 += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_f16 = 0


def flash_decode_kv8_reference(q, k_all, ks_all, v_all, vs_all, layer: int,
                               lengths, starts=None):
    """q (B, Hkv, G, D); k_all/v_all (L, B, S, Hkv, D) int8; ks_all/vs_all
    (L, B, S, Hkv) scales; lengths (B,) in [1, S]; starts as
    `flash_decode_reference`'s. Returns (B, Hkv, G, D): `gqa_attention_kv8`
    of the one query position over positions [starts[b], lengths[b]) of
    layer `layer`."""
    b, hkv, g, d = q.shape
    mask = _visible(lengths, starts, k_all.shape[2], q.device)[:, None, :]
    y = gqa_attention_kv8(q.reshape(b, 1, hkv * g, d), k_all[layer],
                          ks_all[layer], v_all[layer], vs_all[layer], mask)
    return y.reshape(b, hkv, g, d)


def _pv_terms(w, dtype=torch.bfloat16):
    """p * vs as the bf16 or fp16 kernel feeds it to P.V: hi = rn(w) and
    lo = rn(w - hi) in `dtype`, summed (`csrc/flash_decode.cu:
    KV8_PV_TERMS`)."""
    hi = w.to(dtype).float()
    return hi + (w - hi).to(dtype).float()


def decode_partial_kv8_reference(q, k_all, ks_all, v_all, vs_all, layer: int,
                                 starts, ends):
    """The int8-KV kernel's softmax state (m, l, acc) of each row over
    positions [starts[b], ends[b]) of layer `layer`, in fp32, shaped as
    `decode_partial_reference`'s: scores (q . k_i8) * ks / sqrt(D), p =
    exp(score - m), l the sum of p, acc the sum of (p * vs) v_i8, with p *
    vs carried as the kernel carries it (fp32 for fp32 q, two terms of q's
    dtype for bf16 or fp16 q)."""
    d = q.shape[-1]
    k = k_all[layer].float()
    v = v_all[layer].float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k)
    s = s * (ks_all[layer].float().permute(0, 2, 1)[:, :, None, :]
             / math.sqrt(d))
    j = torch.arange(k.shape[1], device=q.device)
    inside = ((j[None, :] >= torch.as_tensor(starts, device=q.device)[:, None])
              & (j[None, :] < torch.as_tensor(ends, device=q.device)[:, None]))
    s = s.masked_fill(~inside[:, None, None, :], -math.inf)
    m = s.amax(dim=-1)
    p = torch.exp(s - m.clamp_min(NEG_INF)[..., None])
    w = p * vs_all[layer].float().permute(0, 2, 1)[:, :, None, :]
    if q.dtype in (torch.bfloat16, torch.float16):
        w = _pv_terms(w, q.dtype)
    return m, p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", w, v)


def _check_kv8(q, k_all, ks_all, v_all, vs_all, layer, lengths, starts):
    """What the int8-KV kernels take; the device is checked last, so that
    the CPU tests can hold the rest of the contract."""
    _check_starts("flash_decode_attention_kv8", lengths, starts)
    if (q.dtype not in DTYPE_CODES or k_all.dtype != torch.int8
            or v_all.dtype != torch.int8 or ks_all.dtype != torch.bfloat16
            or vs_all.dtype != torch.bfloat16):
        raise TypeError("flash_decode_attention_kv8: q bf16/fp16/fp32, K/V "
                        "int8, scales bf16")
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
    if d not in KV8_HEAD_DIMS[q.dtype] or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode_attention_kv8: D={d} not in "
                         f"{KV8_HEAD_DIMS[q.dtype]} for {q.dtype} or G={g} not "
                         f"in [1, {MAX_GROUP}]")
    if tuple(lengths.shape) != (b,):
        raise ValueError("flash_decode_attention_kv8: lengths must be (B,)")
    for name, x in (("q", q), ("k_all", k_all), ("ks_all", ks_all),
                    ("v_all", v_all), ("vs_all", vs_all), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode_attention_kv8: {name} must be "
                             f"contiguous")
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_all, ks_all, v_all, vs_all, lengths,
                         *(() if starts is None else (starts,)))):
        raise ValueError("flash_decode_attention_kv8: every tensor must lie on "
                         "one CUDA device")
    check_aligned("flash_decode_attention_kv8", q=q, k_all=k_all, v_all=v_all)


def flash_decode_attention_kv8(q, k_all, ks_all, v_all, vs_all, layer: int,
                               lengths, starts=None):
    """Same contract as `flash_decode_kv8_reference`; on CUDA tensors runs
    the hand-written int8-KV kernel, which reads only positions
    [starts[b], lengths[b]), split over `decode_split_count` blocks per
    row, in one launch."""
    if q.device.type == "cpu":
        return flash_decode_kv8_reference(q, k_all, ks_all, v_all, vs_all,
                                          layer, lengths, starts)
    z, work, counters, _, (kv_bytes, sc_bytes, _, _), code, scale = _plan(
        "flash_decode_attention_kv8", q, (k_all, ks_all, v_all, vs_all),
        lengths, starts, layer,
        lambda: _check_kv8(q, k_all, ks_all, v_all, vs_all, layer, lengths,
                           starts))
    b, hkv, g, d = q.shape
    out = torch.empty_like(q)
    rc = load_kernels().fs_flash_decode_kv8(
        q.data_ptr(), k_all.data_ptr() + kv_bytes * layer,
        ks_all.data_ptr() + sc_bytes * layer, v_all.data_ptr() + kv_bytes * layer,
        vs_all.data_ptr() + sc_bytes * layer, lengths.data_ptr(),
        None if starts is None else starts.data_ptr(), out.data_ptr(),
        work, counters, b, k_all.shape[2], hkv, g, d, code, z, scale,
        stream_ptr(q))
    check_launch(rc, "flash_decode_kv8")
    flash_decode_attention_kv8.launches += 1
    if q.dtype == torch.float16:
        flash_decode_attention_kv8.launches_f16 += 1
    return out


flash_decode_attention_kv8.launches = 0
flash_decode_attention_kv8.launches_f16 = 0
