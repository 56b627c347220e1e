"""Routes of the attention wrappers with two kernels per dtype, on the CPU.

`flash_train_forward`, `flash_train_backward` and `flash_prefill_attention`
pick their kernels by dtype (`_route`): bf16 goes to the tensor-core
kernels ("wgmma"), fp32 to the CUDA-core kernels ("cuda_cores"), anything
else raises; training's bf16 at head dim 32 (JAX's tiny model) goes to the
CUDA-core kernels on bf16 inputs ("cuda_cores_bf16"). Their checks (`_check`, `_check_backward`) raise on what the
kernels do not take before they look at the device, so the contract is
held here without a card. The launch counters count per route and
`reset_launches` zeroes them.

`_walked_keys` states which key tiles each warpgroup of the tensor-core
forward walks (`kv_tiles` in `csrc/attn_wgmma.cuh`), `_bwd_walks` which
query tiles a warpgroup of the dK/dV kernel and which key tiles a
warpgroup of the dQ kernel walk (`csrc/attn_bwd_wgmma.cuh`); the walk
tests show that what they skip changes no element of the plain versions.
The kernels' arithmetic is held on the card
(`tests/test_torch_cuda_kernels.py`).
"""

import math

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.ops import flash_prefill, flash_train
from fish_speech_tpu_torch.ops.attention import NEG_INF

WRAPPERS = {"train": flash_train, "train_bwd": flash_train,
            "prefill": flash_prefill}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_route_by_dtype(name):
    """bf16 "wgmma", fp32 "cuda_cores"; fp16 "wgmma_f16" for the prefill
    (`--half` serving) and a TypeError for training, which JAX runs in
    neither fp16 nor under `--half`; training's bf16 at D=32
    "cuda_cores_bf16" (the tensor-core kernels take D in {64, 128})."""
    mod = WRAPPERS[name]
    half = name == "prefill"
    d64 = () if half else (64,)  # training's route takes the head dim too
    assert mod.ROUTES == ("cuda_cores", "wgmma") + (("wgmma_f16",) if half
                                                    else ("cuda_cores_bf16",))
    assert mod._route(torch.bfloat16, *d64) == "wgmma"
    assert mod._route(torch.float32, *d64) == "cuda_cores"
    if half:
        assert mod._route(torch.float16) == "wgmma_f16"
    else:
        assert mod._route(torch.bfloat16, 32) == "cuda_cores_bf16"
        assert mod._route(torch.float32, 32) == "cuda_cores"
        assert mod._route(torch.bfloat16, 128) == "wgmma"
    for dtype in ((torch.float64, torch.int8) if half
                  else (torch.float16, torch.float64, torch.int8)):
        with pytest.raises(TypeError):
            mod._route(dtype, *d64)


def _args(name, b=1, t=8, h=4, hkv=2, d=128, dtype=torch.bfloat16, kdtype=None):
    q = torch.zeros(b, t, h, d, dtype=dtype)
    k = torch.zeros(b, t, hkv, d, dtype=kdtype or dtype)
    mask = (torch.zeros(b, dtype=torch.int32) if name == "prefill"
            else torch.ones(b, t, dtype=torch.int32))
    return q, k, k.clone(), mask


def _saved(q):
    """O, lse and dO of the shapes and dtypes the backward takes for q."""
    b, t, h, _ = q.shape
    return (torch.zeros(q.shape, dtype=q.dtype),
            torch.zeros(b, h, t, dtype=torch.float32),
            torch.zeros(q.shape, dtype=q.dtype))


def _check(name, *args):
    if name == "train_bwd":
        return flash_train._check_backward(*args, *_saved(args[0]))
    return WRAPPERS[name]._check(*args)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_takes_both_head_dims_and_wants_a_card(name, d, dtype):
    # everything the kernels take passes up to the device check
    with pytest.raises(ValueError, match="CUDA device"):
        _check(name, *_args(name, d=d, dtype=dtype))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("d", [32, 96, 256])
def test_check_rejects_other_head_dims(name, d):
    # D=32 is JAX's tiny model's: the fp32 routes take it, and training's
    # bf16 "cuda_cores_bf16"; the prefill's tensor-core routes do not, nor
    # does any route take 8 or 48
    for dd in ((8, 48) if d == 32 and name != "prefill" else (d,)):
        with pytest.raises(ValueError, match="head dim"):
            _check(name, *_args(name, d=dd))
    if d == 32:
        with pytest.raises(ValueError, match="CUDA device"):
            _check(name, *_args(name, d=32, dtype=torch.float32))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_check_rejects_mixed_and_other_dtypes(name):
    with pytest.raises(TypeError):
        _check(name, *_args(name, kdtype=torch.float32))
    # fp16 is the prefill's `--half` form; training takes no fp16
    for dtype in (torch.float64,) + (() if name == "prefill" else (torch.float16,)):
        with pytest.raises(TypeError):
            _check(name, *_args(name, dtype=dtype))
    q, k, v, mask = _args(name)
    with pytest.raises(TypeError):
        _check(name, q, k, v, mask.long())


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_check_rejects_bad_shapes_and_layouts(name):
    q, k, v, mask = _args(name, h=6, hkv=4)
    with pytest.raises(ValueError, match="multiple"):
        _check(name, q, k, v, mask)
    q, k, v, mask = _args(name)
    with pytest.raises(ValueError, match="contiguous"):
        _check(name, q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError):
        _check(name, q, k[:, :4].contiguous(), v[:, :4].contiguous(), mask)


def _counted(name):
    return {"train": flash_train.flash_train_forward,
            "train_bwd": flash_train.flash_train_backward,
            "prefill": flash_prefill.flash_prefill_attention}[name]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_counts_per_route_and_reset(name):
    mod, f = WRAPPERS[name], _counted(name)
    for i, route in enumerate(mod.ROUTES):
        setattr(f, f"launches_{route}", i + 3)
    f.launches = 7
    mod.reset_launches()
    assert f.launches == 0
    assert all(getattr(f, f"launches_{r}") == 0 for r in mod.ROUTES)
    # the plain version (CPU tensors) launches nothing
    q, k, v, mask = _args(name, t=16)
    f(q, k, v, mask, *(_saved(q) if name == "train_bwd" else ()))
    assert f.launches == 0
    assert all(getattr(f, f"launches_{r}") == 0 for r in mod.ROUTES)


def test_backward_check_rejects_bad_saved_tensors():
    q, k, v, mask = _args("train_bwd")
    o, lse, do = _saved(q)
    bad = [(o.float(), lse, do), (o, lse.to(torch.bfloat16), do),
           (o, lse, do.transpose(1, 2).contiguous().transpose(1, 2)),
           (o[:, :4].contiguous(), lse, do), (o, lse[:, :, :4].contiguous(), do),
           (o, lse, do[:, :, :2].contiguous())]
    for args in bad:
        with pytest.raises(ValueError):
            flash_train._check_backward(q, k, v, mask, *args)
    # the contract holds up to the device check
    with pytest.raises(ValueError, match="CUDA device"):
        flash_train._check_backward(q, k, v, mask, o, lse, do)


def _walked_keys(t, offset=None):
    """(T, T) bool: key j lies in a tile that query row i's warpgroup walks
    in `attn_fwd_wgmma` (`kv_tiles`, `csrc/attn_wgmma.cuh`): 64 rows a
    warpgroup, 64-key tiles up to the causal limit of its last row, or all T
    where a row of it lies before the prefill offset."""
    walked = torch.zeros(t, t, dtype=torch.bool)
    for r0 in range(0, t, 64):
        last = min(r0 + 64, t) - 1
        end = t if offset is not None and r0 < offset else last + 1
        walked[r0:last + 1, :64 * -(-end // 64)] = True
    return walked


def _softmax_over_walk(q, k, v, visible, walked):
    """fp32 attention where masked keys score NEG_INF and keys the walk never
    reaches are left out (-inf): what the kernel's softmax sees."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(g, 2)) / math.sqrt(d)
    s = torch.where(visible[:, None], s, torch.tensor(NEG_INF))
    s = s.masked_fill(~walked, -math.inf)
    p = torch.softmax(s, -1)
    return torch.einsum("bhts,bshd->bthd", p, v.repeat_interleave(g, 2))


def _f32(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("b,t,h,hkv,d,pads", [
    (2, 100, 4, 2, 64, [0, 7]),
    (1, 200, 2, 1, 128, [30]),
    (1, 130, 4, 2, 64, [0]),
])
def test_wgmma_walk_matches_the_plain_training_forward(b, t, h, hkv, d, pads):
    # the keys the tensor-core kernel's walk skips change no training row
    rng = np.random.default_rng(t)
    q, k, v = _f32(rng, (b, t, h, d)), _f32(rng, (b, t, hkv, d)), _f32(rng, (b, t, hkv, d))
    kvalid = torch.ones(b, t, dtype=torch.int32)
    for i, n in enumerate(pads):
        if n:
            kvalid[i, -n:] = 0
    i = torch.arange(t)
    visible = (i[None, :] <= i[:, None])[None] & (kvalid != 0)[:, None, :]
    got = _softmax_over_walk(q, k, v, visible, _walked_keys(t))
    want, _ = flash_train.flash_train_forward_reference(q, k, v, kvalid)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("b,t,h,hkv,d,offsets", [
    (2, 300, 2, 1, 128, [0, 129]),
    (2, 100, 4, 2, 64, [0, 7]),
    (1, 260, 2, 2, 64, [200]),
])
def test_wgmma_walk_matches_the_plain_prefill(b, t, h, hkv, d, offsets):
    # the keys the walk skips change no prefill row; a row before its offset
    # needs every key (the mean of V over all T), and its warpgroup walks them
    rng = np.random.default_rng(t + 1)
    q, k, v = _f32(rng, (b, t, h, d)), _f32(rng, (b, t, hkv, d)), _f32(rng, (b, t, hkv, d))
    off = torch.tensor(offsets, dtype=torch.int32)
    i = torch.arange(t)
    visible = (i[None, :] <= i[:, None])[None] & (i[None, None, :] >= off[:, None, None])
    walked = torch.stack([_walked_keys(t, o) for o in offsets])[:, None]
    got = _softmax_over_walk(q, k, v, visible, walked)
    want = flash_prefill.flash_prefill_reference(q, k, v, off)
    assert (got - want).abs().max().item() <= 1e-5
    for bi, o in enumerate(offsets):
        if o:
            mean_v = v[bi].mean(0).repeat_interleave(h // hkv, 0)
            assert (got[bi, :o] - mean_v).abs().max().item() <= 1e-5
            # the causal walk alone would average fewer keys
            short = _softmax_over_walk(q, k, v, visible, _walked_keys(t))
            assert (short[bi, :o] - mean_v).abs().max().item() > 1e-3


def _bwd_walks(t):
    """(dK/dV walk, dQ walk), each (T queries, T keys) bool, of the
    tensor-core backward (`csrc/attn_bwd_wgmma.cuh`): a dK/dV block owns
    128 keys, 64 a warpgroup, and walks the 64-query tiles from the one
    holding its first key to T, each warpgroup skipping the tiles that lie
    wholly before its keys; a dQ warpgroup owns 64 rows and walks the
    64-key tiles up to the causal limit of its last row."""
    kv = torch.zeros(t, t, dtype=torch.bool)
    for k0 in range(0, t, 128):
        for kw0 in (k0, k0 + 64):
            if kw0 >= t:
                continue
            for q0 in range(k0 // 64 * 64, t, 64):
                if q0 + 63 >= kw0:
                    kv[q0:q0 + 64, kw0:kw0 + 64] = True
    dq = torch.zeros(t, t, dtype=torch.bool)
    for r0 in range(0, t, 64):
        last = min(r0 + 64, t) - 1
        dq[r0:last + 1, :64 * (last // 64 + 1)] = True
    return kv, dq


def _backward_over_walks(q, k, v, kvalid, o, lse, do, kv_walk, dq_walk):
    """The plain backward's formulas in fp32 with P kept only on the pairs
    each kernel walks: dK/dV from the dK/dV walk, dQ from the dQ walk."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kr, vr = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bthd,bshd->bhts", q, kr) * scale
    i = torch.arange(t)
    visible = (i[None, :] <= i[:, None])[None] & (kvalid != 0)[:, None, :]
    p = torch.where(visible[:, None], torch.exp(s - lse[..., None]),
                    torch.tensor(0.0))
    dp = torch.einsum("bthd,bshd->bhts", do, vr)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    grads = []
    for walk in (kv_walk, dq_walk):
        pw = p * walk
        ds = pw * (dp - delta) * scale
        grads.append((pw, ds))
    (p_kv, ds_kv), (_, ds_q) = grads
    dq = torch.einsum("bhts,bshd->bthd", ds_q, kr)
    dk = torch.einsum("bhts,bthd->bshd", ds_kv, q)
    dv = torch.einsum("bhts,bthd->bshd", p_kv, do)
    fold = lambda x: x.reshape(b, t, k.shape[2], g, d).sum(3)
    return dq, fold(dk), fold(dv)


@pytest.mark.parametrize("b,t,h,hkv,d,pads", [
    (2, 100, 4, 2, 64, [0, 7]),
    (1, 200, 2, 1, 128, [30]),
    (1, 260, 4, 4, 64, [0]),
    (1, 190, 8, 1, 64, [3]),
])
def test_wgmma_backward_walks_match_the_plain_backward(b, t, h, hkv, d, pads):
    # the pairs the tensor-core backward's walks skip change no element of
    # dQ, dK or dV
    rng = np.random.default_rng(t + 2)
    q, k, v = _f32(rng, (b, t, h, d)), _f32(rng, (b, t, hkv, d)), _f32(rng, (b, t, hkv, d))
    do = _f32(rng, (b, t, h, d))
    kvalid = torch.ones(b, t, dtype=torch.int32)
    for i, n in enumerate(pads):
        if n:
            kvalid[i, -n:] = 0
    o, lse = flash_train.flash_train_forward_reference(q, k, v, kvalid)
    want = flash_train.flash_train_backward_reference(q, k, v, kvalid, o, lse, do)
    kv_walk, dq_walk = _bwd_walks(t)
    got = _backward_over_walks(q, k, v, kvalid, o, lse, do, kv_walk, dq_walk)
    for name, x, y in zip(("dQ", "dK", "dV"), got, want):
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), name
    # the walks skip pairs, and cutting them one tile short would not do
    assert not kv_walk.all() and not dq_walk.all()
    short_kv, short_dq = kv_walk.clone(), dq_walk.clone()
    short_kv[-1] = False  # the last query row, walked by no dK/dV block
    short_dq[:, :64] = False  # the first key tile, walked by no dQ warpgroup
    cut = _backward_over_walks(q, k, v, kvalid, o, lse, do, short_kv, short_dq)
    assert (cut[0] - want[0]).abs().max().item() > 1e-3
    assert (cut[1] - want[1]).abs().max().item() > 1e-3
