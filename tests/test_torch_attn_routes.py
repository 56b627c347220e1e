"""Routes of the two attention-forward wrappers, on the CPU.

`flash_train_forward` and `flash_prefill_attention` pick their kernel by
dtype (`_route`): bf16 goes to the tensor-core kernel ("wgmma"), fp32 to
the CUDA-core kernel ("cuda_cores"), anything else raises. Their checks
(`_check`) raise on what the kernels do not take before they look at the
device, so the contract is held here without a card. The launch counters
count per route and `reset_launches` zeroes them.

`_walked_keys` states which key tiles each warpgroup of the tensor-core
kernel walks (`kv_tiles` in `csrc/attn_wgmma.cuh`); the walk tests show
that the keys it skips change no row of the plain versions. The kernel's
arithmetic is held on the card (`tests/test_torch_cuda_kernels.py`).
"""

import math

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.ops import flash_prefill, flash_train
from fish_speech_tpu_torch.ops.attention import NEG_INF

WRAPPERS = {"train": flash_train, "prefill": flash_prefill}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_route_by_dtype(name):
    mod = WRAPPERS[name]
    assert mod.ROUTES == ("cuda_cores", "wgmma")
    assert mod._route(torch.bfloat16) == "wgmma"
    assert mod._route(torch.float32) == "cuda_cores"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            mod._route(dtype)


def _args(name, b=1, t=8, h=4, hkv=2, d=128, dtype=torch.bfloat16, kdtype=None):
    q = torch.zeros(b, t, h, d, dtype=dtype)
    k = torch.zeros(b, t, hkv, d, dtype=kdtype or dtype)
    mask = (torch.ones(b, t, dtype=torch.int32) if name == "train"
            else torch.zeros(b, dtype=torch.int32))
    return q, k, k.clone(), mask


def _check(name, *args):
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
    with pytest.raises(ValueError, match="head dim"):
        _check(name, *_args(name, d=d))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_check_rejects_mixed_and_other_dtypes(name):
    with pytest.raises(TypeError):
        _check(name, *_args(name, kdtype=torch.float32))
    with pytest.raises(TypeError):
        _check(name, *_args(name, dtype=torch.float16))
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
    return (flash_train.flash_train_forward if name == "train"
            else flash_prefill.flash_prefill_attention)


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
    f(q, k, v, mask)
    assert f.launches == 0
    assert all(getattr(f, f"launches_{r}") == 0 for r in mod.ROUTES)


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
