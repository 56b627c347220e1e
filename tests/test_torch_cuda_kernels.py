"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip (with the reason) where no CUDA device is present.
Run them on a GPU machine with
    python -m pytest tests/test_torch_cuda_kernels.py -q
Inputs come from numpy with a seed. fp32 cases hold the kernel to 1e-4 abs
(only the summation order differs); bf16 cases to 2e-2 max / 2e-3 mean abs,
the bound of bf16 rounding of P before P.V in the plain version (the
output is a convex combination of V rows of unit scale). The training
forward's bf16 output gets one bf16 step of the value on top (2^-7 |O|):
rows with few visible keys have outputs above 2 in magnitude, where the
kernel's and the plain version's roundings can land one step apart. The
training backward's gradients are held to 1e-4 (fp32) or 2e-2 (bf16) of
each tensor's largest magnitude.
"""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                    flash_decode_reference)
from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                     flash_prefill_reference)
from fish_speech_tpu_torch.ops.flash_train import (
    flash_train_attention, flash_train_backward, flash_train_backward_reference,
    flash_train_forward, flash_train_forward_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=dev, dtype=dtype)


def _assert_close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4, err.max().item()
    else:
        assert err.max().item() <= 2e-2, err.max().item()
        assert err.mean().item() <= 2e-3, err.mean().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,offsets", [
    (1, 64, 32, 8, 128, [0]),
    (2, 100, 4, 2, 64, [0, 7]),
    (2, 600, 32, 8, 128, [0, 129]),
    (1, 1024, 32, 8, 128, [0]),
])
def test_prefill_kernel_matches_plain(dev, dtype, b, t, h, hkv, d, offsets):
    rng = np.random.default_rng(t)
    q = _randn(rng, (b, t, h, d), dtype, dev)
    k = _randn(rng, (b, t, hkv, d), dtype, dev)
    v = _randn(rng, (b, t, hkv, d), dtype, dev)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    n0 = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v, off)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == n0 + 1
    _assert_close(got, flash_prefill_reference(q, k, v, off), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_layer,b,s,hkv,g,d,lengths", [
    (2, 1, 4160, 8, 4, 128, [1]),
    (2, 1, 4160, 8, 4, 128, [257]),
    (2, 1, 4160, 8, 4, 128, [4000]),
    (2, 1, 10, 4, 3, 128, [7]),
    (2, 3, 300, 2, 8, 64, [1, 33, 300]),
])
def test_decode_kernel_matches_plain(dev, dtype, n_layer, b, s, hkv, g, d,
                                     lengths):
    rng = np.random.default_rng(s + sum(lengths))
    q = _randn(rng, (b, hkv, g, d), dtype, dev)
    k = _randn(rng, (n_layer, b, s, hkv, d), dtype, dev)
    v = _randn(rng, (n_layer, b, s, hkv, d), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for layer in range(n_layer):
        n0 = flash_decode_attention.launches
        got = flash_decode_attention(q, k, v, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention.launches == n0 + 1
        _assert_close(got, flash_decode_reference(q, k, v, layer, lens), dtype)


def _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev):
    q = _randn(rng, (b, t, h, d), dtype, dev)
    k = _randn(rng, (b, t, hkv, d), dtype, dev)
    v = _randn(rng, (b, t, hkv, d), dtype, dev)
    kvalid = torch.ones((b, t), dtype=torch.int32)
    for i, n in enumerate(pads):
        if n:
            kvalid[i, -n:] = 0
    do = _randn(rng, (b, t, h, d), dtype, dev)
    do = do * kvalid.to(dev, dtype)[:, :, None, None]  # padded rows: zero
    return q, k, v, kvalid.to(dev), do


TRAIN_SHAPES = [
    (2, 100, 4, 2, 64, [0, 7]),
    (1, 130, 8, 2, 128, [3]),
    (2, 1024, 32, 8, 128, [0, 100]),
    (2, 1000, 32, 8, 128, [0, 0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,pads", TRAIN_SHAPES)
def test_train_forward_kernel_matches_plain(dev, dtype, b, t, h, hkv, d, pads):
    rng = np.random.default_rng(t + h)
    q, k, v, kvalid, _ = _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev)
    n0 = flash_train_forward.launches
    o, lse = flash_train_forward(q, k, v, kvalid)
    torch.cuda.synchronize()
    assert flash_train_forward.launches == n0 + 1
    want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
    if dtype == torch.float32:
        _assert_close(o, want_o, dtype)
    else:
        err = (o.float() - want_o.float()).abs()
        assert (err <= 2e-2 + 2 ** -7 * want_o.float().abs()).all(), err.max().item()
        assert err.mean().item() <= 2e-3, err.mean().item()
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,pads", TRAIN_SHAPES)
def test_train_backward_kernels_match_plain(dev, dtype, b, t, h, hkv, d, pads):
    """dQ/dK/dV from the kernels vs the plain formulas on the same saved O
    and lse. Gradients are not convex combinations, so bf16 is held to
    2e-2 of each tensor's max magnitude."""
    rng = np.random.default_rng(t + d)
    q, k, v, kvalid, do = _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev)
    o, lse = flash_train_forward_reference(q, k, v, kvalid)
    n0 = flash_train_backward.launches
    got = flash_train_backward(q, k, v, kvalid, o, lse, do)
    torch.cuda.synchronize()
    assert flash_train_backward.launches == n0 + 1
    want = flash_train_backward_reference(q, k, v, kvalid, o, lse, do)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        bound = 1e-4 if dtype == torch.float32 else 2e-2
        assert err <= bound * max(1.0, w.float().abs().max().item()), err


def test_train_attention_function_launches_both_kernels(dev):
    rng = np.random.default_rng(0)
    q, k, v, kvalid, do = _train_inputs(rng, 1, 70, 4, 2, 64, [5],
                                        torch.float32, dev)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    n_f, n_b = flash_train_forward.launches, flash_train_backward.launches
    out = flash_train_attention(q, k, v, kvalid)
    grads = torch.autograd.grad((out * do).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert flash_train_forward.launches == n_f + 1
    assert flash_train_backward.launches == n_b + 1
    args = [x.detach().cpu() for x in (q, k, v, kvalid)]
    cq, ck, cv = (x.requires_grad_(True) for x in args[:3])
    want = flash_train_attention(cq, ck, cv, args[3])
    want_g = torch.autograd.grad((want * do.cpu()).sum(), (cq, ck, cv))
    assert (out.detach().cpu() - want.detach()).abs().max().item() <= 1e-4
    for g, w in zip(grads, want_g):
        assert (g.cpu() - w).abs().max().item() <= 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_prefill_attention(q, q, q, torch.zeros(1, dtype=torch.int32,
                                                     device=dev))
    q = torch.zeros(1, 2, 4, 96, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(1, 1, 8, 2, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_decode_attention(q, cache, cache, 0,
                               torch.ones(1, dtype=torch.int32, device=dev))
    q = torch.zeros(1, 8, 4, 96, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.bfloat16)
    kvalid = torch.ones(1, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_train_forward(q, k, k, kvalid)
    with pytest.raises(TypeError):
        flash_train_forward(q.half(), k.half(), k.half(), kvalid)
