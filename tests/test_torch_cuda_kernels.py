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

The int4 matmul (`csrc/int4_mm.cu`) keeps the dequantized weight and the
sums in fp32: fp32 cases are held to 1e-5 of |x| @ |W| (summation order),
bf16 cases to one bf16 rounding of W and of y, 2^-8 (|x| @ |W| + |y|),
against both plain versions (`int4_matmul_reference` in fp32 and `mm`'s
CPU path, which rounds W to bf16). The int8-KV decode kernel is held to
kernel 2's bounds (the plain version rounds p * vs to bf16, the kernel
keeps it in fp32). The fast-stack probe at small dims (3 layers, 2 steps)
is held to 1e-3 abs on outputs of rms 1 (fp32 sums in another order, and
the activations' bf16 / int8 rounding can land one step apart).
"""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.models.dual_ar import _kv_quant
from fish_speech_tpu_torch.ops import faststack
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8,
    flash_decode_kv8_reference, flash_decode_reference)
from fish_speech_tpu_torch.ops.int4 import int4_matmul, int4_matmul_reference
from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight, mm,
                                             quantize_int4)
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



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,i,o,g", [
    (1, 2560, 6144, 128),    # slow wqkv, decode
    (1, 9728, 2560, 128),    # slow w2
    (1, 1536, 1536, 128),    # fast wo
    (3, 256, 200, 64),       # O not a multiple of 256
    (8, 128, 130, 32),       # ragged O, the matvec kernel's largest B
    (9, 256, 136, 64),       # the tiled kernel's smallest B
    (300, 512, 264, 128),
    (1024, 2560, 6144, 128), # slow wqkv, prefill bucket 1024
])
def test_int4_kernel_matches_plain(dev, dtype, b, i, o, g):
    rng = np.random.default_rng(b + i + o)
    w = torch.from_numpy(rng.standard_normal((i, o)).astype(np.float32) * 0.02)
    qw = {k: v.to(dev) for k, v in quantize_int4(w, group_size=g).items()}
    x = _randn(rng, (b, i), dtype, dev)
    n0 = int4_matmul.launches
    got = int4_matmul(x, qw["p"], qw["gs"])
    torch.cuda.synchronize()
    assert int4_matmul.launches == n0 + 1 and got.dtype == dtype
    want = int4_matmul_reference(x, qw["p"], qw["gs"]).float()
    w_abs = _int4_effective_weight(qw, torch.float32).abs()
    scale = x.float().abs() @ w_abs
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()
    else:
        bound = 2.0 ** -8 * (scale + want.abs())
        assert bool((err <= bound).all()), err.max().item()
        plain_bf16 = (x @ _int4_effective_weight(qw, dtype)).float()  # mm on CPU
        assert bool(((got.float() - plain_bf16).abs()
                     <= 2.0 ** -8 * (scale + plain_bf16.abs())).all())
    # mm dispatches CUDA int4 weights to the kernel
    assert torch.equal(mm(x[None], qw)[0], got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_layer,b,s,hkv,g,d,lengths", [
    (2, 1, 2112, 8, 4, 128, [1]),
    (2, 1, 2112, 8, 4, 128, [129]),
    (2, 1, 2112, 8, 4, 128, [2000]),
    (2, 3, 300, 2, 8, 64, [1, 128, 300]),
    (1, 2, 96, 4, 3, 128, [96, 40]),
])
def test_kv8_decode_kernel_matches_plain(dev, dtype, n_layer, b, s, hkv, g, d,
                                         lengths):
    rng = np.random.default_rng(s + sum(lengths))
    q = _randn(rng, (b, hkv, g, d), dtype, dev)
    k, ks = _kv_quant(_randn(rng, (n_layer, b, s, hkv, d), torch.float32, dev))
    v, vs = _kv_quant(_randn(rng, (n_layer, b, s, hkv, d), torch.float32, dev))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for layer in range(n_layer):
        n0 = flash_decode_attention_kv8.launches
        got = flash_decode_attention_kv8(q, k, ks, v, vs, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention_kv8.launches == n0 + 1
        _assert_close(got, flash_decode_kv8_reference(q, k, ks, v, vs, layer,
                                                      lens), dtype)


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
@pytest.mark.parametrize("r", [0, 1])
def test_faststack_kernel_matches_plain(dev, variant, r):
    dims = faststack.ProbeDims(df=256, dqkv=384, inter=512, n_layer=3, steps=2)
    w = faststack.make_weights(dims, dev)
    x = torch.full((1, dims.df), 0.01, device=dev)
    n0 = faststack.faststack_probe.launches
    got = faststack.faststack_probe(x, w, r, variant, dims)
    torch.cuda.synchronize()
    assert faststack.faststack_probe.launches == n0 + 1
    want = faststack.probe_reference(x, w, variant, dims)
    assert (got - want).abs().max().item() <= 1e-3
    faststack.reset_l2_persistence()


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="straddle"):
        int4_matmul(x, torch.zeros(48, 8, dtype=torch.uint8, device=dev),
                    torch.ones(3, 8, device=dev))
    with pytest.raises(TypeError):
        int4_matmul(x.half(), torch.zeros(48, 8, dtype=torch.uint8, device=dev),
                    torch.ones(1, 8, device=dev))
    q = torch.zeros(1, 2, 4, 128, device=dev, dtype=torch.bfloat16)
    kq = torch.zeros(1, 1, 8, 2, 128, device=dev, dtype=torch.int8)
    sc = torch.zeros(1, 1, 8, 2, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_decode_attention_kv8(q, kq, sc.float(), kq, sc, 0,
                                   torch.ones(1, dtype=torch.int32, device=dev))
    dims = faststack.ProbeDims(df=64, dqkv=128, inter=64, n_layer=2, steps=1)
    with pytest.raises(ValueError):
        faststack.faststack_probe(torch.zeros(1, 32, device=dev),
                                  faststack.make_weights(dims, dev), 0,
                                  "bf16", dims)
