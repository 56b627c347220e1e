"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip (with the reason) where no CUDA device is present.
Run them on a GPU machine with
    python -m pytest tests/test_torch_cuda_kernels.py -q
Inputs come from numpy with a seed. fp32 cases hold the kernel to 1e-4 abs
(only the summation order differs); bf16 cases to 2e-2 max / 2e-3 mean abs,
the bound of bf16 rounding of P before P.V (the output is a convex
combination of V rows of unit scale). The attention forwards take bf16 on
their tensor-core route and fp32 on their CUDA-core route (`_route`); each
case counts its launch on its route. The training
forward's bf16 output gets one bf16 step of the value on top (2^-7 |O|):
rows with few visible keys have outputs above 2 in magnitude, where the
kernel's and the plain version's roundings can land one step apart. The
training backward's gradients are held to 1e-4 (fp32) or 2e-2 (bf16) of
each tensor's largest magnitude.

The int4 matmul (`csrc/int4_mm.cu`) has three routes (`ops/int4.py:
_route`). fp32 x (matvec, fp32 tiled) uses the fp32 W: fp32 cases are held
to 1e-5 of |x| @ |W| (summation order). Every bf16 case is held to one bf16
rounding of W and of y, 2^-8 (|x| @ |W| + |y|), against both fp32-W plain
versions (`int4_matmul_reference` and `mm`'s CPU path, which rounds W to
bf16), and, since bf16 x uses the Pallas kernel's bf16 W on every route
(matvec, B <= 8, and tensor cores, B > 8), to that W's plain version,
`int4_matmul_bf16w_reference`, summed in fp32: 2^-8 |y| (the kernel's one
rounding of y to bf16) + 1e-5 of |x| @ |W| (the order of the fp32 sums). The int8-KV decode kernel is held to
kernel 2's bounds (the plain version rounds p * vs to bf16 once, the
kernel carries it as two bf16 terms). The fast-stack probe at small dims
(3 layers, 2 steps) is held to 1e-3 abs on outputs of rms 1 (fp32 sums in
another order, and the activations' bf16 / int8 rounding can land one step
apart), and gives the same bits twice (no atomics).
"""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.models.dual_ar import _kv_quant
from fish_speech_tpu_torch.ops import faststack
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8,
    flash_decode_kv8_reference, flash_decode_reference)
from fish_speech_tpu_torch.ops.int4 import (_route, int4_matmul,
                                             int4_matmul_bf16w_reference,
                                             int4_matmul_reference)
from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight, mm,
                                             quantize_int4)
from fish_speech_tpu_torch.ops.flash_prefill import _route as prefill_route
from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                     flash_prefill_reference)
from fish_speech_tpu_torch.ops.flash_train import _route as train_route
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
    (1, 64, 4, 2, 64, [0]),
    (2, 600, 8, 2, 64, [0, 129]),
    (1, 1000, 8, 2, 64, [0]),
    (1, 1024, 4, 1, 64, [300]),
])
def test_prefill_kernel_matches_plain(dev, dtype, b, t, h, hkv, d, offsets):
    rng = np.random.default_rng(t + d)
    q = _randn(rng, (b, t, h, d), dtype, dev)
    k = _randn(rng, (b, t, hkv, d), dtype, dev)
    v = _randn(rng, (b, t, hkv, d), dtype, dev)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    route = f"launches_{prefill_route(dtype)}"
    n0, r0 = flash_prefill_attention.launches, getattr(flash_prefill_attention, route)
    got = flash_prefill_attention(q, k, v, off)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == n0 + 1
    assert getattr(flash_prefill_attention, route) == r0 + 1
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


# S = 4160 at 8 KV heads splits 17 ways on 132 SMs, into slices of 256
# positions (`decode_split_count`, `decode_slice`); the bf16 kernel reads
# them in stages of 64 and tiles of 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[1], [15], [17], [255], [256], [257],
                                     [513], [4160], [1, 257, 4160]])
def test_decode_kernel_on_slice_boundaries(dev, dtype, lengths):
    rng = np.random.default_rng(sum(lengths))
    b, s, hkv, g, d = len(lengths), 4160, 8, 4, 128
    q = _randn(rng, (b, hkv, g, d), dtype, dev)
    k = _randn(rng, (1, b, s, hkv, d), dtype, dev)
    v = _randn(rng, (1, b, s, hkv, d), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = flash_decode_attention(q, k, v, 0, lens)
    torch.cuda.synchronize()
    _assert_close(got, flash_decode_reference(q, k, v, 0, lens), dtype)


def _one_call(fn, counters):
    """Run fn once after a warm call; returns its output, the launches it
    added to each counter and the allocations it made."""
    fn()
    torch.cuda.synchronize()
    before = [getattr(f, name) for f, name in counters]
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    torch.cuda.synchronize()
    made = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    return out, [getattr(f, name) - n for (f, name), n in zip(counters, before)], made


def test_decode_and_matvec_launch_once_and_allocate_only_the_output(dev):
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 8, 4, 128), torch.bfloat16, dev)
    k = _randn(rng, (2, 1, 4160, 8, 128), torch.bfloat16, dev)
    lens = torch.tensor([4000], dtype=torch.int32, device=dev)
    _, launched, made = _one_call(
        lambda: flash_decode_attention(q, k, k, 1, lens),
        [(flash_decode_attention, "launches")])
    assert launched == [1] and made == 1  # the output only
    for dtype in (torch.bfloat16, torch.float32):  # both int8-KV routes
        kq, ks = _kv_quant(_randn(rng, (2, 1, 4160, 8, 128), torch.float32, dev))
        qk = _randn(rng, (1, 8, 4, 128), dtype, dev)
        _, launched, made = _one_call(
            lambda: flash_decode_attention_kv8(qk, kq, ks, kq, ks, 1, lens),
            [(flash_decode_attention_kv8, "launches")])
        assert launched == [1] and made == 1
    w = torch.from_numpy(rng.standard_normal((2560, 19456)).astype(np.float32) * 0.02)
    qw = {n: t.to(dev) for n, t in quantize_int4(w, group_size=128).items()}
    x = _randn(rng, (1, 2560), torch.bfloat16, dev)
    _, launched, made = _one_call(
        lambda: int4_matmul(x, qw["p"], qw["gs"]),
        [(int4_matmul, "launches"), (int4_matmul, "launches_gemv")])
    assert launched == [1, 1] and made == 1


@pytest.mark.parametrize("kernel", ["decode", "kv8", "gemv"])
def test_split_kernels_are_deterministic_and_graph_capturable(dev, kernel):
    """Two calls give the same bits; a CUDA graph of the call, replayed
    after its inputs (lengths, q / x) are changed in place, equals the eager
    call on the new inputs."""
    rng = np.random.default_rng(11)
    if kernel == "kv8":
        q = _randn(rng, (3, 8, 4, 128), torch.bfloat16, dev)
        k, ks = _kv_quant(_randn(rng, (2, 3, 2112, 8, 128), torch.float32, dev))
        v, vs = _kv_quant(_randn(rng, (2, 3, 2112, 8, 128), torch.float32, dev))
        lens = torch.tensor([2048, 1, 700], dtype=torch.int32, device=dev)

        def call():
            return flash_decode_attention_kv8(q, k, ks, v, vs, 1, lens)

        def change():
            lens.copy_(torch.tensor([5, 2112, 1057], dtype=torch.int32))
            q.copy_(_randn(rng, q.shape, q.dtype, dev))
    elif kernel == "decode":
        q = _randn(rng, (3, 8, 4, 128), torch.bfloat16, dev)
        k = _randn(rng, (2, 3, 2112, 8, 128), torch.bfloat16, dev)
        v = _randn(rng, (2, 3, 2112, 8, 128), torch.bfloat16, dev)
        lens = torch.tensor([2048, 1, 700], dtype=torch.int32, device=dev)

        def call():
            return flash_decode_attention(q, k, v, 1, lens)

        def change():
            lens.copy_(torch.tensor([5, 2112, 1057], dtype=torch.int32))
            q.copy_(_randn(rng, q.shape, q.dtype, dev))
    else:
        w = torch.from_numpy(rng.standard_normal((9728, 2560)).astype(np.float32) * 0.02)
        qw = {n: t.to(dev) for n, t in quantize_int4(w, group_size=128).items()}
        x = _randn(rng, (1, 9728), torch.bfloat16, dev)

        def call():
            return int4_matmul(x, qw["p"], qw["gs"])

        def change():
            x.copy_(_randn(rng, x.shape, x.dtype, dev))
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    change()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, call())
    assert not torch.equal(captured, first)


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
    (1, 64, 4, 2, 64, [0]),
    (2, 600, 8, 2, 64, [0, 50]),
    (1, 1024, 4, 1, 64, [200]),
]
# the backward's walks also at G = 1 (H = Hkv), G = 8 and a long D = 64 T
BWD_SHAPES = TRAIN_SHAPES + [
    (2, 300, 4, 4, 128, [0, 20]),
    (1, 257, 16, 2, 64, [5]),
    (1, 4096, 4, 2, 64, [0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,pads", TRAIN_SHAPES)
def test_train_forward_kernel_matches_plain(dev, dtype, b, t, h, hkv, d, pads):
    rng = np.random.default_rng(t + h)
    q, k, v, kvalid, _ = _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev)
    route = f"launches_{train_route(dtype)}"
    n0, r0 = flash_train_forward.launches, getattr(flash_train_forward, route)
    o, lse = flash_train_forward(q, k, v, kvalid)
    torch.cuda.synchronize()
    assert flash_train_forward.launches == n0 + 1
    assert getattr(flash_train_forward, route) == r0 + 1
    want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
    if dtype == torch.float32:
        _assert_close(o, want_o, dtype)
    else:
        err = (o.float() - want_o.float()).abs()
        assert (err <= 2e-2 + 2 ** -7 * want_o.float().abs()).all(), err.max().item()
        assert err.mean().item() <= 2e-3, err.mean().item()
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,pads", BWD_SHAPES)
def test_train_backward_kernels_match_plain(dev, dtype, b, t, h, hkv, d, pads):
    """dQ/dK/dV from the kernels vs the plain formulas on the same saved O
    and lse. Gradients are not convex combinations, so bf16 is held to
    2e-2 of each tensor's max magnitude."""
    rng = np.random.default_rng(t + d)
    q, k, v, kvalid, do = _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev)
    o, lse = flash_train_forward_reference(q, k, v, kvalid)
    route = f"launches_{train_route(dtype)}"
    n0, r0 = flash_train_backward.launches, getattr(flash_train_backward, route)
    got = flash_train_backward(q, k, v, kvalid, o, lse, do)
    torch.cuda.synchronize()
    assert flash_train_backward.launches == n0 + 1
    assert getattr(flash_train_backward, route) == r0 + 1
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


def test_train_attention_function_bf16_matches_plain(dev):
    """bf16 autograd through the tensor-core forward and backward kernels,
    against the plain forward and backward on the same inputs."""
    rng = np.random.default_rng(1)
    q, k, v, kvalid, do = _train_inputs(rng, 2, 600, 8, 2, 128, [0, 40],
                                        torch.bfloat16, dev)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    n_f = flash_train_forward.launches_wgmma
    n_b = flash_train_backward.launches
    n_bw = flash_train_backward.launches_wgmma
    out = flash_train_attention(q, k, v, kvalid)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_train_forward.launches_wgmma == n_f + 1
    assert flash_train_backward.launches == n_b + 1
    assert flash_train_backward.launches_wgmma == n_bw + 1
    args = [x.detach() for x in (q, k, v)] + [kvalid]
    want_o, want_lse = flash_train_forward_reference(*args)
    err = (out.detach().float() - want_o.float()).abs()
    assert (err <= 2e-2 + 2 ** -7 * want_o.float().abs()).all(), err.max().item()
    assert err.mean().item() <= 2e-3
    want = flash_train_backward_reference(*args, want_o, want_lse, do)
    for g, w in zip(grads, want):
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item()), err


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


def test_wrappers_recheck_what_a_kept_plan_does_not_fix(dev):
    """A call whose shapes, dtypes and devices match a kept plan still
    checks the layer, contiguity and alignment (decode) and contiguity
    (int4) before it launches."""
    q = torch.zeros(1, 8, 4, 128, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(2, 1, 64, 8, 128, device=dev, dtype=torch.bfloat16)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    flash_decode_attention(q, cache, cache, 1, lens)  # the plan is kept
    with pytest.raises(ValueError):
        flash_decode_attention(q, cache, cache, 2, lens)
    q_t = torch.zeros(1, 8, 128, 4, device=dev, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        flash_decode_attention(q_t, cache, cache, 0, lens)
    q_off = torch.zeros(q.numel() + 1, device=dev, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError):
        flash_decode_attention(q_off.view(q.shape), cache, cache, 0, lens)
    w = torch.zeros(256, 128)
    qw = {n: t.to(dev) for n, t in quantize_int4(w, group_size=64).items()}
    int4_matmul(torch.zeros(1, 256, device=dev, dtype=torch.bfloat16), qw["p"], qw["gs"])
    x_strided = torch.zeros(1, 512, device=dev, dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError):
        int4_matmul(x_strided, qw["p"], qw["gs"])



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,i,o,g", [
    (1, 2560, 6144, 128),    # slow wqkv, decode
    (1, 4096, 2560, 128),    # slow wo
    (1, 2560, 19456, 128),   # slow w13
    (1, 9728, 2560, 128),    # slow w2
    (1, 1536, 2560, 128),    # fast wqkv
    (1, 1536, 1536, 128),    # fast wo
    (1, 1536, 12288, 128),   # fast w13
    (1, 6144, 1536, 128),    # fast w2
    (3, 256, 200, 64),       # O not a multiple of 256
    (1, 256, 272, 64),       # O a multiple of 16, not of 256: a tile past O
    (8, 128, 130, 32),       # ragged O, the matvec kernel's largest B
    (9, 256, 136, 64),       # the tiled kernels' smallest B
    (128, 256, 128, 64),     # one 128 x 128 tile, two K stages
    (40, 192, 72, 12),       # groups that split a chunk of 8 rows
    (33, 192, 72, 3),        # odd groups, scales read from global memory
    (16, 100, 40, 2),        # I and O off the 16-byte copies
    (20, 64, 24, 1),         # one scale per row
    (300, 512, 264, 128),
    (1000, 384, 200, 64),    # ragged B and O, a half-filled last K stage
    (128, 2560, 6144, 128),  # slow wqkv, the short prompt's bucket
    (1024, 2560, 6144, 128), # slow wqkv, prefill bucket 1024
    (1024, 2560, 19456, 128),  # slow w13
])
def test_int4_kernel_matches_plain(dev, dtype, b, i, o, g):
    rng = np.random.default_rng(b + i + o)
    w = torch.from_numpy(rng.standard_normal((i, o)).astype(np.float32) * 0.02)
    qw = {k: v.to(dev) for k, v in quantize_int4(w, group_size=g).items()}
    x = _randn(rng, (b, i), dtype, dev)
    route = f"launches_{_route(b, dtype)}"
    n0, r0 = int4_matmul.launches, getattr(int4_matmul, route)
    got = int4_matmul(x, qw["p"], qw["gs"])
    torch.cuda.synchronize()
    assert int4_matmul.launches == n0 + 1 and got.dtype == dtype
    assert getattr(int4_matmul, route) == r0 + 1
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
    if dtype == torch.bfloat16:
        # every bf16 route (matvec and tensor cores): the same bf16 W summed
        # in fp32 (x.float() is exact)
        exact = int4_matmul_bf16w_reference(x.float(), qw["p"], qw["gs"])
        err = (got.float() - exact).abs()
        assert bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all()), \
            err.max().item()
    # mm dispatches CUDA int4 weights to the kernel
    assert torch.equal(mm(x[None], qw)[0], got)


def test_mm_routes_int4_products_by_rows_and_dtype(dev):
    """bf16 prefill rows go to the tensor-core kernel, fp32 rows to the
    CUDA-core tiled kernel, up to 8 rows to the matvec kernel."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((256, 192)).astype(np.float32))
    qw = {k: v.to(dev) for k, v in quantize_int4(w, group_size=64).items()}
    for shape, dtype, route in [((2, 64, 256), torch.bfloat16, "wgmma"),
                                ((2, 64, 256), torch.float32, "fp32_tiled"),
                                ((1, 8, 256), torch.bfloat16, "gemv"),
                                ((1, 1, 256), torch.float32, "gemv")]:
        before = {r: getattr(int4_matmul, f"launches_{r}")
                  for r in ("gemv", "wgmma", "fp32_tiled")}
        y = mm(_randn(rng, shape, dtype, dev), qw)
        torch.cuda.synchronize()
        assert y.shape == (*shape[:-1], 192) and y.dtype == dtype
        for r, n in before.items():
            assert getattr(int4_matmul, f"launches_{r}") == n + (r == route), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_layer,b,s,hkv,g,d,lengths", [
    (2, 1, 2112, 8, 4, 128, [1]),
    (2, 1, 2112, 8, 4, 128, [129]),
    (2, 1, 2112, 8, 4, 128, [2000]),
    (2, 1, 4160, 8, 4, 128, [4000]),
    (1, 3, 4160, 8, 4, 128, [257, 4160, 17]),  # ragged, on slice edges
    (2, 3, 300, 2, 8, 64, [1, 128, 300]),
    (1, 2, 2112, 8, 1, 64, [2112, 1100]),
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
    again = faststack.faststack_probe(x, w, r, variant, dims)
    torch.cuda.synchronize()
    assert faststack.faststack_probe.launches == n0 + 2
    assert torch.equal(got, again)
    want = faststack.probe_reference(x, w, variant, dims)
    assert (got - want).abs().max().item() <= 1e-3
    for part in ("barriers", "loads"):  # a frame's pieces alone launch too
        assert faststack.part_ms(part, r, variant, repeats=1, frames=2,
                                 dims=dims, weights=w, device=dev) > 0
    assert faststack.faststack_probe.launches == n0 + 2
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


def _graph_session(dev, kind, **kw):
    """A small model on the card (heads of D=64, ten codebooks) served by a
    graphed session: "bf16" weights and cache, or "mixed" (slow int8, fast
    int4, heads int8) with the int8 KV cache."""
    from fish_speech_tpu_torch.config import SamplingConfig, dual_ar_tiny
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    cfg = dual_ar_tiny(vocab_size=tok.vocab_size, head_dim=64, n_head=4,
                       n_local_heads=2, dim=256, intermediate_size=512,
                       fast_dim=256, fast_intermediate_size=512,
                       fast_head_dim=64, fast_n_head=3, fast_n_local_heads=1,
                       num_codebooks=10, attention_qk_norm=True,
                       tie_word_embeddings=False, max_seq_len=256,
                       semantic_begin_id=tok.semantic_begin_id,
                       semantic_end_id=tok.semantic_end_id,
                       im_end_id=tok.im_end_id)
    params = init_dual_ar(7, cfg, torch.bfloat16, dev)
    if kind == "mixed":
        params = quantize_dual_ar_lowmem(params, mode="int8", fast_mode="int4")
    return GenerationSession(params, cfg, SamplingConfig(), dtype=torch.bfloat16,
                             decode_chunk_size=4, first_chunk_size=2,
                             kv_quant=kind == "mixed", **kw)


def _graph_prompt(cfg, t, seed):
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, cfg.codebook_size,
                       (cfg.num_codebooks + 1, t)).astype(np.int32)
    inp[0, t // 4 : t // 2] += cfg.semantic_begin_id  # a stretch of semantic tokens
    return inp


def _eager_stream(session, prompt, budget, sampling, generator):
    """The session's request run eagerly: the same bodies on a fresh
    `StepState` (the same weights), the uniform blocks filled from
    `generator` in `generate_stream`'s order, every chunk run in full and
    cut at the budget and at im_end as `generate_stream` cuts."""
    from fish_speech_tpu_torch.generate import (StepState, decode_step,
                                                prefill_body)
    from fish_speech_tpu_torch.ops.sampling import fill_uniforms

    cfg, scfg, ref = session.cfg, session.scfg, session.state
    st = StepState(cfg, scfg, session.cache_len, ref.u.shape[0], torch.bfloat16,
                   torch.bfloat16, session.device, session.kv_quant)
    t = prompt.shape[1]
    bucket = session._bucket(t)
    st.prompt(bucket)[0, :, :t].copy_(torch.from_numpy(prompt))
    st.t_end.fill_(t)
    st.sampling.copy_(torch.tensor(sampling, dtype=torch.float32))
    fill_uniforms(st.u[:1], generator)
    prefill_body(session.params, cfg, scfg, st, bucket)
    cols = [st.token.clone()]
    left, n = budget - 1, session.first_chunk_size
    while left > 0:
        fill_uniforms(st.u[:n], generator)
        st.step.zero_()
        for _ in range(n):
            decode_step(session.params, cfg, scfg, st)
        cols.extend(st.cols[:n].clone())
        left, n = left - n, session.decode_chunk_size
    out = torch.cat(cols).cpu().numpy().T[:, :budget]
    ends = np.flatnonzero(out[0] == cfg.im_end_id)
    return out[:, : ends[0] + 1] if len(ends) else out


@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_graphed_session_columns_equal_the_eager_bodies(dev, kind):
    """Greedy, over a first chunk of 2 and chunks of 4, at prompt buckets 64
    and 128 (captured ahead by `precompile`): the replayed graphs give the
    eager bodies' columns; every decode step on the card is a replay, each
    graph had one eager run (its capture's warm-up), and the launch counts
    are the captured counts times the replays."""
    session = _graph_session(dev, kind)
    cfg = session.cfg
    times = session.precompile(37, 11)
    assert set(times) == {"prefill_64", "decode"} and min(times.values()) > 0
    assert set(session.precompile(90, 11, first_chunk=2)) == {"prefill_128"}
    assert session.pool_bytes > 0
    per_step = session.launches_per_replay("decode")
    fast = cfg.num_codebooks * cfg.n_fast_layer
    if kind == "mixed":
        assert per_step["flash_decode_attention_kv8.launches"] == cfg.n_layer
        assert per_step["flash_decode_attention.launches"] == fast
        assert per_step["int4_matmul.launches_gemv"] > 0
    else:
        assert per_step["flash_decode_attention.launches"] == cfg.n_layer + fast
    for t, bucket in ((37, 64), (90, 128)):
        prompt = _graph_prompt(cfg, t, seed=t)
        replays = dict(session.replays)
        n0 = flash_decode_attention.launches
        got = session.generate(prompt, session.new_generator(1), max_new_tokens=11,
                               top_k=1)
        launched = flash_decode_attention.launches - n0
        want = _eager_stream(session, prompt, 11, (1.0, 0.9, 1),
                             session.new_generator(1))
        np.testing.assert_array_equal(got, want)
        name = f"prefill_{bucket}"
        assert session.replays[name] == replays.get(name, 0) + 1
        steps = session.replays["decode"] - replays.get("decode", 0)
        assert steps >= got.shape[1] - 1 and steps > 0
        # the prefill graph's first column runs the fast stack's decode too
        assert launched == (steps * per_step["flash_decode_attention.launches"]
                            + session.launches_per_replay(f"prefill_{bucket}")[
                                "flash_decode_attention.launches"])
    assert dict(session.eager_runs) == {"prefill_64": 1, "decode": 1,
                                        "prefill_128": 1}


@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_decode_graph_replayed_after_pos_and_token_change(dev, kind):
    """Replayed after `pos`, `token` (and the window and uniforms) change
    in place, the decode graph gives an eager step's column and cache row
    there."""
    from fish_speech_tpu_torch.generate import StepState, decode_step

    session = _graph_session(dev, kind)
    cfg, st = session.cfg, session.state
    session.generate(_graph_prompt(cfg, 60, seed=3), session.new_generator(2),
                     max_new_tokens=7, top_k=30)
    rng = np.random.default_rng(4)
    st.pos.fill_(97)
    st.token.copy_(torch.from_numpy(_graph_prompt(cfg, 1, seed=5)[:, 0][None]))
    st.window.copy_(torch.from_numpy(rng.integers(
        cfg.semantic_begin_id, cfg.semantic_begin_id + 50, st.window.shape)))
    st.u.uniform_(generator=session.new_generator(9)).clamp_(min=1e-30)
    st.step.fill_(1)
    ref = StepState(cfg, session.scfg, session.cache_len, st.u.shape[0],
                    torch.bfloat16, torch.bfloat16, dev, session.kv_quant)
    for name in ("token", "pos", "window", "step", "u", "sampling"):
        getattr(ref, name).copy_(getattr(st, name))
    for name, t in st.cache.items():
        ref.cache[name].copy_(t)
    decode_step(session.params, cfg, session.scfg, ref)
    session._run("decode")
    torch.cuda.synchronize()
    assert torch.equal(st.cols[1], ref.cols[1])
    assert int(st.pos) == 98 and int(st.step) == 2
    for name, t in st.cache.items():
        assert torch.equal(t[:, :, 97], ref.cache[name][:, :, 97]), name


def test_repeated_seed_gives_identical_codes(dev):
    session = _graph_session(dev, "bf16")
    prompt = _graph_prompt(session.cfg, 50, seed=6)
    runs = [session.generate(prompt, session.new_generator(s), max_new_tokens=15,
                             temperature=0.8, top_p=0.9, top_k=30)
            for s in (11, 11, 12)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_codec_graph_replays_equal_the_eager_bodies(dev, tmp_path, kind):
    """The engine's codec graphs on `dac_tiny`: one row captured ahead by
    `precompile`, two rows at first use; each replay's output equals an
    eager run of the same body on the card, bit for bit, and each graph
    ran its body eagerly once (its capture's warm-up)."""
    from fish_speech_tpu_torch.audio.io import load_audio, write_wav
    from fish_speech_tpu_torch.config import dac_tiny
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
    from fish_speech_tpu_torch.models.dac.model import (dac_encode,
                                                        dac_from_indices,
                                                        init_dac)

    cfg = dac_tiny()
    frame = cfg.frame_length
    engine = TTSInferenceEngine(None, None, init_dac(5, cfg, device=dev), cfg)
    rng = np.random.default_rng(8)
    if kind == "decode":
        times = engine.precompile(code_buckets=(20,))
        items = [rng.integers(0, cfg.rvq.codebook_size,
                              (cfg.rvq.total_codebooks, t)).astype(np.int32)
                 for t in (20, 9, 30)]
        got = [engine.decode_vq_tokens(items[0])] + engine.decode_vq_batch(items[1:])
    else:
        times = engine.precompile(reference_buckets=(7,))
        items = []
        for i, seconds in enumerate((0.3, 0.2, 0.45)):
            write_wav(tmp_path / f"{i}.wav", 0.3 * rng.standard_normal(
                int(seconds * cfg.sample_rate)), cfg.sample_rate)
            items.append((tmp_path / f"{i}.wav").read_bytes())
        got = [engine.encode_reference(items[0])] + engine.encode_references_batch(
            items[1:])
    assert set(times) == {(kind, 1, 32)}
    assert dict(engine.codec_replays) == {(kind, 1, 32): 1, (kind, 2, 32): 1}
    assert dict(engine.codec_eager_runs) == {(kind, 1, 32): 1, (kind, 2, 32): 1}
    assert engine.codec_pool_bytes > 0
    for rows, group in ((1, items[:1]), (2, items[1:])):
        if kind == "decode":
            padded = torch.zeros((rows, cfg.rvq.total_codebooks, 32),
                                 dtype=torch.int32, device=dev)
            for r, codes in enumerate(group):
                padded[r, :, : codes.shape[1]] = torch.from_numpy(codes)
            with torch.no_grad():
                eager = dac_from_indices(engine.codec_params, cfg, padded).cpu().numpy()
            want = [eager[r, 0, : c.shape[1] * frame] for r, c in enumerate(group)]
        else:
            padded = torch.zeros((rows, 1, 32 * frame), device=dev)
            wavs = [load_audio(b, cfg.sample_rate) for b in group]
            for r, wav in enumerate(wavs):
                padded[r, 0, : len(wav)] = torch.from_numpy(wav)
            with torch.no_grad():
                eager = dac_encode(engine.codec_params, cfg, padded)[0].cpu().numpy()
            want = [eager[r, :, : -(-len(w) // frame)] for r, w in enumerate(wavs)]
        for g, w in zip(got[:rows] if rows == 1 else got[1:], want):
            np.testing.assert_array_equal(g, w)
