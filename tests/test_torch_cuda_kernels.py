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

The int4 matmul (`csrc/int4_mm.cuh`) has three routes (`ops/int4.py:
_route`). fp32 x (matvec, fp32 tiled) uses the fp32 W: fp32 cases are held
to 1e-5 of |x| @ |W| (summation order). Every bf16 case is held to one bf16
rounding of W and of y, 2^-8 (|x| @ |W| + |y|), against both fp32-W plain
versions (`int4_matmul_reference` and `mm`'s CPU path, which rounds W to
bf16), and, since bf16 x uses the Pallas kernel's bf16 W on every route
(matvec, B <= 8, and tensor cores, B > 8), to that W's plain version,
`int4_matmul_bf16w_reference`, summed in fp32: 2^-8 |y| (the kernel's one
rounding of y to bf16) + 1e-5 of |x| @ |W| (the order of the fp32 sums).
fp16 x (the "gemv_f16" and "wgmma_f16" forms) is held to the bf16 cases'
bounds against the fp32-W versions and to `int4_matmul_f16w_reference`
within 2^-11 |y| (half an fp16 ulp) + 1e-5 of |x| @ |W|; with a
checkpoint's fp16 scales its W is the JAX `mm`'s, rn_f16(q * s). The
suffix kernel is also held at the serving cache's shapes (S = 2176, start
951, Ts 64 and 128, B 1, 4 and 16) in bf16 and fp16 over both caches, with
equal bits twice and from a graph, and its int8-cache split plans are
replayed 4096 times beside a stream of copies, every output in equal bits. The int8-KV decode kernel is held to
kernel 2's bounds (the plain version rounds p * vs to bf16 once, the
kernel carries it as two bf16 terms). The fast-stack probe at small dims
(3 layers, 2 steps) is held to 1e-3 abs on outputs of rms 1 (fp32 sums in
another order, and the activations' bf16 / int8 rounding can land one step
apart), and gives the same bits twice (no atomics).

The int8 matmul (`csrc/int8_mm.cu`, `ops/int8.py`) runs at every int8
product of the serving paths (s2-pro's slow and fast stacks, w13 fused, the
full LM head, the semantic head's S + 1 columns as a view of rows 16 bytes
apart, the fast head) and at ragged I and O, at B in {1, 4, 16, 32}: bf16
within 2^-8 |y| (its one rounding of y) + 1e-5 of (|x| @ |q|) * s (the
order of the fp32 sums) of the plain version summed in fp32, fp32 within
1e-5 of (|x| @ |q|) * s; one launch, only the output allocated, the same
bits twice and under a CUDA graph. Its cluster kernel (bf16, 17-32 rows,
`int8_gemv_plan`) also at a one-block plan (a tile count that fills the
card), the largest cluster (8 blocks), the padded semantic head and the
block-copied layouts (rows not 16 bytes apart, I off 8), at B = 27 (x's
rows not a multiple of 8: TMA's zero rows; B = 5 there takes the 1-16-row
kernel), and at every cluster size through its C entry point at B = 1, 5,
27 and 32, the same bits twice.

The fused int8 FFN (`csrc/int8_ffn.cu`, `ops/int8_ffn.py`) runs at s2-pro's
slow and fast FFNs, the graph tests' small model and a ragged I, at B in
{1, 4, 16, 32}: bf16 (tensor cores) within 2 bf16 ulps of max |y| of the
plain version (the two sum u in another order, so g's rounding can land
one step apart), fp32 (CUDA cores) within 1e-5 of max |y|; the w13 and
(w1, w3) forms and `dual_ar._ffn`'s route give the same bits; one launch,
only the output allocated; the same bits twice and on two graph replays;
`_check` refuses on card tensors what the kernels do not take; the decode
graphs of a `mixed` session and of an int8 pool launch it once per int8
FFN of the step.

The four decode kernels take per-row `starts` (the lockstep batch's left
pad): ragged starts inside a 16-position tile and past whole slices,
against their plain versions at the bounds above, with NaN and infinite
pad below the starts; `starts=None` gives the bits of zero starts; one
launch, and a graph replayed after starts change. The lockstep
`generate_batch` (graphs captured by `precompile`) gives the CPU eager
bodies' greedy columns (fp32, plain and int8 cache), and the tiny engine's
streamed request gives the same audio from device partials as from host
partials, every codec call a replay.

The checkpoint tools: a parity golden saved by `tools.parity_check --cpu`
on a tiny fp32 checkpoint (heads of 64, and at JAX's tiny widths) passes
the tool on the card, which launches the fp32 prefill, decode and
training-forward kernels; the naive model's fp32 forward on the card is
within 1e-4 of the CPU's (both widths).

JAX's tiny widths (slow heads D=32, fast D=16, G=2): the fp32 decode at
D=32 and 16 (with and without starts), the fp32 int8-KV decode, prefill
and both suffix forms at D=32, the training pair at D=32 in fp32
("cuda_cores") and bf16 ("cuda_cores_bf16", within the bf16 cases'
bounds; autograd's gradients are the backward's), each against its plain
version; other widths refused on card tensors. The lockstep batch at
JAX's widths gives the CPU's columns, and the `--tiny` engine (plain and
`--int8`) on the card gives the `--cpu` engine's greedy codes over prefix
hits. The redesigned fp32 int8 matvec (`int8_gemv_fp32_kernel`: JAX's
tiny products, the heads, split shapes, s2-pro's w2, byte loads at odd
row strides) and fused FFN (`int8_ffn_fp32_kernel`: the tiny FFNs,
s2-pro's, ragged ones) at B in {1, 4, 16, 32}: within 1e-5 of (|x| @ |q|)
* s or of max |y|, one launch on their route, and two replays of a graph
giving the eager call's bits.
"""

import math

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.models.dual_ar import _kv_quant
from fish_speech_tpu_torch.ops import faststack
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8,
    flash_decode_kv8_reference, flash_decode_reference)
from fish_speech_tpu_torch.ops.int4 import (ROUTES as INT4_ROUTES, _route,
                                             int4_dequant_f16, int4_matmul,
                                             int4_matmul_bf16w_reference,
                                             int4_matmul_f16w_reference,
                                             int4_matmul_reference)
from fish_speech_tpu_torch.ops.int8 import _route as int8_route
from fish_speech_tpu_torch.ops.int8 import int8_matmul, int8_matmul_reference
from fish_speech_tpu_torch.ops.int8_ffn import _route as ffn_route
from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn, int8_ffn_reference
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    route = f"launches_{train_route(dtype, d)}"
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
    route = f"launches_{train_route(dtype, d)}"
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
    # fp16 has a prefill form (`--half`); float64 none
    q = torch.zeros(1, 8, 4, 128, device=dev, dtype=torch.float64)
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



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    if dtype == torch.float16:
        # both fp16 routes: W = rn_f16(q * rn_f16(s)) summed in fp32, y
        # rounded once (half an fp16 ulp, 2^-11 |y|)
        exact = int4_matmul_f16w_reference(x.float(), qw["p"], qw["gs"])
        err = (got.float() - exact).abs()
        assert bool((err <= 2.0 ** -11 * exact.abs() + 1e-5 * scale).all()), \
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
                                ((1, 1, 256), torch.float32, "gemv"),
                                ((2, 64, 256), torch.float16, "wgmma_f16"),
                                ((1, 8, 256), torch.float16, "gemv_f16")]:
        before = {r: getattr(int4_matmul, f"launches_{r}") for r in INT4_ROUTES}
        y = mm(_randn(rng, shape, dtype, dev), qw)
        torch.cuda.synchronize()
        assert y.shape == (*shape[:-1], 192) and y.dtype == dtype
        for r, n in before.items():
            assert getattr(int4_matmul, f"launches_{r}") == n + (r == route), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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


@pytest.mark.parametrize("b,i,o", [(1, 2560, 19456), (128, 9728, 2560),
                                   (1024, 9728, 2560)])
def test_int4_fp16_routes_at_serving_shapes(dev, b, i, o):
    """The fp16 routes at phase 6's shapes (the slow w13 at B=1: "gemv_f16";
    the slow w2 at B=128 and 1024: "wgmma_f16") with a checkpoint's fp16
    scales, where the kernels' W, rn_f16(q * s), is bitwise the W of the
    JAX package's `mm` (`_int4_effective_weight` in fp16): within half an
    fp16 ulp of y (its one rounding) + 1e-5 of |x| @ |W| (the order of the
    fp32 sums) of x @ W summed in fp32; the same bits twice."""
    rng = np.random.default_rng(b + o)
    w = torch.from_numpy(rng.standard_normal((i, o)).astype(np.float32) * 0.02)
    qw = {k: v.to(dev) for k, v in quantize_int4(w, group_size=128).items()}
    qw["gs"] = qw["gs"].half()  # as `load_params` reads it under --half
    x = _randn(rng, (b, i), torch.float16, dev)
    route = f"launches_{_route(b, torch.float16)}"
    assert route == ("launches_gemv_f16" if b == 1 else "launches_wgmma_f16")
    r0 = getattr(int4_matmul, route)
    got = int4_matmul(x, qw["p"], qw["gs"])
    again = int4_matmul(x, qw["p"], qw["gs"])
    torch.cuda.synchronize()
    assert getattr(int4_matmul, route) == r0 + 2 and got.dtype == torch.float16
    assert torch.equal(got, again)
    w16 = _int4_effective_weight(qw, torch.float16)  # mm's W, rn_f16(q * s)
    assert torch.equal(int4_dequant_f16(qw["p"], qw["gs"]), w16)
    exact = x.float() @ w16.float()
    scale = x.float().abs() @ w16.float().abs()
    err = (got.float() - exact).abs()
    assert bool((err <= 2.0 ** -11 * exact.abs() + 1e-5 * scale).all()), err.max().item()


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
    with pytest.raises(TypeError):  # fp16 has a form (`--half`); float64 none
        int4_matmul(x.double(), torch.zeros(48, 8, dtype=torch.uint8, device=dev),
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


def _graph_cfg():
    """A small model with heads of D=64 and ten codebooks."""
    from fish_speech_tpu_torch.config import dual_ar_tiny
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    return dual_ar_tiny(vocab_size=tok.vocab_size, head_dim=64, n_head=4,
                        n_local_heads=2, dim=256, intermediate_size=512,
                        fast_dim=256, fast_intermediate_size=512,
                        fast_head_dim=64, fast_n_head=3, fast_n_local_heads=1,
                        num_codebooks=10, attention_qk_norm=True,
                        tie_word_embeddings=False, max_seq_len=256,
                        semantic_begin_id=tok.semantic_begin_id,
                        semantic_end_id=tok.semantic_end_id,
                        im_end_id=tok.im_end_id)


def _graph_session(dev, kind, **kw):
    """A small model on the card (heads of D=64, ten codebooks) served by a
    graphed session: "bf16" weights and cache, or "mixed" (slow int8, fast
    int4, heads int8) with the int8 KV cache."""
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _graph_cfg()
    params = init_dual_ar(7, cfg, torch.bfloat16, dev)
    if kind == "mixed":
        params = quantize_dual_ar_lowmem(params, mode="int8", fast_mode="int4")
    kw = {"decode_chunk_size": 4, "first_chunk_size": 2, **kw}
    return GenerationSession(params, cfg, SamplingConfig(), dtype=torch.bfloat16,
                             kv_quant=kind == "mixed", **kw)


def _graph_prompt(cfg, t, seed):
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, cfg.codebook_size,
                       (cfg.num_codebooks + 1, t)).astype(np.int32)
    inp[0, t // 4 : t // 2] += cfg.semantic_begin_id  # a stretch of semantic tokens
    return inp


def _eager_stream(session, prompt, budget, sampling, seed, audio=None):
    """The session's request run eagerly: the same bodies on a fresh
    `StepState` (the same weights) drawing the uniforms of `seed`, every
    chunk run in full and cut at the budget and at im_end as
    `generate_stream` cuts; `audio` (features (T, F), mask (T,)) conditions
    the prefill."""
    from fish_speech_tpu_torch.generate import (StepState, decode_step,
                                                prefill_body)

    cfg, scfg, ref = session.cfg, session.scfg, session.state
    st = StepState(cfg, scfg, session.cache_len, ref.n_steps, torch.bfloat16,
                   torch.bfloat16, session.device, session.kv_quant)
    t = prompt.shape[1]
    bucket = session._bucket(t)
    st.prompt(bucket)[0, :, :t].copy_(torch.from_numpy(prompt))
    st.t_end.fill_(t)
    st.seed.fill_(seed)
    st.sampling.copy_(torch.tensor(sampling, dtype=torch.float32))
    if audio is not None:
        feats, mask = st.features(bucket)
        feats[0, :t].copy_(torch.from_numpy(audio[0]))
        mask[0, :t].copy_(torch.from_numpy(audio[1]))
    prefill_body(session.params, cfg, scfg, st, bucket, audio is not None)
    cols = [st.token.clone()]
    left, n = budget - 1, session.first_chunk_size
    while left > 0:
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
        got = session.generate(prompt, 1, max_new_tokens=11, top_k=1)
        launched = flash_decode_attention.launches - n0
        want = _eager_stream(session, prompt, 11, (1.0, 0.9, 1), 1)
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
    """Replayed after `pos`, `token` (and the window, seed and draw) change
    in place, the decode graph gives an eager step's column and cache row
    there."""
    from fish_speech_tpu_torch.generate import StepState, decode_step

    session = _graph_session(dev, kind)
    cfg, st = session.cfg, session.state
    session.generate(_graph_prompt(cfg, 60, seed=3), 2,
                     max_new_tokens=7, top_k=30)
    rng = np.random.default_rng(4)
    st.pos.fill_(97)
    st.token.copy_(torch.from_numpy(_graph_prompt(cfg, 1, seed=5)[:, 0][None]))
    st.window.copy_(torch.from_numpy(rng.integers(
        cfg.semantic_begin_id, cfg.semantic_begin_id + 50, st.window.shape)))
    st.seed.fill_(9)
    st.draw.fill_(13)
    st.step.fill_(1)
    ref = StepState(cfg, session.scfg, session.cache_len, st.n_steps,
                    torch.bfloat16, torch.bfloat16, dev, session.kv_quant)
    for name in ("token", "pos", "window", "step", "seed", "draw", "sampling"):
        getattr(ref, name).copy_(getattr(st, name))
    for name, t in st.cache.items():
        ref.cache[name].copy_(t)
    decode_step(session.params, cfg, session.scfg, ref)
    session._run("decode")
    torch.cuda.synchronize()
    assert torch.equal(st.cols[1], ref.cols[1])
    assert int(st.pos) == 98 and int(st.step) == 2 and int(st.draw) == 14
    for name, t in st.cache.items():
        assert torch.equal(t[:, :, 97], ref.cache[name][:, :, 97]), name


@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_seeded_codes_do_not_depend_on_chunk_sizes_cuda(dev, kind):
    """ROADMAP §3's fault, repaired on the card: the same seed through
    graphed sessions with other (first_chunk_size, decode_chunk_size) pairs
    gives the same sampled codes."""
    runs = []
    for first, chunk in ((2, 4), (3, 5)):
        session = _graph_session(dev, kind, first_chunk_size=first,
                                 decode_chunk_size=chunk)
        prompt = _graph_prompt(session.cfg, 50, seed=6)
        runs.append(session.generate(prompt, 21, max_new_tokens=19,
                                     temperature=0.8, top_p=0.9, top_k=30))
        assert session.replays["decode"] >= 18
    np.testing.assert_array_equal(runs[0], runs[1])


def _suffix_cache(dev, kv8, dtype, b=2, s=320, hkv=2, d=64, layers=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (layers, b, s, hkv, d)
    if kv8:
        return {"k": torch.from_numpy(rng.integers(-127, 128, shape)).to(torch.int8).to(dev),
                "v": torch.from_numpy(rng.integers(-127, 128, shape)).to(torch.int8).to(dev),
                "ks": torch.from_numpy(rng.uniform(0.005, 0.02, shape[:4])).to(dev, torch.bfloat16),
                "vs": torch.from_numpy(rng.uniform(0.005, 0.02, shape[:4])).to(dev, torch.bfloat16)}
    return {n: torch.from_numpy(rng.normal(size=shape)).to(dev, dtype) for n in "kv"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("start,ts,d", [(0, 64, 64), (151, 64, 128),
                                        (37, 130, 128), (255, 1, 64)])
def test_flash_suffix_matches_plain(dev, dtype, kv8, start, ts, d):
    """The suffix kernels (every route: bf16 tensor cores, fp32 CUDA cores,
    plain and int8 cache) against their plain version at ragged starts and
    lengths; the start is read from device memory, so a CUDA graph of one
    launch replayed at another start gives that start's output."""
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    cache = _suffix_cache(dev, kv8, dtype, d=d, seed=start + ts)
    rng = np.random.default_rng(ts)
    q = torch.from_numpy(rng.normal(size=(2, ts, 8, d))).to(dev, dtype)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    fp.reset_launches()
    got = fp.flash_suffix_attention(q, cache, 1, st)
    torch.cuda.synchronize()
    want = fp.flash_suffix_reference(q, cache, 1, st)
    route = fp._suffix_route(dtype, kv8)
    assert getattr(fp.flash_suffix_attention, f"launches_{route}") == 1
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:
        assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    graph = torch.cuda.CUDAGraph()
    out = {}
    with torch.cuda.graph(graph):
        out["y"] = fp.flash_suffix_attention(q, cache, 1, st)
    st.fill_(max(start - 17, 0))
    graph.replay()
    torch.cuda.synchronize()
    again = fp.flash_suffix_attention(q, cache, 1, st)
    assert torch.equal(out["y"], again)


def test_flash_suffix_refuses_what_the_kernels_do_not_take(dev):
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    cache = _suffix_cache(dev, True, torch.bfloat16)
    q = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16, device=dev)
    st = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="start"):
        fp.flash_suffix_attention(q, cache, 0, st.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        fp.flash_suffix_attention(q, cache, 0, st.cpu())
    with pytest.raises(TypeError):  # fp16 has a form; float64 none
        fp.flash_suffix_attention(q.double(), cache, 0, st)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("b,ts", [(1, 64), (1, 128), (4, 64), (16, 64)])
def test_split_suffix_kernel_at_serving_shapes(dev, dtype, kv8, b, ts):
    """The tensor-core suffix kernel (G heads packed per block, the keys
    split over `suffix_plan`'s slices and merged in the launch) at the
    serving cache's shapes (S = 2176, H = 32, Hkv = 8, D = 128, start 951)
    against its plain version, to the bounds above; the same bits twice
    and from a CUDA graph replayed at the same start; one launch a call."""
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    cache = _suffix_cache(dev, kv8, dtype, b=b, s=2176, hkv=8, d=128, seed=b + ts)
    rng = np.random.default_rng(ts + b)
    q = torch.from_numpy(rng.normal(size=(b, ts, 32, 128))).to(dev, dtype)
    st = torch.tensor([951], dtype=torch.int32, device=dev)
    fp.reset_launches()
    got = fp.flash_suffix_attention(q, cache, 1, st)
    again = fp.flash_suffix_attention(q, cache, 1, st)
    torch.cuda.synchronize()
    assert fp.flash_suffix_attention.launches == 2
    assert torch.equal(got, again)
    err = (got.float() - fp.flash_suffix_reference(q, cache, 1, st).float()).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    graph = torch.cuda.CUDAGraph()
    out = {}
    with torch.cuda.graph(graph):
        out["y"] = fp.flash_suffix_attention(q, cache, 1, st)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], got)


@pytest.mark.parametrize("b,plan", [(1, (64, 7, 5)), (16, (64, 9, 4)), (16, (128, 4, 9))])
def test_split_suffix_kv8_ring_under_load(dev, b, plan):
    """The int8-cache suffix kernel at split plans (rows a block, Z, tiles
    a slice; 64 rows: the warpgroups take the tiles in turn, each waiting on
    the full barriers of the ring's stages by parity) replayed 4096 times
    from a CUDA graph while another stream copies 512 MiB buffers: every
    launch's output has the bits of the first call's, which holds to the
    plain version. A consumer that read a stage a phase early would
    convert a tile still landing, or trap at its barrier."""
    from fish_speech_tpu_torch.ops import flash_prefill as fp
    from fish_speech_tpu_torch.ops._kernels import DTYPE_CODES, load_kernels

    rows, n_split, per = plan
    ts, h, hkv, d, s = 64, 32, 8, 128, 2176
    cache = _suffix_cache(dev, True, torch.bfloat16, b=b, s=s, hkv=hkv, d=d, seed=b)
    rng = np.random.default_rng(b)
    q = torch.from_numpy(rng.normal(size=(b, ts, h, d))).to(dev, torch.bfloat16)
    st = torch.tensor([951], dtype=torch.int32, device=dev)
    tiles = b * hkv * fp.suffix_row_tiles(ts, h // hkv, rows)
    work = torch.empty(n_split * tiles * rows * (2 + d), dtype=torch.float32, device=dev)
    counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    lib = load_kernels()
    kv_layer, sc_layer = b * s * hkv * d, b * s * hkv * 2
    n_call = 64
    outs = torch.empty((n_call,) + q.shape, dtype=q.dtype, device=dev)

    def call(out):
        rc = lib.fs_flash_suffix(
            q.data_ptr(), cache["k"].data_ptr() + kv_layer, cache["v"].data_ptr() + kv_layer,
            cache["ks"].data_ptr() + sc_layer, cache["vs"].data_ptr() + sc_layer,
            st.data_ptr(), out.data_ptr(), work.data_ptr(), counters.data_ptr(), b, ts, h,
            hkv, d, s, DTYPE_CODES[q.dtype], 1, rows, n_split, per, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0

    call(outs[0])
    torch.cuda.synchronize()
    first = outs[0].clone()
    err = (first.float() - fp.flash_suffix_reference(q, cache, 1, st).float()).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_call):
            call(outs[i])
    src = torch.empty(2 ** 27, dtype=torch.float32, device=dev).normal_()
    dst = torch.empty_like(src)
    side = torch.cuda.Stream(dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(4096 // n_call):
        begun = torch.cuda.Event()
        begun.record()
        with torch.cuda.stream(side):
            side.wait_event(begun)
            for _ in range(4):
                dst.copy_(src)
        graph.replay()
        bad += (outs != first).flatten(1).any(1).sum()
    torch.cuda.synchronize()
    assert int(bad) == 0
    assert int(counters.abs().sum()) == 0  # the kernel leaves the counters 0


@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_graphed_prefix_hits_replay_the_suffix_graph(dev, kind):
    """A graphed session with the prefix cache: requests that share a
    stored prefix are `suffix_64` replays (captured ahead by `precompile`,
    no other eager run), which launch the suffix kernel once per slow
    layer; a repeated hit gives identical codes, and the stored entry is
    unchanged by the requests after it."""
    cfg = _graph_cfg()
    warm = _graph_session(dev, kind, prefix_cache_size=2)
    head = _graph_prompt(cfg, 140, seed=1)
    prompts = [np.concatenate([head, _graph_prompt(cfg, n, seed=10 + n)], axis=1)
               for n in (12, 20, 20)]
    prompts[2] = prompts[1]
    times = warm.precompile(152, 11, suffix_buckets=(1,))
    assert "suffix_64" in times
    runs = []
    for i, p in enumerate(prompts):
        runs.append(warm.generate(p, 5, max_new_tokens=11, temperature=0.8,
                                  top_p=0.9, top_k=30))
        if i == 0:
            (entry,) = warm.prefix._store.values()
            saved = {n: r.clone() for n, r in entry["rows"].items()}
    np.testing.assert_array_equal(runs[1], runs[2])
    assert warm.prefix_hits == 2 and warm.replays["suffix_64"] == 2
    assert warm.eager_runs["suffix_64"] == 1  # its capture's warm-up only
    per = warm.launches_per_replay("suffix_64")
    route = "suffix_kv8_wgmma" if kind == "mixed" else "suffix_wgmma"
    assert per[f"flash_suffix_attention.launches_{route}"] == cfg.n_layer
    for n, r in entry["rows"].items():
        assert torch.equal(r, saved[n]), n


def test_repeated_seed_gives_identical_codes(dev):
    session = _graph_session(dev, "bf16")
    prompt = _graph_prompt(session.cfg, 50, seed=6)
    runs = [session.generate(prompt, s, max_new_tokens=15,
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


def _graph_pool(dev, kind, scfg=None, **kw):
    """`_graph_session`'s small model behind a `ContinuousBatcher` on the
    card: "bf16", or "int8" weights with the int8 KV cache."""
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.engine.batcher import ContinuousBatcher
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _graph_cfg()
    params = init_dual_ar(7, cfg, torch.bfloat16, dev)
    if kind == "int8":
        params = quantize_dual_ar_lowmem(params, mode="int8")
    kw = {"pool_size": 4, "decode_chunk_size": 8, "first_chunk_size": 2, **kw}
    return ContinuousBatcher(params, cfg, scfg or SamplingConfig(),
                             dtype=torch.bfloat16, kv_quant=kind == "int8", **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_pool_step_graph_replay_equals_the_eager_body(dev, kind):
    """After a few sampled requests, with ragged positions, some rows
    inactive and new tokens written in place, one replay of the pool's step
    graph gives what an eager run of `pool_decode_step` on a copy of the
    buffers gives, bit for bit: columns, carried state and the cache."""
    from fish_speech_tpu_torch.generate import PoolState, pool_decode_step

    b = _graph_pool(dev, kind)
    try:
        assert set(b.precompile((64,))) == {"decode", "prefill_4_64", "prefill_1_64"}
        cfg, st = b.cfg, b.state
        for i in range(3):
            b.generate(_graph_prompt(cfg, 30 + 7 * i, seed=i), seed=i,
                       max_new_tokens=9, top_k=30)
        b._state_lock.acquire()  # the worker stays idle from here on
        rng = np.random.default_rng(5)
        st.pos.copy_(torch.tensor([40, 97, 3, 120], device=dev))
        st.active.copy_(torch.tensor([True, False, True, True], device=dev))
        st.token.copy_(torch.from_numpy(np.stack(
            [_graph_prompt(cfg, 1, seed=s)[:, 0] for s in range(4)])))
        st.seed.copy_(torch.tensor([3, 4, 5, 6], device=dev))
        st.step.fill_(1)
        st.window.copy_(torch.from_numpy(rng.integers(
            cfg.semantic_begin_id, cfg.semantic_begin_id + 50, st.window.shape)))
        ref = PoolState(cfg, b.scfg, 4, b.cache_len, st.cols.shape[0],
                        torch.bfloat16, torch.bfloat16, dev, b.kv_quant)
        for name in ("token", "pos", "window", "active", "seed", "draw",
                     "sampling", "step", "cols"):
            getattr(ref, name).copy_(getattr(st, name))
        for name, t in st.cache.items():
            ref.cache[name].copy_(t)
        with torch.no_grad():
            pool_decode_step(b.params, cfg, b.scfg, ref)
            b._run("decode")
        torch.cuda.synchronize()
        for name in ("cols", "token", "pos", "window", "active", "draw", "step"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
        for name, t in st.cache.items():
            assert torch.equal(t, ref.cache[name]), name
        b._state_lock.release()
    finally:
        b.shutdown()


def test_pool_sampled_codes_do_not_depend_on_traffic_or_chunks(dev):
    """A sampled request gives the same codes alone, inside a burst of
    five, and in a pool that cuts its steps into other chunks (sub-chunks
    of 3 after a first chunk of 5 against 4 after 2): CUDA's Philox
    generator would draw other numbers for other chunk cuts; the pool's
    counter-based uniforms do not."""
    import threading

    prompts = [_graph_prompt(_graph_cfg(), 25 + 6 * i, seed=i) for i in range(5)]
    kw = dict(max_new_tokens=23, temperature=0.8, top_p=0.9, top_k=30)
    runs = {}
    for name, pool_kw in (("a", dict(admit_every=4)),
                          ("b", dict(admit_every=3, first_chunk_size=5,
                                     decode_chunk_size=12))):
        b = _graph_pool(dev, "bf16", **pool_kw)
        try:
            b.precompile((64,))
            alone = b.generate(prompts[0], seed=77, **kw)
            burst = [None] * 5

            def go(i):
                burst[i] = b.generate(prompts[i], seed=77 if i == 0 else i, **kw)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not b.eager_runs.get("decode", 0) > 1
            runs[name] = (alone, burst[0])
        finally:
            b.shutdown()
    np.testing.assert_array_equal(runs["a"][0], runs["a"][1])
    np.testing.assert_array_equal(runs["a"][0], runs["b"][0])
    np.testing.assert_array_equal(runs["a"][0], runs["b"][1])
    assert runs["a"][0].shape[1] > 3


def test_codec_capture_while_the_pool_replays_goes_through_the_guard(dev):
    """A codec graph captured at first use from a request thread while the
    batcher's worker replays its step graph: the capture waits for the
    worker's launching sections (`generate.GUARD`), completes, and equals
    an eager run of its body; the pooled request is unharmed (the same
    codes as with no capture beside it)."""
    import threading

    from fish_speech_tpu_torch.config import SamplingConfig, dac_tiny
    from fish_speech_tpu_torch.engine.batcher import BatchRequest
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
    from fish_speech_tpu_torch.models.dac.model import dac_from_indices, init_dac

    b = _graph_pool(dev, "bf16", scfg=SamplingConfig(mask_im_end=True))
    try:
        b.precompile((64,))
        cfg = dac_tiny()
        engine = TTSInferenceEngine(None, None, init_dac(5, cfg, device=dev), cfg)
        prompt = _graph_prompt(b.cfg, 40, seed=9)
        quiet = b.generate(prompt, seed=5, max_new_tokens=200, top_k=30)
        req = BatchRequest(prompt=prompt, seed=5, max_new_tokens=200, top_k=30)
        out = b.submit(req)
        chunks = [out.get(timeout=120), out.get(timeout=120)]
        assert b.stats()["active_slots"] == 1  # the worker is replaying
        codes = np.random.default_rng(3).integers(
            0, cfg.rvq.codebook_size, (cfg.rvq.total_codebooks, 50)).astype(np.int32)
        audio = engine.decode_vq_tokens(codes)  # captured here, at first use
        assert dict(engine.codec_eager_runs) == {("decode", 1, 64): 1}
        while (item := out.get(timeout=120)) is not None:
            chunks.append(item)
        np.testing.assert_array_equal(np.concatenate(chunks).T, quiet)
        padded = torch.zeros((1, cfg.rvq.total_codebooks, 64), dtype=torch.int32,
                             device=dev)
        padded[0, :, :50] = torch.from_numpy(codes)
        with torch.no_grad():
            eager = dac_from_indices(engine.codec_params, cfg, padded)
        np.testing.assert_array_equal(audio, eager[0, 0, : 50 * cfg.frame_length]
                                      .cpu().numpy())
        assert not b.eager_runs.get("decode", 0) > 1
    finally:
        b.shutdown()


def test_pool_prefill_graph_captured_after_a_longer_bucket(dev):
    """One scratch per group size serves every bucket: a bucket-64 prefill
    graph captured at first use after a bucket-128 group ran (its t_end of
    100 still in the scratch) captures and serves the request as a batcher
    that precompiled bucket 64 does."""
    cfg = _graph_cfg()
    short = _graph_prompt(cfg, 30, seed=2)
    outs = []
    for buckets, first in (((128,), _graph_prompt(cfg, 100, seed=1)), ((64,), None)):
        b = _graph_pool(dev, "bf16", pool_size=1)
        try:
            b.precompile(buckets)
            if first is not None:
                b.generate(first, seed=1, max_new_tokens=5, top_k=1)
            outs.append(b.generate(short, seed=2, max_new_tokens=7, top_k=1))
            assert b.replays["prefill_1_64"] == 1 and b.eager_runs["prefill_1_64"] == 1
        finally:
            b.shutdown()
    np.testing.assert_array_equal(outs[0], outs[1])


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _serve_group(b, prompts, seed0):
    """The greedy columns of `prompts`, submitted while the worker waits on
    the batcher's lock, so that one admission pass takes them all: one
    group."""
    from fish_speech_tpu_torch.engine.batcher import BatchRequest

    reqs = [BatchRequest(prompt=p, seed=seed0 + j, max_new_tokens=9, top_k=1)
            for j, p in enumerate(prompts)]
    with b._state_lock:
        outs = [b.submit(r) for r in reqs]
    cols = []
    for out in outs:
        chunks = []
        while (item := out.get(timeout=300)) is not None:
            assert not isinstance(item, BaseException), item
            chunks.append(item)
        cols.append(np.concatenate(chunks).T)
    return cols


@pytest.mark.parametrize("kv_quant", [False, True])
def test_pool_graphed_prefix_hit_gives_the_cpu_batchers_greedy_codes(dev, kv_quant):
    """A same-prefix group of four through the batcher's graphed hit path
    (the stored row restored into every row of the signature's scratch,
    the start written through a pinned buffer, `suffix_4_64` replayed)
    gives the greedy codes the same batcher gives on the CPU, where every
    body runs eagerly: a small fp32 model over a plain and an int8 cache.
    On the card the hit graph was captured by `precompile`, and the group
    served twice gives the same codes both times."""
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.engine.batcher import ContinuousBatcher
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar

    cfg = _graph_cfg()
    params = init_dual_ar(7, cfg, torch.float32, "cpu")
    # the stored prompt has 128 columns; the group shares its first 64, and
    # prefix plus the 64-bucket suffix fit the stored bucket 128
    head = _graph_prompt(cfg, 64, seed=1)
    first = np.concatenate([head, _graph_prompt(cfg, 64, seed=2)], axis=1)
    group = [np.concatenate([head, _graph_prompt(cfg, n, seed=20 + n)], axis=1)
             for n in (20, 33, 47, 60)]
    runs = {}
    for d in ("cpu", dev):
        b = ContinuousBatcher(_tree_to(params, d), cfg, SamplingConfig(),
                              pool_size=4, dtype=torch.float32,
                              decode_chunk_size=8, first_chunk_size=2,
                              kv_quant=kv_quant, prefix_cache_size=4)
        try:
            captured = b.precompile()
            _serve_group(b, [first], 3)
            runs[d] = [_serve_group(b, group, 5) for _ in range(2)]
            assert b.prefix.hits == 2 and b.prefix.misses == 1
            if d != "cpu":
                assert {"suffix_4_64", "suffix_4_128", "suffix_1_64"} <= set(captured)
                assert b.replays["suffix_4_64"] == 2
                assert set(b.eager_runs.values()) == {1}  # the captures' only
        finally:
            b.shutdown()
    for a, c in zip(runs[dev][0], runs[dev][1]):
        np.testing.assert_array_equal(a, c)
    for a, c in zip(runs[dev][0], runs["cpu"][0]):
        np.testing.assert_array_equal(a, c)
    assert min(a.shape[1] for a in runs[dev][0]) > 1


# the int8 products at decode (I, O, layout): s2-pro's slow and fast stacks
# (w13 fused), the full LM head, the semantic head (S + 1 columns, rows 16
# bytes apart as `precompute_semantic_head` lays them out), the fast head;
# then ragged shapes: rows not 16 bytes apart (the block's own copy in place
# of TMA), O under one 128-column box, I not a whole stage, I off 8
INT8_SHAPES = [
    (2560, 6144, "contiguous"), (4096, 2560, "contiguous"),
    (2560, 19456, "contiguous"), (9728, 2560, "contiguous"),
    (1536, 2560, "contiguous"), (1536, 1536, "contiguous"),
    (1536, 12288, "contiguous"), (6144, 1536, "contiguous"),
    (2560, 155136, "contiguous"), (2560, 4097, "padded"),
    (1536, 4096, "contiguous"),
    (2560, 4097, "contiguous"), (1000, 72, "contiguous"),
    (300, 4097, "padded"), (1000, 1000, "contiguous"), (1001, 200, "padded"),
    (130, 260, "contiguous"),
]


def _int8_weight(i, o, layout, seed, dev):
    """q (I, O) int8 and s (O,) fp32 on the card; "padded": q a view of an
    (I, O rounded up to 16) buffer."""
    gen = torch.Generator().manual_seed(seed)
    width = o + (-o % 16 if layout == "padded" else 0)
    q = torch.randint(-127, 128, (i, width), generator=gen, dtype=torch.int8).to(dev)
    s = (torch.rand(o, generator=gen) * 0.02 + 0.001).to(dev)
    return q[:, :o], s


@pytest.mark.parametrize("i,o,layout", INT8_SHAPES)
def test_int8_kernel_matches_plain(dev, i, o, layout):
    rng = np.random.default_rng(i + o)
    q, s = _int8_weight(i, o, layout, i * o, dev)
    assert q.stride(0) % 16 == 0 or layout == "contiguous"
    qf = q.float()
    qa = qf.abs()
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4, 16, 32):
            x = _randn(rng, (b, i), dtype, dev)
            route = f"launches_{int8_route(b, dtype)}"
            n0, r0 = int8_matmul.launches, getattr(int8_matmul, route)
            got = int8_matmul(x, q, s)
            torch.cuda.synchronize()
            assert int8_matmul.launches == n0 + 1 and got.dtype == dtype
            assert getattr(int8_matmul, route) == r0 + 1
            exact = (x.float() @ qf) * s  # the plain version in fp32, not rounded
            scale = (x.float().abs() @ qa) * s
            err = (got.float() - exact).abs()
            if dtype == torch.float32:
                assert bool((err <= 1e-5 * scale + 1e-6).all()), (b, err.max().item())
            else:
                bound = 2.0 ** -8 * exact.abs() + 1e-5 * scale
                assert bool((err <= bound).all()), (b, err.max().item())
            # the route `mm` takes for up to 32 rows
            assert torch.equal(mm(x[:, None], {"q": q, "s": s})[:, 0], got)
            del exact, scale, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_int8_kernel_launches_once_and_allocates_only_the_output(dev, dtype):
    rng = np.random.default_rng(4)
    for b, i, o in [(1, 2560, 19456), (32, 4096, 2560), (1, 2560, 4097)]:
        q, s = _int8_weight(i, o, "padded", 5, dev)
        x = _randn(rng, (b, i), dtype, dev)
        route = f"launches_{int8_route(b, dtype)}"
        _, launched, made = _one_call(
            lambda: int8_matmul(x, q, s),
            [(int8_matmul, "launches"), (int8_matmul, route)])
        assert launched == [1, 1] and made == 1  # the output only


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_int8_kernel_is_deterministic_and_graph_capturable(dev, dtype):
    """Two calls give the same bits (the runs are added in one order); a
    CUDA graph of the call replayed after x changes in place equals the
    eager call on the new x. Slow wo at 32 rows: the cluster kernel, its 4
    runs summed in the cluster's shared memory."""
    rng = np.random.default_rng(12)
    q, s = _int8_weight(4096, 2560, "contiguous", 7, dev)
    x = _randn(rng, (32, 4096), dtype, dev)
    first, second = int8_matmul(x, q, s), int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    n0 = int8_matmul.launches
    with torch.cuda.graph(graph):
        captured = int8_matmul(x, q, s)
    x.copy_(_randn(rng, x.shape, x.dtype, dev))
    graph.replay()
    torch.cuda.synchronize()
    assert int8_matmul.launches == n0 + 1
    assert torch.equal(captured, int8_matmul(x, q, s))
    assert not torch.equal(captured, first)


# the cluster plans' cases (name, I, O, layout): one block a tile (266
# tiles), the largest cluster (fast wo: clusters of 8), the semantic head's
# padded rows, and the block-copied layouts (rows not 16 bytes apart; I
# off 8, so x is copied too)
INT8_PLAN_CASES = [("single block", 256, 34048, "contiguous"),
                   ("largest cluster", 1536, 1536, "contiguous"),
                   ("padded semantic head", 2560, 4097, "padded"),
                   ("block-copied q", 2560, 4097, "contiguous"),
                   ("block-copied q and x", 1001, 200, "padded")]


def _int8_close(got, x, q, s):
    """bf16 within 2^-8 |y| + 1e-5 (|x| @ |q|) * s of the exact product."""
    exact = (x.float() @ q.float()) * s
    scale = (x.float().abs() @ q.float().abs()) * s
    err = (got.float() - exact).abs()
    assert bool((err <= 2.0 ** -8 * exact.abs() + 1e-5 * scale).all()), err.max().item()


@pytest.mark.parametrize("name,i,o,layout", INT8_PLAN_CASES)
def test_int8_kernel_cluster_plans(dev, name, i, o, layout):
    from fish_speech_tpu_torch.ops.int8 import int8_gemv_plan

    rng = np.random.default_rng(i + 3 * o)
    q, s = _int8_weight(i, o, layout, i + o, dev)
    want = {"single block": 1, "largest cluster": 8}.get(name)
    for b in (5, 27):
        route = int8_route(b, torch.bfloat16)
        assert route == ("gemv_cluster" if b == 27 else "gemv_mma")
        if b == 27:
            cluster, _ = int8_gemv_plan(b, i, o, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            assert want is None or cluster == want, cluster
        x = _randn(rng, (b, i), torch.bfloat16, dev)
        n0 = getattr(int8_matmul, f"launches_{route}")
        got = int8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert getattr(int8_matmul, f"launches_{route}") == n0 + 1
        _int8_close(got, x, q, s)
        assert torch.equal(got, int8_matmul(x, q, s))


@pytest.mark.parametrize("b", [1, 5, 27, 32])
def test_int8_kernel_every_cluster_size(dev, b):
    """The cluster kernel's C entry point at each cluster size it takes,
    runs of whole stages and a run past I (cluster 8 over 15 stages): each
    within the bound, the same bits twice."""
    from fish_speech_tpu_torch.ops._kernels import (check_launch, load_kernels,
                                                    stream_ptr)

    rng = np.random.default_rng(b)
    i, o = 960, 640
    q, s = _int8_weight(i, o, "contiguous", 9, dev)
    x = _randn(rng, (b, i), torch.bfloat16, dev)
    stages = -(-i // 64)
    for cluster in (1, 2, 4, 8):
        run = -(-stages // cluster) * 64

        def call():
            out = torch.empty((b, o), dtype=torch.bfloat16, device=dev)
            check_launch(load_kernels().fs_int8_matmul_cluster(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), b, i, o,
                q.stride(0), cluster, run, stream_ptr(x)), "int8_matmul (gemv_cluster)")
            return out

        got = call()
        torch.cuda.synchronize()
        _int8_close(got, x, q, s)
        assert torch.equal(got, call()), cluster


def test_mm_routes_int8_products_by_rows(dev):
    """Up to 32 rows go to the int8 kernel (both dtypes), more to torch's
    cast; the decode graphs of a `mixed` session launch only the kernel."""
    rng = np.random.default_rng(1)
    q, s = _int8_weight(256, 192, "contiguous", 3, dev)
    for shape, dtype, kernel in [((1, 1, 256), torch.bfloat16, True),
                                 ((32, 1, 256), torch.bfloat16, True),
                                 ((4, 1, 256), torch.float32, True),
                                 ((2, 64, 256), torch.bfloat16, False),
                                 ((33, 256), torch.float32, False)]:
        before = (int8_matmul.launches, mm.launches_int8_matmul, mm.launches_int8_cast)
        y = mm(_randn(rng, shape, dtype, dev), {"q": q, "s": s})
        torch.cuda.synchronize()
        assert y.shape == (*shape[:-1], 192) and y.dtype == dtype
        assert (int8_matmul.launches - before[0], mm.launches_int8_matmul - before[1],
                mm.launches_int8_cast - before[2]) == ((1, 1, 0) if kernel else (0, 0, 1))
    session = _graph_session(dev, "mixed")
    session.precompile(40, 8, 2)
    per_step = session.launches_per_replay("decode")
    assert per_step.get("int8_matmul.launches_gemv_mma", 0) > 0, per_step
    assert per_step.get("mm.launches_int8_cast", 0) == 0, per_step
    # the prefill: its layers' 64 rows through the cast, its heads' one row
    # (the LM head, the fast head of the first column) through the kernel
    prefill = session.launches_per_replay("prefill_64")
    assert prefill.get("int8_matmul.launches_gemv_mma", 0) >= 1, prefill
    assert prefill.get("mm.launches_int8_cast", 0) == 4 * session.cfg.n_layer, prefill


# the int8 FFNs (D, I): s2-pro's slow and fast stacks, the graph tests'
# small model, a ragged I (phase A's last tile part past I)
FFN_SHAPES = [(2560, 9728), (1536, 6144), (256, 512), (128, 400)]


def _ffn_weights(d, i, seed, dev):
    """The fused w13 {"q": (D, 2I), "s": (2I,)} and w2 {"q": (I, D), "s":
    (D,)}: random int8, scales that keep u and y near unit size."""
    gen = torch.Generator().manual_seed(seed)
    q13 = torch.randint(-127, 128, (d, 2 * i), generator=gen, dtype=torch.int8)
    q2 = torch.randint(-127, 128, (i, d), generator=gen, dtype=torch.int8)
    s13 = (torch.rand(2 * i, generator=gen) + 0.5) / (73.0 * d ** 0.5)
    s2 = (torch.rand(d, generator=gen) + 0.5) / (73.0 * i ** 0.5)
    return ({"q": q13.to(dev), "s": s13.to(dev)}, {"q": q2.to(dev), "s": s2.to(dev)})


def _ffn_close(got, want, dtype):
    """bf16: 2 ulps of max |y| (2^-6 of the largest power of 2 below it);
    fp32: 1e-5 of max |y|."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    bound = 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-5 * top
    assert err <= bound, (err, bound, top)


@pytest.mark.parametrize("d,i", FFN_SHAPES)
def test_int8_ffn_kernel_matches_plain(dev, d, i):
    from fish_speech_tpu_torch.models.dual_ar import _ffn

    rng = np.random.default_rng(d + i)
    w13, w2 = _ffn_weights(d, i, d * i, dev)
    pair = ({"q": w13["q"][:, :i].contiguous(), "s": w13["s"][:i].contiguous()},
            {"q": w13["q"][:, i:].contiguous(), "s": w13["s"][i:].contiguous()})
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4, 16, 32):
            x = _randn(rng, (b, d), dtype, dev)
            route = f"launches_{ffn_route(b, dtype)}"
            n0, r0 = int8_ffn.launches, getattr(int8_ffn, route)
            got = int8_ffn(x, w13, w2)
            torch.cuda.synchronize()
            assert int8_ffn.launches == n0 + 1 and got.dtype == dtype
            assert getattr(int8_ffn, route) == r0 + 1
            assert bool(torch.isfinite(got).all())
            _ffn_close(got, int8_ffn_reference(x, w13, w2), dtype)
            # the split form and the model's route: the same kernel, the same bits
            assert torch.equal(int8_ffn(x, pair, w2), got)
            assert torch.equal(_ffn({"w13": w13, "w2": w2}, (0,) * 5, x[:, None])[:, 0], got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_int8_ffn_launches_once_and_allocates_only_the_output(dev, dtype):
    rng = np.random.default_rng(4)
    for b, d, i in [(1, 2560, 9728), (32, 1536, 6144)]:
        w13, w2 = _ffn_weights(d, i, 5, dev)
        x = _randn(rng, (b, d), dtype, dev)
        route = f"launches_{ffn_route(b, dtype)}"
        _, launched, made = _one_call(lambda: int8_ffn(x, w13, w2),
                                      [(int8_ffn, "launches"), (int8_ffn, route)])
        assert launched == [1, 1] and made == 1  # the output only


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("b", [1, 32])
def test_int8_ffn_is_deterministic_and_graph_capturable(dev, dtype, b):
    """Two calls give the same bits (runs added in one order, no atomics on
    data); a CUDA graph of the call replayed twice gives the same bits, and
    after x changes in place it equals the eager call on the new x. The
    slow FFN: both phases split, the grid barrier and the tile counters
    reused by every replay."""
    rng = np.random.default_rng(12 + b)
    w13, w2 = _ffn_weights(2560, 9728, 7, dev)
    x = _randn(rng, (b, 2560), dtype, dev)
    first, second = int8_ffn(x, w13, w2), int8_ffn(x, w13, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    n0 = int8_ffn.launches
    with torch.cuda.graph(graph):
        captured = int8_ffn(x, w13, w2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    x.copy_(_randn(rng, x.shape, x.dtype, dev))
    graph.replay()
    again = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert int8_ffn.launches == n0 + 1
    assert torch.equal(captured, again)
    assert torch.equal(captured, int8_ffn(x, w13, w2))
    assert not torch.equal(captured, first)


def test_int8_ffn_check_refuses_on_the_card(dev):
    w13, w2 = _ffn_weights(256, 512, 1, dev)
    x = torch.zeros(2, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="rows"):
        int8_ffn(torch.zeros(33, 256, dtype=torch.bfloat16, device=dev), w13, w2)
    with pytest.raises(TypeError):  # fp16 has a form; float64 none
        int8_ffn(x.double(), w13, w2)
    with pytest.raises(ValueError, match="16-byte"):  # x off a 16-byte boundary
        int8_ffn(torch.zeros(2 * 256 + 1, dtype=torch.bfloat16, device=dev)[1:].view(2, 256),
                 w13, w2)
    small13, small2 = _ffn_weights(64, 128, 1, dev)
    with pytest.raises(ValueError, match="TMA"):  # bf16 below one 128-byte box
        int8_ffn(torch.zeros(1, 64, dtype=torch.bfloat16, device=dev), small13, small2)
    # the fp32 route takes them
    y = int8_ffn(torch.ones(1, 64, device=dev), small13, small2)
    torch.cuda.synchronize()
    _ffn_close(y, int8_ffn_reference(torch.ones(1, 64, device=dev), small13, small2),
               torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        int8_ffn(x, w13, {"q": w2["q"].cpu(), "s": w2["s"]})


def test_decode_graphs_run_every_int8_ffn_on_the_fused_kernel(dev):
    """The `mixed` session's replayed step: one fused FFN per slow layer
    (the fast stack is int4); the int8 pool's: one per slow layer and per
    fast layer of every codebook column; neither casts an int8 weight."""
    session = _graph_session(dev, "mixed")
    session.precompile(40, 8, 2)
    cfg = session.cfg
    per_step = session.launches_per_replay("decode")
    assert per_step.get("int8_ffn.launches_mma", 0) == cfg.n_layer, per_step
    assert per_step.get("mm.launches_int8_cast", 0) == 0, per_step
    del session
    b = _graph_pool(dev, "int8")
    try:
        b.precompile((64,))
        per_step = b.launches_per_replay("decode")
        want = cfg.n_layer + cfg.n_fast_layer * cfg.num_codebooks
        assert per_step.get("int8_ffn.launches_mma", 0) == want, per_step
        assert per_step.get("mm.launches_int8_cast", 0) == 0, per_step
    finally:
        b.shutdown()


# the decode kernels with per-row starts (the lockstep batch's left pad):
# S = 4160 at 8 KV heads splits into slices of 256 (`decode_slice`), so a
# start of 700 leaves two slices wholly before it and starts inside the
# third; 5 and 17 start inside a 16-position tile; S = 2112 is the serving
# session's slow cache at B = 4
STARTS_CASES = [
    (4160, 8, 4, 128, [257, 40, 4000], [5, 17, 700]),
    (4160, 8, 4, 128, [1, 4160, 513], [0, 4159, 256]),
    (2112, 8, 4, 128, [2048, 701, 1, 1500], [700, 3, 0, 1499]),
    (300, 2, 8, 64, [33, 100, 300], [1, 17, 299]),
    (96, 4, 3, 128, [96, 40], [80, 39]),
]


def _starts_inputs(rng, kv8, dtype, s, hkv, g, d, lengths, starts, dev):
    b = len(lengths)
    q = _randn(rng, (b, hkv, g, d), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sts = torch.tensor(starts, dtype=torch.int32, device=dev)
    if kv8:
        k, ks = _kv_quant(_randn(rng, (1, b, s, hkv, d), torch.float32, dev))
        v, vs = _kv_quant(_randn(rng, (1, b, s, hkv, d), torch.float32, dev))
        return (lambda st=sts: flash_decode_attention_kv8(q, k, ks, v, vs, 0, lens, st),
                lambda st=sts: flash_decode_kv8_reference(q, k, ks, v, vs, 0, lens, st),
                lens, sts, q)
    k = _randn(rng, (1, b, s, hkv, d), dtype, dev)
    v = _randn(rng, (1, b, s, hkv, d), dtype, dev)
    # the kernel's cache holds a non-finite pad below each start, which it
    # must never read (the plain version's 0 * inf would be NaN: it gets
    # the finite cache, the same function of the visible positions)
    kn, vn = k.clone(), v.clone()
    for r, st in enumerate(starts):
        kn[0, r, :st] = float("nan")
        vn[0, r, :st] = float("inf")
    return (lambda st=sts: flash_decode_attention(q, kn, vn, 0, lens, st),
            lambda st=sts: flash_decode_reference(q, k, v, 0, lens, st),
            lens, sts, q)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,hkv,g,d,lengths,starts", STARTS_CASES)
def test_decode_kernels_with_starts_match_plain(dev, kv8, dtype, s, hkv, g, d,
                                                lengths, starts):
    """Row b attends [starts[b], lengths[b]): the four decode kernels
    (bf16 and fp32, plain and int8 cache) against their plain versions at
    the existing bounds; under the plain cache the pad below each start
    holds NaN keys and infinite values, which must not reach the output."""
    rng = np.random.default_rng(s + sum(starts))
    kernel, plain, *_ = _starts_inputs(rng, kv8, dtype, s, hkv, g, d, lengths,
                                       starts, dev)
    wrapper = flash_decode_attention_kv8 if kv8 else flash_decode_attention
    n0 = wrapper.launches
    got = kernel()
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    assert torch.isfinite(got).all()
    _assert_close(got, plain(), dtype)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_decode_kernels_without_starts_give_the_bits_of_zero_starts(dev, kv8, dtype):
    rng = np.random.default_rng(17)
    lengths = [2048, 1, 700, 257]
    kernel, *_ = _starts_inputs(rng, kv8, dtype, 2112, 8, 4, 128, lengths,
                                [0] * 4, dev)
    assert torch.equal(kernel(None), kernel())


@pytest.mark.parametrize("kv8", [False, True])
def test_decode_with_starts_launches_once_and_is_graph_capturable(dev, kv8):
    """One launch and only the output allocated; a CUDA graph of the call,
    replayed after starts, lengths and q change in place, equals the eager
    call on the new inputs."""
    rng = np.random.default_rng(23)
    kernel, _, lens, sts, q = _starts_inputs(
        rng, kv8, torch.bfloat16, 2112, 8, 4, 128, [2048, 701, 1, 1500],
        [700, 3, 0, 1499], dev)
    wrapper = flash_decode_attention_kv8 if kv8 else flash_decode_attention
    first, launched, made = _one_call(kernel, [(wrapper, "launches")])
    assert launched == [1] and made == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel()
    # the new starts stay at or above the old (below them lies the pad)
    lens.copy_(torch.tensor([2100, 702, 9, 1501], dtype=torch.int32))
    sts.copy_(torch.tensor([1000, 3, 8, 1499], dtype=torch.int32))
    q.copy_(_randn(rng, q.shape, q.dtype, dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, kernel())
    assert not torch.equal(captured, first)


def _jax_tiny_cfg():
    """JAX's tiny model at its own widths (slow heads D=32, 2 over 1; fast
    heads D=16, G=2) with `_graph_cfg`'s ten codebooks and vocabulary."""
    from fish_speech_tpu_torch.config import dual_ar_tiny
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    return dual_ar_tiny(vocab_size=tok.vocab_size, num_codebooks=10,
                        attention_qk_norm=True, tie_word_embeddings=False,
                        semantic_begin_id=tok.semantic_begin_id,
                        semantic_end_id=tok.semantic_end_id,
                        im_end_id=tok.im_end_id)


def _fp32_models(dev, quant, cfg=None):
    """`_graph_cfg`'s model (or `cfg`) in fp32 on the CPU and the same
    weights on the card."""
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar

    cfg = cfg or _graph_cfg()
    params = init_dual_ar(9, cfg, torch.float32, "cpu")
    return cfg, params, _tree_to(params, dev)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_graphed_generate_batch_equals_the_cpu_eager_bodies(dev, kv_quant):
    """A lockstep batch of three prompts of mixed lengths, greedy, fp32
    weights (plain or int8 cache): the card's graphs (`prefill_3_64`,
    `decode_3`, captured by `precompile`) give the columns the same bodies
    give eagerly on the CPU; every decode step on the card is a replay."""
    _generate_batch_case(dev, kv_quant, _graph_cfg())


@pytest.mark.parametrize("kv_quant", [False, True])
def test_graphed_generate_batch_at_jax_tiny_widths(dev, kv_quant):
    """The same at JAX's tiny widths: the decode kernels at D=32 (slow, the
    fp32 cache or the int8 one) and D=16 (fast), per-row starts included."""
    _generate_batch_case(dev, kv_quant, _jax_tiny_cfg())


def _generate_batch_case(dev, kv_quant, cfg):
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession

    cfg, cpu_params, card_params = _fp32_models(dev, kv_quant, cfg)
    prompts = [_graph_prompt(cfg, t, seed=t) for t in (37, 20, 29)]
    kw = dict(max_new_tokens=11, top_k=1)
    outs = {}
    for where, params in (("cpu", cpu_params), ("card", card_params)):
        session = GenerationSession(params, cfg, SamplingConfig(), max_batch=3,
                                    dtype=torch.float32, decode_chunk_size=4,
                                    first_chunk_size=2, kv_quant=kv_quant)
        if where == "card":
            assert set(session.precompile(37, 11, batch=3)) == {"prefill_3_64",
                                                                "decode_3"}
        outs[where] = session.generate_batch(prompts, 5, first_chunk_size=2, **kw)
        if where == "card":
            assert session.eager_runs == {"prefill_3_64": 1, "decode_3": 1}
            assert session.replays["decode_3"] >= 10
            per_step = session.launches_per_replay("decode_3")
            name = ("flash_decode_attention_kv8.launches" if kv_quant
                    else "flash_decode_attention.launches")
            assert per_step[name] >= cfg.n_layer
    for got, want in zip(outs["card"], outs["cpu"]):
        np.testing.assert_array_equal(got, want)


def test_device_partial_request_equals_a_host_partial_one(dev):
    """The server's `--tiny` engine on the card: a streamed request served
    from device partials (the default) gives the audio segments and final
    audio of the same request served from host partials, every codec call
    a replay of a graph captured beforehand."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest
    from fish_speech_tpu_torch.server.main import build_engine, parse_args

    engine = build_engine(parse_args(["--tiny"]))
    engine.session.precompile(60, 40)
    engine.precompile(code_buckets=(32, 64))
    engine.codec_eager_runs.clear()
    runs = {}
    for device_partials in (True, False):
        engine.device_partials = device_partials
        results = list(engine.inference(TTSRequest(
            text="Device partials on the card.", streaming=True,
            max_new_tokens=40, seed=3)))
        assert [r.code for r in results][0] == "header"
        assert results[-1].code == "final", results[-1].error
        runs[device_partials] = [r.audio[1] for r in results[1:]]
    assert len(runs[True]) == len(runs[False]) > 2
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)
    assert not engine.codec_eager_runs and sum(engine.codec_replays.values()) > 2


@pytest.mark.parametrize("int8", [False, True])
def test_tiny_engine_on_the_card_gives_the_cpu_engines_codes(dev, int8, monkeypatch):
    """`server.main --tiny` (JAX's tiny model, heads 32 and 16 wide), with
    and without `--int8`: the card's engine (its graphs over the fp32
    attention kernels at those widths, and under `--int8` the fp32 int8
    matvec and fused FFN) gives the `--cpu` engine's greedy codes over a
    voice's requests, the later two prefix-cache hits (the suffix at
    D=32). Both serve the CPU's weights (a seed draws other weights on
    the card's generator)."""
    from fish_speech_tpu_torch.server import main as server

    flags = ["--tiny", "--prefix-cache", "2"] + (["--int8"] if int8 else [])
    n_ffn, n_mm = int8_ffn.launches_cuda_cores, int8_matmul.launches_gemv
    tok, cfg, params, dac_cfg, dac_params = server.tiny_models("cpu")
    monkeypatch.setattr(server, "tiny_models", lambda device: (
        tok, cfg, _tree_to(params, device), dac_cfg, _tree_to(dac_params, device)))
    sessions = [server.build_engine(server.parse_args(flags + extra)).session
                for extra in ([], ["--cpu"])]
    cfg = sessions[0].cfg
    assert (cfg.head_dim, cfg.fast_head_dim) == (32, 16)
    head = _graph_prompt(cfg, 140, seed=1)
    prompts = [np.concatenate([head, _graph_prompt(cfg, n, seed=n)], axis=1)
               for n in (12, 20, 9)]
    runs = [[s.generate(p, s.new_generator(i), max_new_tokens=10, top_k=1)
             for i, p in enumerate(prompts)] for s in sessions]
    for got, want in zip(*runs):
        np.testing.assert_array_equal(got, want)
    assert [s.prefix_hits for s in sessions] == [2, 2]
    if int8:
        assert int8_ffn.launches_cuda_cores > n_ffn and int8_matmul.launches_gemv > n_mm


def _ckpt_tiny_cfg(tokenizer, jax_widths=False):
    """A tiny fp32 model with heads of D=64 (the earlier tiny model's), or
    at JAX's tiny widths (slow D=32, fast D=16)."""
    from fish_speech_tpu_torch.config import dual_ar_tiny

    widths = {} if jax_widths else dict(head_dim=64, n_head=4, n_local_heads=2,
                                        fast_head_dim=64, fast_n_head=3,
                                        fast_n_local_heads=1)
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size, **widths,
                        attention_qk_norm=True, tie_word_embeddings=False,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id)


def test_parity_golden_from_the_cpu_passes_on_the_card(dev, tmp_path):
    """`tools.parity_check`: a golden saved by a `--cpu` run (the plain
    versions) on a tiny fp32 checkpoint with a codec passes on the card
    (the fp32 kernels), and the card run launched the fp32 prefill, decode
    and training-forward kernels."""
    _parity_golden_case(tmp_path, False)


def test_parity_golden_from_the_cpu_passes_on_the_card_at_jax_widths(dev, tmp_path):
    """The same on a checkpoint at JAX's tiny widths (D=32 and 16)."""
    _parity_golden_case(tmp_path, True)


def _parity_golden_case(tmp_path, jax_widths):
    from click.testing import CliRunner

    from fish_speech_tpu_torch.config import dac_tiny
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.ops import flash_prefill, flash_train
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
    from fish_speech_tpu_torch.tools.parity_check import main
    from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

    tokenizer = build_test_tokenizer()
    cfg = _ckpt_tiny_cfg(tokenizer, jax_widths)
    ckpt = tmp_path / "ckpt"
    save_dual_ar(ckpt, init_dual_ar(0, cfg, torch.float32, "cpu"), cfg, tokenizer)
    save_codec(ckpt, init_dac(1, dac_tiny(), device="cpu"), dac_tiny())
    golden = tmp_path / "golden.json"
    runner = CliRunner()
    r = runner.invoke(main, ["--checkpoint-path", str(ckpt), "--max-new-tokens",
                             "12", "--save-golden", str(golden), "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0, r.output
    flash_prefill.reset_launches()
    flash_train.reset_launches()
    flash_decode_attention.launches = 0
    r = runner.invoke(main, ["--checkpoint-path", str(ckpt), "--max-new-tokens",
                             "12", "--golden", str(golden)], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert "PARITY OK" in r.output
    assert flash_prefill_attention.launches_cuda_cores > 0
    assert flash_decode_attention.launches > 0
    assert flash_train_forward.launches_cuda_cores > 0


@pytest.mark.parametrize("padded", [False, True])
def test_naive_forward_on_the_card_matches_the_cpu(dev, padded):
    """`forward_train_naive` in fp32: the card (the training forward's
    CUDA-core kernel) within 1e-4 of the CPU's plain run on the same
    weights and inputs."""
    _naive_forward_case(dev, padded, False)


@pytest.mark.parametrize("padded", [False, True])
def test_naive_forward_on_the_card_at_jax_widths(dev, padded):
    """The same at JAX's tiny widths (the training forward at D=32)."""
    _naive_forward_case(dev, padded, True)


def _naive_forward_case(dev, padded, jax_widths):
    from fish_speech_tpu_torch.models.naive import (forward_train_naive,
                                                    init_naive)
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    tokenizer = build_test_tokenizer()
    cfg = _ckpt_tiny_cfg(tokenizer, jax_widths)
    params = init_naive(2, cfg, torch.float32, "cpu")
    rng = np.random.default_rng(4)
    inp = np.zeros((2, cfg.num_codebooks + 1, 150), np.int32)
    inp[:, 0] = rng.integers(0, 200, (2, 150))
    inp[:, 0, 40:120] = rng.integers(cfg.semantic_begin_id, cfg.semantic_end_id,
                                     (2, 80))
    inp[:, 1:] = rng.integers(0, cfg.codebook_size, (2, cfg.num_codebooks, 150))
    pad = np.zeros((2, 150), bool)
    pad[1, 131:] = True
    inp, pad = torch.from_numpy(inp), torch.from_numpy(pad)
    with torch.no_grad():
        want = forward_train_naive(params, cfg, inp, pad if padded else None)
        n = flash_train_forward.launches_cuda_cores
        got = forward_train_naive(_tree_to(params, dev), cfg, inp.to(dev),
                                  pad.to(dev) if padded else None)
    assert flash_train_forward.launches_cuda_cores == n + cfg.n_layer
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Tensor parallelism: the kernels at each rank's heads, and the mesh session
# ---------------------------------------------------------------------------

# s2-pro's heads on one rank (D = 128): the slow stack's H / Hkv at tp=2 and
# tp=4 (16 / 4, 8 / 2), the fast stack's (6 / 2, 3 / 1: G = 3)
LOCAL_SLOW = [(16, 4), (8, 2)]
LOCAL_FAST = [(6, 2), (3, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,hkv", LOCAL_SLOW)
def test_local_heads_prefill_and_suffix_match_plain(dev, dtype, h, hkv):
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    rng = np.random.default_rng(h)
    q = _randn(rng, (2, 600, h, 128), dtype, dev)
    k = _randn(rng, (2, 600, hkv, 128), dtype, dev)
    v = _randn(rng, (2, 600, hkv, 128), dtype, dev)
    off = torch.tensor([0, 129], dtype=torch.int32, device=dev)
    n0 = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v, off)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == n0 + 1
    _assert_close(got, flash_prefill_reference(q, k, v, off), dtype)
    for kv8 in (False, True):
        cache = _suffix_cache(dev, kv8, dtype, b=1, s=1100, hkv=hkv, d=128,
                              seed=h + kv8)
        qs = _randn(rng, (1, 64, h, 128), dtype, dev)
        st = torch.tensor([951], dtype=torch.int32, device=dev)
        fp.reset_launches()
        got = fp.flash_suffix_attention(qs, cache, 1, st)
        torch.cuda.synchronize()
        assert fp.flash_suffix_attention.launches == 1
        _assert_close(got, fp.flash_suffix_reference(qs, cache, 1, st), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,hkv,g,lengths", [
    *((2112, hkv, h // hkv, [1000]) for h, hkv in LOCAL_SLOW),
    *((10, hkv, h // hkv, [7]) for h, hkv in LOCAL_FAST),
    (2112, 4, 4, [1, 257, 2000]),
])
def test_local_heads_decode_matches_plain(dev, dtype, s, hkv, g, lengths):
    rng = np.random.default_rng(s + hkv)
    b = len(lengths)
    q = _randn(rng, (b, hkv, g, 128), dtype, dev)
    k = _randn(rng, (2, b, s, hkv, 128), dtype, dev)
    v = _randn(rng, (2, b, s, hkv, 128), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for layer in range(2):
        n0 = flash_decode_attention.launches
        got = flash_decode_attention(q, k, v, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention.launches == n0 + 1
        _assert_close(got, flash_decode_reference(q, k, v, layer, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,hkv", LOCAL_SLOW)
def test_local_heads_kv8_decode_matches_plain(dev, dtype, h, hkv):
    rng = np.random.default_rng(h + 1)
    q = _randn(rng, (1, hkv, h // hkv, 128), dtype, dev)
    k, ks = _kv_quant(_randn(rng, (2, 1, 2112, hkv, 128), torch.float32, dev))
    v, vs = _kv_quant(_randn(rng, (2, 1, 2112, hkv, 128), torch.float32, dev))
    lens = torch.tensor([2000], dtype=torch.int32, device=dev)
    for layer in range(2):
        n0 = flash_decode_attention_kv8.launches
        got = flash_decode_attention_kv8(q, k, ks, v, vs, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention_kv8.launches == n0 + 1
        _assert_close(got, flash_decode_kv8_reference(q, k, ks, v, vs, layer,
                                                      lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", LOCAL_SLOW)
def test_local_heads_training_kernels_match_plain(dev, dtype, h, hkv):
    test_train_forward_kernel_matches_plain(dev, dtype, 2, 1024, h, hkv, 128,
                                            [0, 100])
    test_train_backward_kernels_match_plain(dev, dtype, 2, 1024, h, hkv, 128,
                                            [0, 100])


def test_nccl_mesh_session_replays_the_unsharded_columns(dev, tmp_path):
    """A (1, 1) mesh over nccl: the session's graphs capture the mesh's
    collectives (an all-reduce per row-parallel product, the gathers of the
    heads) and replay the unsharded session's columns bit for bit."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                     shard_params)

    assert init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                            backend="nccl", device=dev)
    try:
        mesh = make_mesh(dp=1, tp=1, device=dev)
        plain = _graph_session(dev, "bf16")
        from fish_speech_tpu_torch.config import SamplingConfig
        from fish_speech_tpu_torch.generate import GenerationSession

        meshed = GenerationSession(
            shard_params(plain.params, plain.cfg, mesh), plain.cfg,
            SamplingConfig(), dtype=torch.bfloat16, decode_chunk_size=4,
            first_chunk_size=2, mesh=mesh)
        assert not meshed.eager
        calls = mesh.tp.calls
        meshed.precompile(37, 11)
        assert mesh.tp.calls > calls  # the capture recorded collectives
        prompt = _graph_prompt(plain.cfg, 37, seed=3)
        for kw in ({"top_k": 1}, {"temperature": 0.8, "top_k": 30}):
            want = plain.generate(prompt, 5, max_new_tokens=11, **kw)
            got = meshed.generate(prompt, 5, max_new_tokens=11, **kw)
            np.testing.assert_array_equal(got, want)
        assert meshed.replays["decode"] > 0
        assert dict(meshed.eager_runs) == {"prefill_64": 1, "decode": 1}
    finally:
        dist.destroy_process_group()


def test_audio_conditioned_prefill_graph_equals_its_eager_body(dev):
    """A model with an audio projector: a request with features replays a
    prefill graph of its own (`audio_{bucket}`, captured at its first use
    after one eager run) whose columns are its eager body's, greedy and
    sampled; a request without features replays `prefill_{bucket}`."""
    import dataclasses

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar

    cfg = dataclasses.replace(_graph_cfg(), audio_feature_dim=24)
    session = GenerationSession(init_dual_ar(9, cfg, torch.bfloat16, dev), cfg,
                                SamplingConfig(), dtype=torch.bfloat16,
                                decode_chunk_size=4, first_chunk_size=2)
    rng = np.random.default_rng(11)
    prompt = _graph_prompt(cfg, 40, seed=6)
    feats = (rng.standard_normal((40, 24)) * 2).astype(np.float32)
    mask = np.zeros(40, dtype=bool)
    mask[20:] = True
    for sampling, seed in (((1.0, 0.9, 1), 1), ((0.8, 0.9, 30), 4)):
        got = session.generate(prompt, seed, max_new_tokens=11, temperature=sampling[0],
                               top_p=sampling[1], top_k=sampling[2],
                               audio_features=feats, audio_mask=mask)
        want = _eager_stream(session, prompt, 11, sampling, seed, (feats, mask))
        np.testing.assert_array_equal(got, want)
    assert session.replays["audio_64"] == 2 and session.eager_runs["audio_64"] == 1
    plain = session.generate(prompt, 1, max_new_tokens=11, top_k=1)
    np.testing.assert_array_equal(plain, _eager_stream(session, prompt, 11,
                                                       (1.0, 0.9, 1), 1))
    assert session.replays["prefill_64"] == 1


def test_eval_quality_tiny_on_the_card(dev, tmp_path):
    """`tools.eval_quality --tiny` on cuda:0 (no --cpu) with `--ab kv-int8`
    through the pool: mock WER 0 in both configs, and the kv-int8 config's
    decode ran the int8-KV kernel."""
    import json

    from click.testing import CliRunner

    from fish_speech_tpu_torch.audio.io import write_wav
    from fish_speech_tpu_torch.config import dac_tiny
    from fish_speech_tpu_torch.ops.flash_decode import flash_decode_attention_kv8
    from fish_speech_tpu_torch.tools import eval_quality

    cfg = dac_tiny()
    ref = tmp_path / "speaker.wav"
    write_wav(ref, np.random.default_rng(0).normal(size=cfg.frame_length * 4)
              .astype(np.float32) * 0.1, cfg.sample_rate)
    items = [{"id": "en_1", "text": "hello there", "lang": "en"},
             {"id": "zh_1", "text": "one two three", "lang": "zh",
              "ref_audio": str(ref), "ref_text": "ref"}]
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("\n".join(json.dumps(i) for i in items))
    synthesize, kv8 = eval_quality.synthesize_manifest, {}

    def counted(engine, its, out_dir, tag, *a, **kw):
        n0 = flash_decode_attention_kv8.launches
        out = synthesize(engine, its, out_dir, tag, *a, **kw)
        torch.cuda.synchronize()
        kv8[tag] = flash_decode_attention_kv8.launches - n0
        return out

    eval_quality.synthesize_manifest = counted
    try:
        r = CliRunner().invoke(eval_quality.main, [
            "--manifest", str(manifest), "--out-dir", str(tmp_path / "out"), "--tiny",
            "--asr", "mock", "--sim", "spectral", "--ab", "kv-int8",
            "--max-new-tokens", "8"], catch_exceptions=False)
    finally:
        eval_quality.synthesize_manifest = synthesize
    assert r.exit_code == 0, r.output
    report = json.loads((tmp_path / "out" / "report.json").read_text())
    assert list(report["configs"]) == ["baseline", "kv-int8"]
    for conf in report["configs"].values():
        assert conf["aggregates"]["wer_en"] == 0.0 == conf["aggregates"]["wer_zh"]
        assert -1.0 <= conf["aggregates"]["sim_mean"] <= 1.0
    assert kv8["baseline"] == 0 and kv8["kv-int8"] > 0


# ---------------------------------------------------------------------------
# fp16 (`--half` serving): the fp16 forms of the int8 products and of the
# fused FFN at serving shapes, and a graphed fp16 session (the attention
# kernels' fp16 forms are cases of the dtype-parametrized tests above)
# ---------------------------------------------------------------------------

INT8_F16_SHAPES = [(2560, 6144, "contiguous"), (9728, 2560, "contiguous"),
                   (2560, 155136, "contiguous"), (2560, 4097, "padded"),
                   (1536, 4096, "contiguous"), (1001, 200, "padded"),
                   (2560, 4097, "contiguous")]


@pytest.mark.parametrize("i,o,layout", INT8_F16_SHAPES)
def test_fp16_int8_kernel_matches_plain(dev, i, o, layout):
    """fp16 x of 1-16 rows on `int8_gemv_mma_kernel`'s fp16 form, 17-32 on
    `int8_gemv_cluster_kernel`'s: within 2^-11 |y| (the one rounding of y
    to fp16) + 1e-5 of (|x| @ |q|) * s (the order of the fp32 sums) of the
    exact product, and `mm`'s route gives the same bits."""
    rng = np.random.default_rng(i + o + 1)
    q, s = _int8_weight(i, o, layout, i * o + 1, dev)
    qf = q.float()
    for b in (1, 4, 16, 17, 27, 32):
        x = _randn(rng, (b, i), torch.float16, dev)
        route = f"launches_{int8_route(b, torch.float16)}"
        assert route.endswith("_f16")
        n0, r0 = int8_matmul.launches, getattr(int8_matmul, route)
        got = int8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert int8_matmul.launches == n0 + 1 and got.dtype == torch.float16
        assert getattr(int8_matmul, route) == r0 + 1
        exact = (x.float() @ qf) * s
        scale = (x.float().abs() @ qf.abs()) * s
        err = (got.float() - exact).abs()
        assert bool((err <= 2.0 ** -11 * exact.abs() + 1e-5 * scale).all()), \
            (b, err.max().item())
        assert torch.equal(mm(x[:, None], {"q": q, "s": s})[:, 0], got)
        del exact, scale, err


@pytest.mark.parametrize("d,i", FFN_SHAPES)
def test_fp16_int8_ffn_kernel_matches_plain(dev, d, i):
    """`int8_ffn_mma_kernel`'s fp16 form within 2 fp16 ulps of max |y| of
    the plain version (g rounded to fp16 once in both, from u summed in
    another order), the model's route the same bits."""
    from fish_speech_tpu_torch.models.dual_ar import _ffn

    rng = np.random.default_rng(d + i + 1)
    w13, w2 = _ffn_weights(d, i, d * i + 1, dev)
    for b in (1, 4, 16, 32):
        x = _randn(rng, (b, d), torch.float16, dev)
        n0, r0 = int8_ffn.launches, int8_ffn.launches_mma_f16
        got = int8_ffn(x, w13, w2)
        torch.cuda.synchronize()
        assert int8_ffn.launches == n0 + 1 and int8_ffn.launches_mma_f16 == r0 + 1
        assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
        want = int8_ffn_reference(x, w13, w2)
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 10), (err, top)
        assert torch.equal(_ffn({"w13": w13, "w2": w2}, (0,) * 5, x[:, None])[:, 0], got)


@pytest.mark.parametrize("kind", ["fp16", "fp16_int8"])
def test_fp16_graphed_session_equals_its_eager_run(dev, kind):
    """`_graph_cfg`'s model in fp16 (weights int8 and the KV cache int8 in
    "fp16_int8"): greedy columns of the graphed session equal an eager
    session's on the same weights (the same kernels, launched one by one),
    and the replayed decode step launches the fp16 forms only."""
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _graph_cfg()
    params = init_dual_ar(7, cfg, torch.float16, dev)
    quant = kind == "fp16_int8"
    if quant:
        params = quantize_dual_ar_lowmem(params, mode="int8")
    kw = dict(decode_chunk_size=4, first_chunk_size=2, kv_quant=quant,
              dtype=torch.float16)
    graphed = GenerationSession(params, cfg, SamplingConfig(), **kw)
    eager = GenerationSession(params, cfg, SamplingConfig(), **kw)
    eager.eager = True
    assert not graphed.eager
    graphed.precompile(37, 11)
    per_step = graphed.launches_per_replay("decode")
    fast = cfg.num_codebooks * cfg.n_fast_layer
    if quant:  # the slow stack over the int8 cache, the fast over its own
        assert per_step["flash_decode_attention_kv8.launches_f16"] == cfg.n_layer
        assert per_step["flash_decode_attention.launches_f16"] == fast
    else:
        assert per_step["flash_decode_attention.launches_f16"] == cfg.n_layer + fast
    if quant:
        assert per_step["int8_ffn.launches_mma_f16"] >= cfg.n_layer
        assert per_step["int8_matmul.launches_gemv_mma_f16"] > 0
        assert per_step.get("int8_matmul.launches_gemv_mma", 0) == 0
    prompt = _graph_prompt(cfg, 37, seed=37)
    got = graphed.generate(prompt, 1, max_new_tokens=11, top_k=1)
    want = eager.generate(prompt, 1, max_new_tokens=11, top_k=1)
    np.testing.assert_array_equal(got, want)
    assert graphed.replays["decode"] > 0 and not eager.replays


# ---------------------------------------------------------------------------
# JAX's tiny model's widths (`dual_ar_tiny`: slow heads D=32, 2 over 1 KV
# head; fast heads D=16, G=2): the fp32 attention kernels at D=32 and 16,
# bf16 training at D=32 ("cuda_cores_bf16"), and the redesigned fp32 int8
# matvec (`int8_gemv_fp32_kernel`) and fused FFN (`int8_ffn_fp32_kernel`)
# ---------------------------------------------------------------------------

# (n_layer, b, s, hkv, g, d, lengths): the tiny slow cache (max_seq_len 256
# + a chunk), the fast cache (S = num_codebooks: 3 for dac_tiny's, 10), a
# ragged batch, and D=16 over many positions (whole warps of eight rows)
TINY_DECODE = [
    (2, 1, 264, 1, 2, 32, [1]), (2, 1, 264, 1, 2, 32, [37]),
    (2, 1, 264, 1, 2, 32, [264]), (2, 3, 264, 1, 2, 32, [5, 100, 264]),
    (2, 1, 3, 1, 2, 16, [1]), (2, 1, 3, 1, 2, 16, [3]),
    (2, 1, 10, 1, 2, 16, [7]), (2, 4, 10, 1, 2, 16, [1, 4, 9, 10]),
    (1, 2, 700, 2, 4, 16, [700, 333]),
]


@pytest.mark.parametrize("n_layer,b,s,hkv,g,d,lengths", TINY_DECODE)
def test_tiny_width_decode_matches_plain(dev, n_layer, b, s, hkv, g, d, lengths):
    rng = np.random.default_rng(s + d + sum(lengths))
    q = _randn(rng, (b, hkv, g, d), torch.float32, dev)
    k = _randn(rng, (n_layer, b, s, hkv, d), torch.float32, dev)
    v = _randn(rng, (n_layer, b, s, hkv, d), torch.float32, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for layer in range(n_layer):
        n0 = flash_decode_attention.launches
        got = flash_decode_attention(q, k, v, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention.launches == n0 + 1
        _assert_close(got, flash_decode_reference(q, k, v, layer, lens), torch.float32)
    # with starts: the lockstep batch's left pad
    starts = torch.tensor([max(0, n - 5) for n in lengths], dtype=torch.int32, device=dev)
    got = flash_decode_attention(q, k, v, 0, lens, starts)
    torch.cuda.synchronize()
    _assert_close(got, flash_decode_reference(q, k, v, 0, lens, starts), torch.float32)


@pytest.mark.parametrize("b,s,g,lengths", [(1, 264, 2, [1]), (1, 264, 2, [200]),
                                           (3, 264, 2, [5, 64, 264]),
                                           (2, 1100, 4, [1100, 17])])
def test_tiny_width_kv8_decode_matches_plain(dev, b, s, g, lengths):
    rng = np.random.default_rng(s + sum(lengths))
    q = _randn(rng, (b, 1, g, 32), torch.float32, dev)
    k, ks = _kv_quant(_randn(rng, (2, b, s, 1, 32), torch.float32, dev))
    v, vs = _kv_quant(_randn(rng, (2, b, s, 1, 32), torch.float32, dev))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for layer in range(2):
        n0 = flash_decode_attention_kv8.launches
        got = flash_decode_attention_kv8(q, k, ks, v, vs, layer, lens)
        torch.cuda.synchronize()
        assert flash_decode_attention_kv8.launches == n0 + 1
        _assert_close(got, flash_decode_kv8_reference(q, k, ks, v, vs, layer, lens),
                      torch.float32)


@pytest.mark.parametrize("b,t,h,hkv,offsets", [(1, 64, 2, 1, [0]), (2, 100, 2, 1, [0, 7]),
                                               (1, 257, 4, 2, [30]), (2, 1000, 2, 1, [0, 129])])
def test_tiny_width_prefill_matches_plain(dev, b, t, h, hkv, offsets):
    rng = np.random.default_rng(t + h)
    q = _randn(rng, (b, t, h, 32), torch.float32, dev)
    k = _randn(rng, (b, t, hkv, 32), torch.float32, dev)
    v = _randn(rng, (b, t, hkv, 32), torch.float32, dev)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    n0 = flash_prefill_attention.launches_cuda_cores
    got = flash_prefill_attention(q, k, v, off)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches_cuda_cores == n0 + 1
    _assert_close(got, flash_prefill_reference(q, k, v, off), torch.float32)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("start,ts", [(0, 64), (151, 64), (37, 130), (255, 1)])
def test_tiny_width_suffix_matches_plain(dev, kv8, start, ts):
    """The fp32 suffix (the prefix cache's hit on JAX's tiny model) at D=32
    over both caches; a graph replayed at another start gives that start's
    output."""
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    cache = _suffix_cache(dev, kv8, torch.float32, hkv=1, d=32, seed=start + ts)
    rng = np.random.default_rng(ts)
    q = torch.from_numpy(rng.normal(size=(2, ts, 2, 32))).to(dev, torch.float32)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    fp.reset_launches()
    got = fp.flash_suffix_attention(q, cache, 1, st)
    torch.cuda.synchronize()
    route = fp._suffix_route(torch.float32, kv8)
    assert getattr(fp.flash_suffix_attention, f"launches_{route}") == 1
    want = fp.flash_suffix_reference(q, cache, 1, st)
    assert float((got - want).abs().max()) <= 1e-4
    graph = torch.cuda.CUDAGraph()
    out = {}
    with torch.cuda.graph(graph):
        out["y"] = fp.flash_suffix_attention(q, cache, 1, st)
    st.fill_(max(start - 17, 0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], fp.flash_suffix_attention(q, cache, 1, st))


TINY_TRAIN = [(2, 100, 2, 1, 32, [0, 7]), (1, 130, 2, 1, 32, [3]),
              (2, 600, 4, 2, 32, [0, 50]), (1, 64, 8, 2, 32, [0])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,pads", TINY_TRAIN)
def test_tiny_width_training_kernels_match_plain(dev, dtype, b, t, h, hkv, d, pads):
    """The training forward and backward at D=32: fp32 on "cuda_cores",
    bf16 on "cuda_cores_bf16" (the CUDA-core kernels on bf16 inputs, fp32
    P and dS, where the plain version rounds them to bf16: within the
    bounds of the bf16 cases above)."""
    rng = np.random.default_rng(t + h + 32)
    q, k, v, kvalid, do = _train_inputs(rng, b, t, h, hkv, d, pads, dtype, dev)
    route = train_route(dtype, d)
    assert route == ("cuda_cores" if dtype == torch.float32 else "cuda_cores_bf16")
    counter = f"launches_{route}"
    f0, b0 = getattr(flash_train_forward, counter), getattr(flash_train_backward, counter)
    o, lse = flash_train_forward(q, k, v, kvalid)
    grads = flash_train_backward(q, k, v, kvalid, o, lse, do)
    torch.cuda.synchronize()
    assert getattr(flash_train_forward, counter) == f0 + 1
    assert getattr(flash_train_backward, counter) == b0 + 1
    want_o, want_lse = flash_train_forward_reference(q, k, v, kvalid)
    err = (o.float() - want_o.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert (err <= 2e-2 + 2 ** -7 * want_o.float().abs()).all(), err.max().item()
        assert err.mean().item() <= 2e-3
    assert (lse - want_lse).abs().max().item() <= 1e-4
    want = flash_train_backward_reference(q, k, v, kvalid, o, lse, do)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        e = (g.float() - w.float()).abs().max().item()
        bound = 1e-4 if dtype == torch.float32 else 2e-2
        assert e <= bound * max(1.0, w.float().abs().max().item()), e
    # through autograd: the function's gradients are the backward's
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    flash_train_attention(qg, kg, vg, kvalid).backward(do)
    for got, g in zip((qg.grad, kg.grad, vg.grad), grads):
        assert torch.equal(got, g)


def test_tiny_width_wrappers_refuse_other_widths_on_the_card(dev):
    """D=8 and 48 raise on card tensors before a launch; the 16-bit
    attention routes refuse the tiny widths (their tensor-core kernels take
    64 and 128)."""
    from fish_speech_tpu_torch.ops import flash_prefill as fp

    n0 = flash_decode_attention.launches
    for d, dtype in ((8, torch.float32), (48, torch.float32), (32, torch.bfloat16),
                     (16, torch.float16)):
        q = torch.zeros(1, 1, 2, d, dtype=dtype, device=dev)
        kv = torch.zeros(1, 1, 8, 1, d, dtype=dtype, device=dev)
        with pytest.raises(ValueError, match="D="):
            flash_decode_attention(q, kv, kv, 0, torch.ones(1, dtype=torch.int32, device=dev))
    assert flash_decode_attention.launches == n0
    for d in (8, 16, 48):
        x = torch.zeros(1, 8, 2, d, device=dev)
        with pytest.raises(ValueError, match="head dim"):
            flash_prefill_attention(x, x[:, :, :1].contiguous(), x[:, :, :1].contiguous(),
                                    torch.zeros(1, dtype=torch.int32, device=dev))
        with pytest.raises(ValueError, match="head dim"):
            flash_train_forward(x, x, x, torch.ones(1, 8, dtype=torch.int32, device=dev))
    cache = _suffix_cache(dev, False, torch.bfloat16, hkv=1, d=32)
    with pytest.raises(ValueError, match="head dim"):
        fp.flash_suffix_attention(torch.zeros(2, 4, 2, 32, dtype=torch.bfloat16, device=dev),
                                  cache, 0, torch.zeros(1, dtype=torch.int32, device=dev))


# the fp32 int8 products of JAX's tiny model as `--tiny --int8` serves it
# (I, O, layout): slow wqkv, wo, w13 (fused), w2; fast wqkv, wo, w13, w2;
# the semantic head (4097 columns, rows 16 bytes apart) and the fast head;
# the output head of an untied tiny model (O = the test tokenizer's 4364);
# then shapes that split (few tiles over a long I) and a row stride that is
# not a multiple of 4 (byte loads)
TINY_INT8 = [(64, 128, "contiguous"), (64, 64, "contiguous"), (64, 256, "contiguous"),
             (128, 64, "contiguous"), (32, 64, "contiguous"), (32, 32, "contiguous"),
             (32, 128, "contiguous"), (64, 32, "contiguous"), (64, 4097, "padded"),
             (32, 4096, "contiguous"), (64, 4364, "contiguous"), (2560, 200, "contiguous"),
             (4096, 130, "contiguous"), (9728, 2560, "contiguous"), (300, 4097, "contiguous")]


@pytest.mark.parametrize("i,o,layout", TINY_INT8)
def test_fp32_int8_matvec_matches_plain(dev, i, o, layout):
    """`int8_gemv_fp32_kernel` at B in {1, 4, 16, 32} (NB = 1, 8, 16, 32):
    within 1e-5 of (|x| @ |q|) * s of the exact product, one launch on
    "gemv", and a graph of the call replayed twice gives the same bits."""
    rng = np.random.default_rng(i + o)
    q, s = _int8_weight(i, o, layout, i * o + 1, dev)
    qf = q.float()
    for b in (1, 4, 16, 32):
        x = _randn(rng, (b, i), torch.float32, dev)
        n0 = int8_matmul.launches_gemv
        got = int8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert int8_matmul.launches_gemv == n0 + 1
        exact = (x @ qf) * s
        scale = (x.abs() @ qf.abs()) * s
        err = (got - exact).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), (b, err.max().item())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = int8_matmul(x, q, s)
        graph.replay()
        torch.cuda.synchronize()
        first = captured.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, captured) and torch.equal(first, got)


def test_fp32_int8_matvec_byte_loads(dev):
    """W's rows 4099 bytes apart (a view: no row but the first on a 4-byte
    boundary) take the kernel's byte loads: the same sums."""
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    buf = torch.randint(-127, 128, (64, 4099), generator=gen, dtype=torch.int8).to(dev)
    q, s = buf[:, :4097], (torch.rand(4097, generator=gen) * 0.02 + 0.001).to(dev)
    for b in (1, 4):
        x = _randn(rng, (b, 64), torch.float32, dev)
        got = int8_matmul(x, q, s)
        exact = (x @ q.float()) * s
        scale = (x.abs() @ q.float().abs()) * s
        assert bool(((got - exact).abs() <= 1e-5 * scale + 1e-6).all())


# the fp32 FFNs (D, I): JAX's tiny slow and fast stacks, s2-pro's slow and
# fast (both phases split), and a ragged I
TINY_FFN = [(64, 128), (32, 64), (2560, 9728), (1536, 6144), (384, 640), (128, 400)]


@pytest.mark.parametrize("d,i", TINY_FFN)
def test_fp32_int8_ffn_matches_plain(dev, d, i):
    """`int8_ffn_fp32_kernel` at B in {1, 4, 16, 32}: within 1e-5 of max
    |y| of the plain version, one launch on "cuda_cores", the (w1, w3)
    form the same bits, and a graph of the call replayed twice the same
    bits as the eager call."""
    rng = np.random.default_rng(d + i)
    w13, w2 = _ffn_weights(d, i, d * i + 1, dev)
    pair = ({"q": w13["q"][:, :i].contiguous(), "s": w13["s"][:i].contiguous()},
            {"q": w13["q"][:, i:].contiguous(), "s": w13["s"][i:].contiguous()})
    for b in (1, 4, 16, 32):
        x = _randn(rng, (b, d), torch.float32, dev)
        n0 = int8_ffn.launches_cuda_cores
        got = int8_ffn(x, w13, w2)
        torch.cuda.synchronize()
        assert int8_ffn.launches_cuda_cores == n0 + 1
        assert bool(torch.isfinite(got).all())
        _ffn_close(got, int8_ffn_reference(x, w13, w2), torch.float32)
        assert torch.equal(int8_ffn(x, pair, w2), got)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = int8_ffn(x, w13, w2)
        graph.replay()
        torch.cuda.synchronize()
        first = captured.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, captured) and torch.equal(first, got)


@pytest.mark.parametrize("b", [1, 16, 32])
def test_fp32_int8_ffn_direct_loads_at_a_full_grid(dev, b):
    """The fp32 FFN's direct-load form (w1 and w3 rows 9732 bytes apart,
    which TMA cannot take) at s2-pro's slow widths, where the plan's grid
    reaches what the card holds at once: the grid barrier completes (the
    bound on the grid is the least occupancy of the two forms), the result
    within 1e-5 of max |y| of the plain version."""
    d, i = 2560, 9728
    rng = np.random.default_rng(b)
    gen = torch.Generator().manual_seed(b)
    w1, w3 = (torch.randint(-127, 128, (d, i + 4), generator=gen,
                            dtype=torch.int8).to(dev)[:, :i] for _ in range(2))
    s1, s3 = ((torch.rand(i, generator=gen) + 0.5).to(dev) / (73.0 * d ** 0.5)
              for _ in range(2))
    _, w2 = _ffn_weights(d, i, b, dev)
    assert w1.stride(0) % 16 != 0
    pair = ({"q": w1, "s": s1}, {"q": w3, "s": s3})
    fused = {"q": torch.cat([w1, w3], dim=1), "s": torch.cat([s1, s3])}
    x = _randn(rng, (b, d), torch.float32, dev)
    n0 = int8_ffn.launches_cuda_cores
    got = int8_ffn(x, pair, w2)
    torch.cuda.synchronize()
    assert int8_ffn.launches_cuda_cores == n0 + 1
    assert bool(torch.isfinite(got).all())
    _ffn_close(got, int8_ffn_reference(x, fused, w2), torch.float32)
