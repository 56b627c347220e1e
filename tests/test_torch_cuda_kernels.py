"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip (with the reason) where no CUDA device is present.
Run them on a GPU machine with
    python -m pytest tests/test_torch_cuda_kernels.py -q
Inputs come from numpy with a seed. fp32 cases hold the kernel to 1e-4 abs
(only the summation order differs); bf16 cases to 2e-2 max / 2e-3 mean abs,
the bound of bf16 rounding of P before P.V in the plain version (the
output is a convex combination of V rows of unit scale).
"""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                    flash_decode_reference)
from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                     flash_prefill_reference)

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
