"""The port's training attention (`ops/flash_train.py`) against the JAX
package, on the CPU.

Inputs are float32 from numpy with a seed. The plain forward and backward
are held to the Pallas kernels of `ops/pallas_attention_train.py` run in
interpret mode and to `jax.grad` through them: O and lse to rtol 1e-5 /
atol 1e-5, gradients to rtol 1e-4 / atol 1e-5 (only the summation order
differs), with padded query rows given a zero cotangent as the masked loss
gives them. The autograd Function is also held to torch autograd through
the masked einsum `gqa_attention`, and a CPU tensor never counts a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import pallas_attention_train as jtrain
from fish_speech_tpu_torch.ops.attention import gqa_attention
from fish_speech_tpu_torch.ops.flash_train import (
    flash_train_attention, flash_train_backward, flash_train_backward_reference,
    flash_train_forward, flash_train_forward_reference)

torch.set_num_threads(1)

SHAPES = [(1, 128, 4, 2, 64), (2, 256, 8, 2, 64), (2, 128, 4, 4, 32),
          (2, 96, 4, 2, 32)]


def _inputs(b, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[0, -17:] = True
    if b > 1:
        pad[1, -3:] = True
    kvalid = ~pad
    ct = rng.standard_normal((b, t, h, d)).astype(np.float32)
    ct *= kvalid[:, :, None, None]  # padded QUERY rows: zero cotangent
    return q, k, v, kvalid, ct


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,t,h,hkv,d", SHAPES)
def test_plain_forward_and_backward_match_pallas_interpret(b, t, h, hkv, d):
    q, k, v, kvalid, ct = _inputs(b, t, h, hkv, d, seed=t + h)
    jq, jk, jv = (jnp.asarray(np.transpose(x, (0, 2, 1, 3))) for x in (q, k, v))
    want_o, want_lse = jtrain._fwd(jq, jk, jv, jnp.asarray(kvalid, jnp.int32),
                                   True)
    want_g = jax.grad(
        lambda *a: jnp.vdot(jtrain.flash_train_attention(*a, jnp.asarray(kvalid),
                                                         True), ct),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv, tct = _t(q, k, v, ct)
    tkv = torch.from_numpy(kvalid.astype(np.int32))
    o, lse = flash_train_forward_reference(tq, tk, tv, tkv)
    valid = kvalid[:, :, None, None]
    np.testing.assert_allclose(o.numpy() * valid,
                               np.transpose(np.asarray(want_o), (0, 2, 1, 3)) * valid,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy() * kvalid[:, None, :],
                               np.asarray(want_lse) * kvalid[:, None, :],
                               rtol=1e-5, atol=1e-5)

    grads = flash_train_backward_reference(tq, tk, tv, tkv, o, lse, tct)
    for name, got, want in zip("qkv", grads, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name} diverged")

    # the wrappers and the Function take the same plain path on the CPU
    n_fwd, n_bwd = flash_train_forward.launches, flash_train_backward.launches
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out = flash_train_attention(tq, tk, tv, torch.from_numpy(kvalid))
    got_g = torch.autograd.grad((out * tct).sum(), (tq, tk, tv))
    assert torch.equal(out.detach(), o)
    for got, ref in zip(got_g, grads):
        assert torch.equal(got, ref)
    assert flash_train_forward.launches == n_fwd
    assert flash_train_backward.launches == n_bwd
    assert flash_train_backward(tq, tk, tv, tkv, o, lse, tct)[0].shape == q.shape


def test_padded_keys_are_blocked():
    """Perturbing k/v at padded positions changes neither the outputs nor
    the gradients at valid positions (the key mask blocks both ways)."""
    rng = np.random.default_rng(1)
    b, t, h, hkv, d = 1, 128, 2, 1, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    kvalid = np.ones((b, t), bool)
    kvalid[:, -9:] = False
    ct = rng.standard_normal((b, t, h, d)).astype(np.float32)
    ct *= kvalid[:, :, None, None]

    def grads(k, v):
        tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
        out = flash_train_attention(tq, tk, tv, torch.from_numpy(kvalid))
        return out.detach(), torch.autograd.grad(
            (out * torch.from_numpy(ct)).sum(), (tq, tk, tv))

    o1, g1 = grads(k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, -9:] += 5.0
    v2[:, -9:] += 5.0
    o2, g2 = grads(k2, v2)
    np.testing.assert_allclose(o1[:, :-9].numpy(), o2[:, :-9].numpy(), atol=1e-5)
    np.testing.assert_allclose(g1[0].numpy(), g2[0].numpy(), atol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(g1[i][:, :-9].numpy(), g2[i][:, :-9].numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,t,h,hkv,d", [(2, 40, 4, 2, 16), (1, 33, 6, 3, 8)])
def test_function_matches_autograd_through_masked_einsum(dtype, b, t, h, hkv, d):
    q, k, v, kvalid, ct = _inputs(b, t, h, hkv, d, seed=b * t)
    tq, tk, tv = (x.to(dtype).requires_grad_(True) for x in _t(q, k, v))
    tct = torch.from_numpy(ct).to(dtype)
    kv = torch.from_numpy(kvalid)
    i = torch.arange(t)
    mask = (i[None, :] <= i[:, None])[None] & kv[:, None, :]

    want = gqa_attention(tq, tk, tv, mask)
    want_g = torch.autograd.grad((want * tct).sum(), (tq, tk, tv))
    got = flash_train_attention(tq, tk, tv, kv)
    got_g = torch.autograd.grad((got * tct).sum(), (tq, tk, tv))
    valid = kv[:, :, None, None]
    torch.testing.assert_close(got * valid, want * valid, rtol=1e-5, atol=1e-5)
    for name, a, w in zip("qkv", got_g, want_g):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: f"d{n}: {m}")
