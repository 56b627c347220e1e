"""The training attention's TF32 routes ("fp32_tc", "bf16_tf32"), on the CPU.

The kernels (`csrc/flash_fp32.cu:attn_tf32_kernel` in its training mode,
`csrc/flash_train.cu:train_bwd_tf32_kernel`) run only on the card
(`tests/test_torch_cuda_kernels.py`, `-k "fp32_tc or bf16_tf32 or
tc_training"`). Here:

(a) the routes: fp32 "fp32_tc" at D in {32, 64, 128}, bf16 "bf16_tf32" at
    D = 32 and "wgmma" at 64 and 128; D = 16 and 48 are refused before the
    device check, forward and backward;
(b) the backward's dK/dV split (`train_bwd_plan`, `dkdv_walk`,
    `dkdv_slices`), at `chip_smoke.py` phase 2's four training shapes and
    at ragged T: each 64-key tile's slices, in slice order, cover every
    (head, query position) pair that can see one of its keys exactly once,
    Z slices hold the longest walk, and the plan reads the shape and the
    SM count alone (never kvalid); the partial dK and dV of each slice's
    packed rows (the plain backward's formulas over them), summed in slice
    order, equal the plain backward's within 1e-5 of the largest magnitude
    (fp32 sums in another order), with two different kvalid on one plan;
(c) the bf16 plain versions at JAX's tiny widths (B=2 T=200 H=2 Hkv=1
    D=32, a padded row), which the card holds the "bf16_tf32" kernels to,
    against `pallas_attention_train.py`'s kernels in interpret mode and
    `jax.grad` through them, in bf16 on both sides: O within one bf16 step
    of its value (2^-7 |O|, the two round the weights and O after fp32
    sums in another order) plus 1e-3, lse within 1e-5, the gradients
    within one bf16 step of each tensor's largest magnitude (2^-8: both
    round the output once, and dS to bf16 from fp32 sums in another order,
    so a dS can land one step apart before its products; 6.8e-4 of it
    measured).
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import pallas_attention_train as jtrain
from fish_speech_tpu_torch.ops import flash_train
from fish_speech_tpu_torch.ops.flash_train import (
    BWD_KEYS, _check, _check_backward, _route, bwd_step, dkdv_slices, dkdv_walk,
    flash_train_backward_reference, flash_train_forward_reference, train_bwd_plan)

torch.set_num_threads(1)

H100_SMS = 132

# (B, T, H, Hkv, D): chip_smoke.py phase 2's training rows on the TF32
# routes (JAX's tiny batch, s2-pro's heads at T=256, the parity tool's
# teacher-forced prompt, the train CLI's `--tiny` batch), then ragged T
PHASE2 = [(2, 200, 2, 1, 32), (2, 256, 32, 8, 128), (1, 12, 32, 8, 128),
          (2, 256, 2, 1, 32)]
RAGGED = [(3, 1000, 6, 2, 64), (1, 77, 4, 4, 32), (2, 4096, 4, 2, 64),
          (1, 130, 24, 8, 128)]


# -- (a) routes and widths -----------------------------------------------------------


def test_routes_and_widths_have_the_new_names():
    assert flash_train.ROUTES == ("fp32_tc", "wgmma", "bf16_tf32")
    assert flash_train.HEAD_DIMS == {"fp32_tc": (32, 64, 128), "wgmma": (64, 128),
                                     "bf16_tf32": (32,)}
    for d in (32, 64, 128):
        assert _route(torch.float32, d) == "fp32_tc"
    assert _route(torch.bfloat16, 32) == "bf16_tf32"
    assert _route(torch.bfloat16, 64) == _route(torch.bfloat16, 128) == "wgmma"
    for old in ("cuda_cores", "cuda_cores_bf16"):
        assert not hasattr(flash_train.flash_train_forward, f"launches_{old}")
        assert not hasattr(flash_train.flash_train_backward, f"launches_{old}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [16, 48])
def test_other_widths_are_refused_before_the_device_check(dtype, backward, d):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    k = torch.zeros(1, 8, 1, d, dtype=dtype)
    kvalid = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"head dim {d} "):
        if backward:
            _check_backward(q, k, k.clone(), kvalid, q.clone(), torch.zeros(1, 2, 8),
                            q.clone())
        else:
            _check(q, k, k.clone(), kvalid)


# -- (b) the dK/dV split ---------------------------------------------------------------


def test_the_plan_reads_the_shape_and_the_sm_count_alone():
    assert list(inspect.signature(train_bwd_plan).parameters) == [
        "b", "t", "h", "hkv", "d", "n_sm"]
    # the small shapes split their walks over the card; a large one does not
    assert train_bwd_plan(2, 200, 2, 1, 32, H100_SMS)[0] > 1
    assert train_bwd_plan(1, 12, 32, 8, 128, H100_SMS)[0] > 1
    assert train_bwd_plan(2, 1024, 32, 8, 128, H100_SMS)[0] == 1


@pytest.mark.parametrize("b,t,h,hkv,d", PHASE2 + RAGGED)
@pytest.mark.parametrize("n_sm", [H100_SMS, 16])
def test_slices_cover_every_pair_of_a_key_tile_once(b, t, h, hkv, d, n_sm):
    g, step = h // hkv, bwd_step(d)
    rows = t * g
    n_split, per = train_bwd_plan(b, t, h, hkv, d, n_sm)
    walks = dkdv_walk(t, g, d)
    assert len(walks) == -(-t // BWD_KEYS)
    assert n_split == len(dkdv_slices(t, g, d, 0, per))  # the longest walk's
    for kt, (lo, hi) in enumerate(walks):
        slices = dkdv_slices(t, g, d, kt, per)
        assert 1 <= len(slices) <= n_split
        # in slice order, contiguous, each at most `per` row tiles
        assert slices[0][0] == lo and slices[-1][1] == hi
        assert all(a[1] == b_[0] for a, b_ in zip(slices, slices[1:]))
        assert all(0 < s_hi - s_lo <= per for s_lo, s_hi in slices)
        # each packed row (position m // G of head m % G) once; every pair
        # whose position can see a key of the tile is among them
        covered = np.zeros(rows, int)
        for s_lo, s_hi in slices:
            covered[s_lo * step:min(s_hi * step, rows)] += 1
        assert covered.max() == 1
        k0 = kt * BWD_KEYS
        assert covered[k0 * g:].all()
        assert not covered[:lo * step].any()


def _packed(x, hkv):
    """(B, T, H, D) -> (B, Hkv, T * G, D): packed row m of (b, kv) is
    position m // G of head kv * G + m % G."""
    b, t, h, d = x.shape
    return x.reshape(b, t, hkv, h // hkv, d).transpose(1, 2).reshape(b, hkv, -1, d)


def _sliced_dk_dv(q, k, v, kvalid, o, lse, do, per):
    """dK, dV as the TF32 kernel sums them: per key tile, the partials of
    its slices' packed rows, added in slice order."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g, step, scale = h // hkv, bwd_step(d), 1.0 / math.sqrt(d)
    qp, dop = _packed(q, hkv), _packed(do, hkv)
    stat = lambda x: x.reshape(b, hkv, g, t).transpose(2, 3).reshape(b, hkv, -1)
    lse_p = stat(lse)
    delta_p = stat((do * o).sum(-1).transpose(1, 2))
    pos = torch.arange(t * g) // g
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt in range(-(-t // BWD_KEYS)):
        keys = torch.arange(kt * BWD_KEYS, min(kt * BWD_KEYS + BWD_KEYS, t))
        kk = k[:, keys].transpose(1, 2)  # (B, Hkv, keys, D)
        vv = v[:, keys].transpose(1, 2)
        pk = torch.zeros_like(kk)
        pv = torch.zeros_like(vv)
        for lo, hi in dkdv_slices(t, g, d, kt, per):
            m = torch.arange(lo * step, min(hi * step, t * g))
            s = torch.einsum("bkmd,bknd->bkmn", qp[:, :, m], kk) * scale
            vis = (keys[None, :] <= pos[m][:, None])[None, None] & (
                kvalid[:, keys] != 0)[:, None, None, :]
            p = torch.where(vis, torch.exp(s - lse_p[:, :, m, None]), torch.tensor(0.0))
            dp = torch.einsum("bkmd,bknd->bkmn", dop[:, :, m], vv)
            ds = p * (dp - delta_p[:, :, m, None]) * scale
            pk = pk + torch.einsum("bkmn,bkmd->bknd", ds, qp[:, :, m])
            pv = pv + torch.einsum("bkmn,bkmd->bknd", p, dop[:, :, m])
        dk[:, keys] = pk.transpose(1, 2)
        dv[:, keys] = pv.transpose(1, 2)
    return dk, dv


def _f32(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("b,t,h,hkv,d", PHASE2[:3] + [(1, 77, 8, 2, 32), (2, 300, 6, 2, 64)])
def test_partials_summed_in_slice_order_equal_the_plain_backward(b, t, h, hkv, d):
    rng = np.random.default_rng(t + h + d)
    q, k, v, do = (_f32(rng, s) for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d),
                                          (b, t, h, d)))
    n_split, per = train_bwd_plan(b, t, h, hkv, d, H100_SMS)
    assert n_split > 1  # the shapes split: the replay sums several partials
    for pads in ((0, 0), (t // 6, t // 3)):  # two kvalid, one plan
        kvalid = torch.ones(b, t, dtype=torch.int32)
        for i, n in enumerate(pads[:b]):
            if n:
                kvalid[i, -n:] = 0
        dom = do * kvalid[:, :, None, None]
        o, lse = flash_train_forward_reference(q, k, v, kvalid)
        _, want_k, want_v = flash_train_backward_reference(q, k, v, kvalid, o, lse, dom)
        got_k, got_v = _sliced_dk_dv(q, k, v, kvalid, o, lse, dom, per)
        for got, want in ((got_k, want_k), (got_v, want_v)):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), err


# -- (c) the bf16 plain versions against the Pallas kernels -----------------------------


def test_bf16_plain_versions_match_pallas_interpret_at_jax_tiny_widths():
    b, t, h, hkv, d = 2, 200, 2, 1, 32
    rng = np.random.default_rng(23)
    bf = lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32), jnp.bfloat16)
    q, k, v = bf((b, t, h, d)), bf((b, t, hkv, d)), bf((b, t, hkv, d))
    kvalid = np.ones((b, t), bool)
    kvalid[1, -37:] = False  # phase 3b's padded row
    ct = bf((b, t, h, d)) * jnp.asarray(kvalid[:, :, None, None], jnp.bfloat16)
    tr = lambda x: jnp.transpose(x, (0, 2, 1, 3))
    want_o, want_lse = jtrain._fwd(tr(q), tr(k), tr(v), jnp.asarray(kvalid, jnp.int32), True)
    want_g = jax.grad(
        lambda *a: jnp.vdot(jtrain.flash_train_attention(*a, jnp.asarray(kvalid), True)
                            .astype(jnp.float32), ct.astype(jnp.float32)),
        argnums=(0, 1, 2))(q, k, v)

    th = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    tq, tk, tv, tct = th(q), th(k), th(v), th(ct)
    tkv = torch.from_numpy(kvalid.astype(np.int32))
    o, lse = flash_train_forward_reference(tq, tk, tv, tkv)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_o = torch.from_numpy(np.array(tr(want_o).astype(jnp.float32)))
    valid = torch.from_numpy(kvalid)[:, :, None, None]
    err = ((o.float() - want_o).abs() * valid)
    assert (err <= 1e-3 + 2 ** -7 * want_o.abs()).all(), err.max().item()
    want_lse = torch.from_numpy(np.array(want_lse))
    assert ((lse - want_lse).abs() * torch.from_numpy(kvalid)[:, None, :]).max() <= 1e-5

    grads = flash_train_backward_reference(tq, tk, tv, tkv, o, lse, tct)
    for name, got, want in zip("qkv", grads, want_g):
        assert got.dtype == torch.bfloat16
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        err = (got.float() - want).abs().max().item()
        assert err <= 2 ** -8 * want.abs().max().item(), (f"d{name}", err)
