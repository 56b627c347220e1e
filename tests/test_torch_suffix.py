"""The tensor-core suffix kernel's packing, split and merge, on the CPU.

`csrc/flash_prefill.cu:suffix_wgmma_kernel` packs the G heads of a KV head
into a block's 64 or 128 query rows, splits the keys over Z slices picked
from the shape alone (`suffix_plan`) and merges the slices' softmax states
in the launch. Here:

  * the slices of every row tile cover its keys [0, start + i_last + 1)
    once, in order, whatever the start; the plan never depends on the
    start, and at one request's hit on the serving cache about one block
    per SM has keys to read;
  * `suffix_states_reference` + `merge_suffix_states` (the kernel's walk,
    step by step: with 64 rows a block two warpgroups taking tiles in turn
    and their join, with 128 one walk of every tile, an online softmax per
    64-key tile, the slices' merge in order) equal
    `flash_suffix_reference` and JAX's `gqa_attention` /
    `gqa_attention_kv8` over the cache under the suffix mask: in fp32
    within 2e-5 (only the order of the sums differs); with bf16 and fp16 q
    (P rounded to q's dtype before P V, as the kernel does) within 2 ulps
    of q's dtype at max |out| of the fp32 answer, plus the output's own
    rounding. Cases: start 0, start + Ts = S, Ts = 1, a start on a slice
    edge, B = 16, D = 64 and 128, a bf16/fp16 and an int8 cache.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import attention as jattn
from fish_speech_tpu_torch.ops import flash_prefill as tfp

torch.set_num_threads(1)

H100_SMS = 132


@pytest.mark.parametrize("n_sm", [H100_SMS, 114])
@pytest.mark.parametrize("s,hkv,b,ts,g", [
    (2176, 8, 1, 64, 4), (2176, 8, 1, 128, 4), (2176, 8, 4, 64, 4),
    (2176, 8, 16, 64, 4), (264, 2, 1, 40, 4), (300, 2, 3, 7, 3), (64, 1, 1, 1, 8)])
def test_suffix_slices_cover_every_key_once(s, hkv, b, ts, g, n_sm):
    br, z, per = tfp.suffix_plan(s, hkv, b, ts, g, n_sm)
    assert br in (64, 128) and 1 <= z <= tfp.SUFFIX_MAX_SPLIT and per >= 1
    assert z * per * tfp.SUFFIX_KEYS >= s > (z - 1) * per * tfp.SUFFIX_KEYS
    rows = ts * g
    for start in sorted({x for x in (0, 1, 63, 64, 127, per * 64, s // 2, s - ts)
                         if x <= s - ts}):
        for rt in range(tfp.suffix_row_tiles(ts, g, br)):
            slices = tfp.suffix_slices(start, ts, g, rt, per, br)
            last = min((rt + 1) * br, rows) - 1
            assert len(slices) <= z
            assert slices[0][0] == 0 and slices[-1][1] == start + last // g + 1
            for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
                assert hi == lo2 and lo % (per * tfp.SUFFIX_KEYS) == 0
            assert all(lo < hi for lo, hi in slices)


def test_one_request_hit_puts_about_one_block_on_each_sm():
    # the serving cache (S = 2048 + 128, Hkv = 8, G = 4) at start 951: one
    # request's 256 rows a KV head in 64-row blocks whose warpgroups take
    # the tiles in turn
    br, z, per = tfp.suffix_plan(2176, 8, 1, 64, 4, H100_SMS)
    assert (br, z, per) == (64, 7, 5)
    busy = sum(len(tfp.suffix_slices(951, 64, 4, rt, per, br))
               for rt in range(tfp.suffix_row_tiles(64, 4, br))) * 8
    assert 0.9 * H100_SMS <= busy <= H100_SMS
    # a group of 4: 64-row blocks fill one wave, no split; of 16: 128-row
    # blocks alone fill the card, no split, so no partials
    assert tfp.suffix_plan(2176, 8, 4, 64, 4, H100_SMS) == (64, 2, 17)
    assert tfp.suffix_plan(2176, 8, 16, 64, 4, H100_SMS) == (128, 1, 34)


def _case(rng, kv8, dtype, b, ts, s, h, hkv, d, layers=2):
    """q in `dtype` and a stacked cache: `dtype` k/v from N(0, 1), or int8
    k/v with bf16 scales of about 1/40 (unit-scale values either way)."""
    q = torch.from_numpy(rng.normal(size=(b, ts, h, d)).astype(np.float32)).to(dtype)
    shape = (layers, b, s, hkv, d)
    if kv8:
        cache = {n: torch.from_numpy(rng.integers(-127, 128, size=shape)).to(torch.int8)
                 for n in ("k", "v")}
        for n in ("ks", "vs"):
            cache[n] = torch.from_numpy(rng.uniform(0.02, 0.03, size=shape[:4])).to(
                torch.bfloat16)
    else:
        cache = {n: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                 for n in ("k", "v")}
    return q, cache


def _jax(q, cache, layer, start):
    """JAX's `gqa_attention` (or `gqa_attention_kv8`) over the whole cache
    layer under the suffix mask, in fp32."""
    ts, s = q.shape[1], cache["k"].shape[2]
    i, j = np.arange(ts), np.arange(s)
    mask = jnp.asarray((j[None, :] <= start + i[:, None])[None])
    c = {n: jnp.asarray(x[layer].float().numpy()) for n, x in cache.items()}
    qj = jnp.asarray(q.float().numpy())
    if "ks" in cache:
        return np.asarray(jattn.gqa_attention_kv8(qj, c["k"], c["ks"], c["v"], c["vs"], mask))
    return np.asarray(jattn.gqa_attention(qj, c["k"], c["v"], mask))


def _ulp(x, dtype):
    """One ulp of `dtype` (bf16: 8 significant bits, fp16: 11) at |x|."""
    bits = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    return 2.0 ** (math.floor(math.log2(abs(x))) - (bits - 1))


# (B, Ts, S, H, Hkv, D, start): start 0; start + Ts = S; Ts = 1; a start on
# a slice edge (64 keys a slice at these shapes); B = 16; D = 64 and 128
CASES = [(1, 40, 264, 8, 2, 64, 0), (2, 24, 200, 8, 2, 64, 176),
         (1, 1, 264, 4, 1, 64, 150), (1, 40, 264, 8, 2, 128, 128),
         (16, 5, 130, 4, 2, 64, 70), (1, 33, 300, 6, 2, 128, 99)]


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("b,ts,s,h,hkv,d,start", CASES)
def test_suffix_split_replay_matches_reference_and_jax_fp32(kv8, rows, b, ts, s, h,
                                                            hkv, d, start):
    rng = np.random.default_rng(start + 7 * b + kv8)
    q, cache = _case(rng, kv8, torch.float32, b, ts, s, h, hkv, d)
    _, z, per = tfp.suffix_plan(s, hkv, b, ts, h // hkv, H100_SMS)
    states = tfp.suffix_states_reference(q, cache, 1, start, per, rows)
    if start + ts > per * tfp.SUFFIX_KEYS:  # keys past one slice: the merge runs
        assert max(len(v) for v in states.values()) > 1
    got = tfp.merge_suffix_states(states, q, hkv, rows)
    st = torch.tensor([start], dtype=torch.int32)
    want = tfp.flash_suffix_reference(q, cache, 1, st)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax(q, cache, 1, start), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("b,ts,s,h,hkv,d,start", CASES[:2] + CASES[4:5])
def test_suffix_split_replay_16bit_within_two_ulps(dtype, kv8, rows, b, ts, s, h, hkv,
                                                   d, start):
    """The kernel rounds P (times vs) to q's dtype once before P V: against
    the fp32 answer on the same (16-bit) inputs the replay stays within
    2 ulps of q's dtype at max |out|, plus the output's rounding."""
    rng = np.random.default_rng(start + 11 * b + kv8)
    q, cache = _case(rng, kv8, dtype, b, ts, s, h, hkv, d)
    _, _, per = tfp.suffix_plan(s, hkv, b, ts, h // hkv, H100_SMS)
    got = tfp.merge_suffix_states(
        tfp.suffix_states_reference(q, cache, 1, start, per, rows), q, hkv, rows).float()
    c32 = {n: (x.float() if n in ("k", "v") and not kv8 else x) for n, x in cache.items()}
    want = tfp.flash_suffix_reference(q.float(), c32, 1, torch.tensor([start], dtype=torch.int32))
    peak = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 2 * _ulp(peak, dtype) + _ulp(peak, dtype) / 2, (err, peak)
