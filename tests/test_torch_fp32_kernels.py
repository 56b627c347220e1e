"""The fp32 kernels on the tensor cores ("fp32_tc"), their arithmetic on the CPU.

`csrc/int4_mm.cuh:int4_tf32_kernel` (the int4 matmul on fp32 x, B > 8) and
`csrc/flash_fp32.cu:attn_tf32_kernel` (the fp32 prefill and prefix-cache
suffix) run fp32 products as sums of TF32 terms on the tensor cores. The
plain models below replay that arithmetic step by step, and are held here
to the JAX package on numpy inputs from a seed:

  * `tf32_split`: both terms are TF32 values (13 low significand bits 0)
    and x - big - small is within 2^-20 |x|;
  * `int4_matmul_tf32_model` (passes over the groups, the low nibbles' then
    the high nibbles', big @ q + small @ q in fp32, s * that added into y)
    equals the JAX package's `int4_matmul_reference` on fp32 x within 1e-5
    of |x| @ |W| + 1e-6 (x's split and the order of the fp32 sums; the
    bound the card tests hold the kernel to), and its Pallas `int4_matmul`
    in interpret mode within 2^-8 of |x| @ |W| + 1e-6 (that kernel's W is
    bf16 under fp32 x too, rn_bf16(q * rn_bf16(s)): two roundings of each
    weight), at the group sizes the quantizer writes
    (128 at s2-pro's widths, 16 and 32 at JAX's tiny ones) and at groups
    that cut a stage (12) or fill it with one row (2);
  * `fp32_tc_plan` picks a tile shape and a split of the groups into runs
    (at most one run a group), never leaves more blocks than fit on the
    card where it splits, and splits only where the tiles alone leave SMs
    idle;
  * `prefill_tf32_model` (the G heads of a KV head packed into blocks of 64
    rows, tiles of 64 or 32 keys, S and P V in 3xTF32, an online softmax)
    equals the Pallas `flash_prefill_attention` in interpret mode within
    2e-5 (fp32 outputs of rms ~1: the 2^-19 products and the sums' order),
    with rows before an offset (averaging all T keys) and D = 32, 64, 128;
  * `suffix_tf32_model` (the same walk over one cache layer, the keys of a
    row tile cut into `suffix_slices` and merged by their softmax states in
    slice order) equals JAX's einsum suffix (`gqa_attention` /
    `gqa_attention_kv8` over the cache under the suffix mask, as
    `dual_ar.prefill_suffix` runs it) within 2e-5, over an fp32 and an int8
    cache, at starts where the plan splits the keys into several slices.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import attention as jattn
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu.ops.pallas_attention import flash_prefill_attention as j_prefill
from fish_speech_tpu.ops.pallas_int4 import int4_matmul as j_int4_matmul
from fish_speech_tpu.ops.pallas_int4 import int4_matmul_reference as j_int4_reference
from fish_speech_tpu_torch.ops import flash_prefill as tfp
from fish_speech_tpu_torch.ops import int4 as tint4
from fish_speech_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(1)

H100_SMS = 132
H100_RESIDENT = (3, 4, 8, 2)  # blocks of each tile shape an SM holds (CUDA's calculator)


TF32_BITS = 13  # low fp32 significand bits a TF32 value drops


def tf32_trunc(x):
    """fp32 x with its 13 low significand bits cleared: a TF32 value, x
    rounded toward zero."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~((1 << TF32_BITS) - 1)).view(torch.float32)


def tf32_split(x):
    """(big, small): x = big + small to within 2^-20 |x|, both TF32 values
    (`csrc/tf32.cuh:split`: big = tf32_trunc(x), small = tf32_trunc(x -
    big), x - big exact in fp32)."""
    big = tf32_trunc(x)
    return big, tf32_trunc(x.float() - big)


def int4_matmul_tf32_model(x, p, gs):
    """The "fp32_tc" kernel's arithmetic in plain PyTorch: passes over the
    groups, the low nibbles' group j and then the high nibbles' (the same
    packed rows), each summing big @ q + small @ q in fp32 (x split as
    `tf32_split`; q exact) and adding s[group] * that into y in fp32, in
    pass order. Only the order of the sums inside a pass differs from the
    kernel's. x (B, I) fp32 -> (B, O) fp32."""
    half = p.shape[-2]
    g = tint4._group(2 * half, gs.shape[-2])
    q = tint4.unpack_int4(p).float()
    big, small = tf32_split(x)
    y = torch.zeros((x.shape[0], p.shape[-1]), dtype=torch.float32, device=x.device)
    for j in range(half // g):
        for h in (0, 1):
            rows = slice(h * half + j * g, h * half + (j + 1) * g)
            acc = big[:, rows] @ q[rows] + small[:, rows] @ q[rows]
            y = y + gs[h * (half // g) + j].float() * acc
    return y


def _tf32_walk(qp, k, v, lo, hi, lim, vis, off, scale, ks=None, vs=None):
    """The fp32 kernel's walk of keys [lo, hi) by one block's packed rows
    qp (R, D) over one KV head's k/v (S, D) (int8 with scales ks/vs (S,)
    under the int8 cache): tiles of 64 keys (32 at D = 128), keys at or
    past lim zero and scoring -inf, key j of row r masked (NEG_INF) unless
    off <= j <= vis[r]; S and P V in 3xTF32 (two terms of the exact int8
    values), an online softmax, P times vs before P V. Returns (m, l, o),
    fp32."""
    tile = 32 if qp.shape[-1] == 128 else 64  # `csrc/flash_fp32.cu` `Layout::BK`
    n_keys = k.shape[0]
    qb, qm = tf32_split(qp)
    m = torch.full(qp.shape[:1], -math.inf)
    l = torch.zeros(qp.shape[:1])
    o = torch.zeros(qp.shape)
    for k0 in range(lo, hi, tile):
        key = torch.arange(k0, k0 + tile)
        ok = key < lim
        kt = torch.where(ok[:, None], k[key.clamp_max(n_keys - 1)].float(), 0.0)
        vt = torch.where(ok[:, None], v[key.clamp_max(n_keys - 1)].float(), 0.0)
        if ks is None:
            kb, km = tf32_split(kt)
            s = (qb @ kb.T + qb @ km.T + qm @ kb.T) * scale
        else:
            s = (qb @ kt.T + qm @ kt.T) * (ks[key.clamp_max(n_keys - 1)].float() * scale)
        s = torch.where((key[None, :] > vis[:, None]) | (key[None, :] < off),
                        torch.tensor(NEG_INF), s)
        s = torch.where(ok[None, :], s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * alpha + p.sum(-1)
        if vs is not None:
            p = p * torch.where(ok, vs[key.clamp_max(n_keys - 1)].float(), 0.0)
        pb, pm = tf32_split(p)
        if ks is None:
            vb, vm = tf32_split(vt)
            pv = pb @ vb + pb @ vm + pm @ vb
        else:
            pv = pb @ vt + pm @ vt
        o = o * alpha[:, None] + pv
        m = m_new
    return m, l, o


def prefill_tf32_model(q, k, v, offsets):
    """The "fp32_tc" prefill kernel's arithmetic in plain PyTorch: the G
    heads of each KV head packed into blocks of 64 rows (`_pack_rows`),
    each block walking keys [0, its last position + 1), or all T where its
    first row lies before the offset (such a row sees no key and averages
    all T), in `_tf32_walk`'s tiles. Same contract as
    `flash_prefill_reference` (fp32)."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    qp = tfp._pack_rows(q, n_kv).float()
    out = torch.empty(qp.shape)
    for bi in range(b):
        off = int(offsets[bi])
        for hk in range(n_kv):
            for m0 in range(0, t * g, tfp.SUFFIX_ROWS):
                rows = torch.arange(m0, min(m0 + tfp.SUFFIX_ROWS, t * g))
                pos = rows // g
                hi = t if m0 // g < off else int(pos[-1]) + 1
                m, l, o = _tf32_walk(qp[bi, hk, rows], k[bi, :, hk], v[bi, :, hk], 0, hi,
                                     t, pos, off, 1.0 / math.sqrt(d))
                out[bi, hk, rows] = o / l[:, None]
    return out.reshape(b, n_kv, t, g, d).permute(0, 2, 1, 3, 4).reshape(b, t, h, d)


def suffix_tf32_model(q, cache, layer: int, start: int, tiles_per_slice: int):
    """The fp32 suffix kernel's arithmetic in plain PyTorch: blocks of 64
    packed rows, each row tile's keys [0, start + i_last + 1) cut into the
    slices of `suffix_slices` (runs of `tiles_per_slice` 64-key units), each
    slice walked by `_tf32_walk` into (m, l, O), the slices merged in slice
    order: O = sum_z exp(m_z - max) O_z / sum_z exp(m_z - max) l_z. Same
    contract as `flash_suffix_reference` (fp32 q)."""
    kv8 = "ks" in cache
    b, ts, h, d = q.shape
    n_kv = cache["k"].shape[3]
    g = h // n_kv
    qp = tfp._pack_rows(q, n_kv).float()
    out = torch.empty(qp.shape)
    for bi in range(b):
        for hk in range(n_kv):
            kc, vc = cache["k"][layer, bi, :, hk], cache["v"][layer, bi, :, hk]
            ks = cache["ks"][layer, bi, :, hk] if kv8 else None
            vs = cache["vs"][layer, bi, :, hk] if kv8 else None
            for rt in range(tfp.suffix_row_tiles(ts, g)):
                r0 = rt * tfp.SUFFIX_ROWS
                rows = torch.arange(r0, min(r0 + tfp.SUFFIX_ROWS, ts * g))
                vis = start + rows // g
                states = [_tf32_walk(qp[bi, hk, rows], kc, vc, lo, hi, start + ts, vis, 0,
                                     1.0 / math.sqrt(d), ks, vs)
                          for lo, hi in tfp.suffix_slices(start, ts, g, rt, tiles_per_slice)]
                mx = torch.stack([m for m, _, _ in states]).amax(0)
                tot = torch.zeros_like(mx)
                acc = torch.zeros(len(rows), d)
                for m, l, o in states:
                    f = torch.exp(m - mx)
                    tot = tot + l * f
                    acc = acc + o * f[:, None]
                out[bi, hk, rows] = acc / tot[:, None]
    return out.reshape(b, n_kv, ts, g, d).permute(0, 2, 1, 3, 4).reshape(b, ts, h, d)


def test_tf32_split_terms_are_tf32_and_sum_to_x():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)
                         * np.float32(10.0) ** np.random.default_rng(1).integers(-8, 8, 4096))
    big, small = tf32_split(x)
    low = (1 << TF32_BITS) - 1
    for t in (big, small):
        assert int((t.view(torch.int32) & low).abs().sum()) == 0
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -20 * x.double().abs()).all())


def _int4_case(b, i, o, g, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((i, o)).astype(np.float32) * 0.02
    qw = jquant.quantize_int4(jnp.asarray(w), group_size=g)
    x = rng.standard_normal((b, i)).astype(np.float32)
    return x, np.array(qw["p"]), np.array(qw["gs"])


@pytest.mark.parametrize("b,i,o,g", [(9, 256, 136, 128), (33, 256, 200, 16),
                                     (64, 64, 256, 32), (40, 192, 72, 12),
                                     (20, 64, 24, 2), (130, 512, 64, 128)])
def test_int4_tf32_model_matches_jax(b, i, o, g):
    x, p, gs = _int4_case(b, i, o, g, seed=b + i + o + g)
    got = int4_matmul_tf32_model(torch.from_numpy(x), torch.from_numpy(p),
                                       torch.from_numpy(gs)).numpy()
    ref = np.asarray(j_int4_reference(jnp.asarray(x), jnp.asarray(p), jnp.asarray(gs)))
    kern = np.asarray(j_int4_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(gs),
                                    interpret=True))
    w = tint4.int4_matmul_reference(torch.eye(i), torch.from_numpy(p),
                                    torch.from_numpy(gs)).numpy()  # W = q * s
    scale = np.abs(x) @ np.abs(w)
    err = np.abs(got - ref)
    assert (err <= 1e-5 * scale + 1e-6).all(), err.max()
    # the Pallas kernel multiplies fp32 x by its bf16 W, rn_bf16(q * rn_bf16(s)):
    # two bf16 roundings of each weight
    err = np.abs(got - kern)
    assert (err <= 2.0 ** -8 * scale + 1e-6).all(), err.max()


@pytest.mark.parametrize("b,i,o", [(9, 2560, 6144), (9, 4096, 2560), (128, 4096, 2560),
                                   (128, 9728, 2560), (128, 2560, 19456),
                                   (1024, 2560, 19456), (1024, 9728, 2560), (64, 32, 64)])
def test_fp32_tc_plan(b, i, o):
    g = 128 if i >= 256 else 16
    tile, n = tint4.fp32_tc_plan(b, i, o, g, H100_SMS, H100_RESIDENT)
    assert 0 <= tile < len(tint4.FP32_TC_TILES)
    groups = i // 2 // g
    assert 1 <= n <= min(tint4.FP32_TC_MAX_SPLIT, groups)
    bm, bn = tint4.FP32_TC_TILES[tile]
    blocks = -(-b // bm) * -(-o // bn)
    fit = H100_SMS * H100_RESIDENT[tile]
    if n > 1:  # a split only where the tiles alone leave room, and within it
        assert blocks < fit and blocks * n <= fit
    assert tint4.fp32_tc_plan(b, i, o, g, H100_SMS, H100_RESIDENT) == (tile, n)


def test_fp32_tc_plan_splits_the_narrow_products():
    """s2-pro's wo (O = 2560) at 9 and 128 rows leaves SMs idle in one run:
    the plan splits its groups; the slow w13 at 1024 rows takes the wgmma
    tile shape (64 x 128) in one run."""
    assert tint4.fp32_tc_plan(9, 4096, 2560, 128, H100_SMS, H100_RESIDENT)[1] > 1
    assert tint4.fp32_tc_plan(128, 4096, 2560, 128, H100_SMS, H100_RESIDENT)[1] > 1
    assert tint4.fp32_tc_plan(1024, 2560, 19456, 128, H100_SMS, H100_RESIDENT) == (3, 1)


def _prefill_case(b, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)))


@pytest.mark.parametrize("b,t,h,hkv,d,offsets", [(1, 64, 4, 2, 64, [0]),
                                                 (2, 96, 2, 1, 32, [0, 40]),
                                                 (1, 128, 8, 2, 128, [0]),
                                                 (2, 64, 4, 1, 32, [17, 0])])
def test_prefill_tf32_model_matches_the_pallas_kernel(b, t, h, hkv, d, offsets):
    q, k, v = _prefill_case(b, t, h, hkv, d, seed=t + d + b)
    off = np.asarray(offsets, dtype=np.int32)
    got = prefill_tf32_model(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(off)).numpy()
    want = np.asarray(j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(off), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _suffix_cache(rng, kv8, b, s, hkv, d, layers=2):
    shape = (layers, b, s, hkv, d)
    if kv8:
        cache = {n: torch.from_numpy(rng.integers(-127, 128, size=shape)).to(torch.int8)
                 for n in ("k", "v")}
        for n in ("ks", "vs"):
            cache[n] = torch.from_numpy(rng.uniform(0.02, 0.03, size=shape[:4])).to(
                torch.bfloat16)
        return cache
    return {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for n in ("k", "v")}


def _jax_suffix(q, cache, layer, start):
    """JAX's einsum suffix: `gqa_attention` (`gqa_attention_kv8` under the
    int8 cache) over the whole cache layer, key j visible to query i iff
    j <= start + i, in fp32."""
    ts, s = q.shape[1], cache["k"].shape[2]
    i, j = np.arange(ts), np.arange(s)
    mask = jnp.asarray((j[None, :] <= start + i[:, None])[None])
    c = {n: jnp.asarray(x[layer].float().numpy()) for n, x in cache.items()}
    qj = jnp.asarray(q.numpy())
    if "ks" in cache:
        return np.asarray(jattn.gqa_attention_kv8(qj, c["k"], c["ks"], c["v"], c["vs"], mask))
    return np.asarray(jattn.gqa_attention(qj, c["k"], c["v"], mask))


# (B, Ts, S, H, Hkv, D, start): JAX's tiny slow cache at start 140; a row
# tile's keys over several slices (S = 600, start 400: ten 64-key slices);
# start + Ts = S; one query; D = 128 with 32-key tiles
SUFFIX_CASES = [(1, 64, 264, 2, 1, 32, 140), (1, 64, 600, 4, 1, 32, 400),
                (2, 24, 200, 8, 2, 64, 176), (1, 1, 264, 4, 1, 64, 150),
                (1, 40, 300, 8, 2, 128, 99)]


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("b,ts,s,h,hkv,d,start", SUFFIX_CASES)
def test_suffix_tf32_model_matches_jax(kv8, b, ts, s, h, hkv, d, start):
    rng = np.random.default_rng(start + 3 * b + kv8)
    q = torch.from_numpy(rng.standard_normal((b, ts, h, d)).astype(np.float32))
    cache = _suffix_cache(rng, kv8, b, s, hkv, d)
    _, z, per = tfp.suffix_plan(s, hkv, b, ts, h // hkv, H100_SMS, tfp.SUFFIX_ROWS)
    if (b, s, start) == (1, 600, 400):  # the plan splits this row tile's keys
        assert len(tfp.suffix_slices(start, ts, h // hkv, 0, per)) > 1
    got = suffix_tf32_model(q, cache, 1, start, per).numpy()
    np.testing.assert_allclose(got, _jax_suffix(q, cache, 1, start), atol=2e-5, rtol=0)
    want = tfp.flash_suffix_reference(q, cache, 1, torch.tensor([start], dtype=torch.int32))
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=0)


def test_fp32_suffix_plan_takes_64_rows():
    """The fp32 suffix kernel's blocks are 64 rows: its plan fixes them, and
    at the serving cache's one request it splits the keys as the 16-bit
    kernel's plan at 64 rows does."""
    assert tfp.suffix_plan(2176, 8, 1, 64, 4, H100_SMS, tfp.SUFFIX_ROWS) == (64, 7, 5)
    assert tfp.suffix_plan(2176, 8, 16, 64, 4, H100_SMS, tfp.SUFFIX_ROWS)[0] == 64


# every int4 product the port serves, (I, O, g): s2-pro's slow and fast
# stacks (w1 and w3 apart, and fused as w13), then JAX's tiny ones at the
# group sizes the quantizer picks there
SERVED_INT4 = [(2560, 6144, 128), (4096, 2560, 128), (2560, 9728, 128), (2560, 19456, 128),
               (9728, 2560, 128), (1536, 2560, 128), (1536, 1536, 128), (1536, 6144, 128),
               (1536, 12288, 128), (6144, 1536, 128), (64, 128, 32), (64, 64, 32),
               (64, 256, 32), (128, 64, 64), (32, 64, 16), (32, 32, 16), (32, 128, 16),
               (64, 32, 32)]


def test_fp32_tc_plan_picks_every_tile_shape():
    """Over every served product at B = 9..4096 rows the plan picks each
    tile shape the kernel builds somewhere: no shape is dead code."""
    picked = {tint4.fp32_tc_plan(b, i, o, g, H100_SMS, H100_RESIDENT)[0]
              for i, o, g in SERVED_INT4 for b in range(9, 4097)}
    assert picked == set(range(len(tint4.FP32_TC_TILES)))
