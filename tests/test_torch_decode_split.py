"""The split arithmetic of the decode attention and the int4 matvec kernels,
on the CPU.

The decode kernel cuts each row's positions into Z slices
(`decode_split_count`, `decode_slice`) and merges their softmax states in
split order; the int4 matvec kernel cuts the packed rows into runs of whole
groups (`gemv_split`) and adds the runs' partial sums in split order. Both
kernels run only on the card; these tests hold the same arithmetic, replayed
in plain PyTorch, to the plain versions and to the JAX package:

  * the slices cover [0, len) exactly once for every len in 1..S, and the
    runs cover the packed rows once, on group boundaries;
  * merging the plain per-slice states in split order equals
    `flash_decode_reference` within 1e-6 (fp32, only the order of the sums
    differs) and the Pallas decode kernel in interpret mode within 1e-5
    (`tests/test_torch_ops.py`'s tolerance);
  * the plain per-run partials, added in run order, equal the int4 plain
    versions' fp32 sums (before the cast to x's dtype) within 1e-5 of
    |x| @ |W| (fp32 sums in another order);
  * the int8-KV kernel's per-slice states (`decode_partial_kv8_reference`:
    the scales folded in, p * vs carried as the kernel carries it), merged
    in split order, equal `flash_decode_kv8_reference` for every len in
    1..S: within 1e-6 for fp32 q (only the order of the sums differs) and
    within kernel 2's bf16 bounds for bf16 q (2e-2 max, 2e-3 mean: the
    plain version rounds p * vs to bf16 once, the kernel keeps it as two
    bf16 terms); and the JAX package's `gqa_attention_kv8` masked to
    j < len within 1e-5 (fp32) or the same bf16 bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops.attention import gqa_attention_kv8 as j_gqa_kv8
from fish_speech_tpu.ops.pallas_decode import \
    flash_decode_attention as j_flash_decode
from fish_speech_tpu_torch.models.dual_ar import _kv_quant
from fish_speech_tpu_torch.ops.flash_decode import (
    MAX_SPLIT, decode_partial_kv8_reference, decode_partial_reference,
    decode_slice, decode_split_count, flash_decode_kv8_reference,
    flash_decode_reference, merge_decode_states)
from fish_speech_tpu_torch.ops.int4 import (GEMV_COLS, GEMV_MAX_SPLIT,
                                             gemv_partials_reference,
                                             gemv_split, int4_dequant_bf16,
                                             int4_matmul_bf16w_reference,
                                             int4_matmul_reference)
from fish_speech_tpu_torch.ops.quant import (_int4_effective_weight,
                                             quantize_int4)

torch.set_num_threads(1)
H100_SMS = 132

# (S, Hkv, B): the fast cache, a small batched cache, the serving session's
# slow cache (2048 + 64) and the 4096-context one (4096 + 64)
CACHES = [(10, 4, 1), (300, 2, 3), (2112, 8, 1), (4160, 8, 1)]

# s2-pro's eight B=1 int4 shapes (I -> O, w13 fused), g = 128
INT4_SHAPES = [(2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560),
               (1536, 2560), (1536, 1536), (1536, 12288), (6144, 1536)]


@pytest.mark.parametrize("n_sm", [H100_SMS, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize("s,hkv,b", CACHES)
def test_decode_slices_cover_every_length_once(s, hkv, b, n_sm):
    z = decode_split_count(s, hkv, b, n_sm)
    assert 1 <= z <= MAX_SPLIT
    for length in range(1, s + 1):
        cover = 0
        for i in range(z):
            start, end = decode_slice(i, z, length, s)
            if start < end:  # the slices with work follow one another
                assert start == cover, (length, i, start, cover)
                cover = end
            else:  # past the length: no work
                assert start == end == length, (length, i, start, end)
        assert cover == length, (length, cover)


def test_decode_split_covers_the_card_at_long_context():
    """At batch 1 (S = 4160, 8 KV heads) the grid covers all 132 SMs; at
    len 4000 the 256-position slices put 128 blocks to work, in one wave;
    the fast cache is one slice."""
    z = decode_split_count(4160, 8, 1, H100_SMS)
    assert 8 * z >= H100_SMS
    busy = sum(a < e for a, e in (decode_slice(i, z, 4000, 4160) for i in range(z)))
    assert 8 * busy == 128
    assert decode_split_count(10, 4, 1, H100_SMS) == 1


def _split_replay(q, k, v, layer, lengths, s):
    b, hkv = q.shape[:2]
    z = decode_split_count(s, hkv, b, H100_SMS)
    states = []
    for i in range(z):
        bounds = [decode_slice(i, z, int(n), s) for n in lengths]
        states.append(decode_partial_reference(
            q, k, v, layer, [a for a, _ in bounds], [e for _, e in bounds]))
    return merge_decode_states(states, q.dtype)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_decode_split_merge_matches_the_plain_version(g, d):
    rng = np.random.default_rng(g * d)
    n_layer, b, s, hkv = 2, 3, 300, 2
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((n_layer, b, s, hkv, d))
                             .astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([1, 157, 300], dtype=torch.int32)
    for layer in range(n_layer):
        got = _split_replay(q, k, v, layer, lengths, s)
        want = flash_decode_reference(q, k, v, layer, lengths)
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("g,lengths", [(4, [1, 300]), (3, [257, 10]),
                                       (8, [512, 33])])
def test_decode_split_merge_matches_pallas_interpret(g, lengths):
    rng = np.random.default_rng(g + 7)
    n_layer, b, s, hkv, d, gp = 2, 2, 512, 2, 64, 8
    q = np.zeros((b, hkv, gp, d), np.float32)  # JAX side: G padded to Gp
    q[:, :, :g] = rng.standard_normal((b, hkv, g, d))
    k, v = (rng.standard_normal((n_layer, b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    for layer in range(n_layer):
        want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.int32(layer), jnp.asarray(lens),
                              interpret=True)[:, :, :g]
        got = _split_replay(torch.from_numpy(q[:, :, :g].copy()),
                            torch.from_numpy(k), torch.from_numpy(v), layer,
                            torch.from_numpy(lens), s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def _kv8_split_replay(q, k, ks, v, vs, layer, lengths, s, z):
    states = []
    for i in range(z):
        bounds = [decode_slice(i, z, int(n), s) for n in lengths]
        states.append(decode_partial_kv8_reference(
            q, k, ks, v, vs, layer, [a for a, _ in bounds],
            [e for _, e in bounds]))
    return merge_decode_states(states, q.dtype)


def _assert_within(got, want, dtype, fp32_atol):
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= fp32_atol, err.max().item()
    else:
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, \
            (err.max().item(), err.mean().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_kv8_split_merge_matches_the_plain_version_and_jax(g, dtype):
    """Row b of the batch attends its first b + 1 positions, so one batch
    checks every len in 1..S; the split is a one-row call's (S = 80 over
    Hkv = 2 gives 5 slices of 16)."""
    rng = np.random.default_rng(100 + g)
    n_layer, s, hkv, d = 2, 80, 2, 64
    b = s
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d))
                         .astype(np.float32)).to(dtype)
    k, ks = _kv_quant(torch.from_numpy(
        rng.standard_normal((n_layer, b, s, hkv, d)).astype(np.float32)))
    v, vs = _kv_quant(torch.from_numpy(
        rng.standard_normal((n_layer, b, s, hkv, d)).astype(np.float32)))
    lengths = torch.arange(1, s + 1, dtype=torch.int32)
    z = decode_split_count(s, hkv, 1, H100_SMS)
    assert z == 5
    mask = jnp.asarray((np.arange(s)[None, :] < lengths.numpy()[:, None])[:, None])
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for layer in range(n_layer):
        got = _kv8_split_replay(q, k, ks, v, vs, layer, lengths, s, z)
        assert got.dtype == dtype
        _assert_within(got, flash_decode_kv8_reference(
            q, k, ks, v, vs, layer, lengths), dtype, 1e-6)
        want = j_gqa_kv8(
            jnp.asarray(q.float().numpy().reshape(b, 1, hkv * g, d), jdtype),
            jnp.asarray(k[layer].numpy()),
            jnp.asarray(ks[layer].float().numpy(), jnp.bfloat16),
            jnp.asarray(v[layer].numpy()),
            jnp.asarray(vs[layer].float().numpy(), jnp.bfloat16), mask)
        want = torch.from_numpy(np.array(want, np.float32)).reshape(b, hkv, g, d)
        _assert_within(got, want, dtype, 1e-5)


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 1])
@pytest.mark.parametrize("i,o,g", [
    *((i, o, 128) for i, o in INT4_SHAPES), (256, 200, 64), (256, 272, 64),
    (128, 130, 32),
    (192, 72, 3), (64, 24, 1)])
def test_gemv_runs_cover_the_packed_rows_on_group_boundaries(i, o, g, n_sm):
    half, n_groups = i // 2, i // g
    n_split = gemv_split(i, o, g, n_sm)
    assert 1 <= n_split <= GEMV_MAX_SPLIT and half % n_split == 0
    rows = half // n_split
    assert rows % g == 0  # each run is whole groups of both halves
    covered = np.zeros(half, int)
    for k in range(n_split):
        covered[k * rows:(k + 1) * rows] += 1
    assert (covered == 1).all()
    # the fewest runs that give two blocks per SM, where that is possible
    tiles = -(-o // GEMV_COLS)
    if tiles * (n_groups // 2) >= 2 * n_sm and n_groups // 2 <= GEMV_MAX_SPLIT:
        assert tiles * n_split >= 2 * n_sm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("i,o", INT4_SHAPES)
def test_gemv_partials_in_split_order_match_the_plain_versions(i, o, dtype):
    rng = np.random.default_rng(i + o)
    w = torch.from_numpy(rng.standard_normal((i, o)).astype(np.float32) * 0.02)
    qw = quantize_int4(w, group_size=128)
    p, gs = qw["p"], qw["gs"]
    x = torch.from_numpy(rng.standard_normal((1, i)).astype(np.float32)).to(dtype)
    parts = gemv_partials_reference(x, p, gs, gemv_split(i, o, 128, H100_SMS))
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    w_abs = (int4_dequant_bf16(p, gs).float() if dtype == torch.bfloat16 else
             _int4_effective_weight(qw, torch.float32)).abs()
    scale = x.float().abs() @ w_abs
    # the fp32 sums before the cast to x's dtype (x.float() is exact)
    plain = (int4_matmul_bf16w_reference if dtype == torch.bfloat16
             else int4_matmul_reference)
    want = plain(x.float(), p, gs)
    assert bool(((y - want).abs() <= 1e-5 * scale).all())
