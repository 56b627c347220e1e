"""The fast-stack probe's plain version against the JAX package, on the CPU.

Small dims (DF=128, DQKV=256, INTER=256, NL=3, STEPS=2), set in the JAX
module's globals for its side. The port computes the intended chain, each
layer with its own weights; the Pallas probe's prefetch into the slot it
is reading (`pallas_faststack.py:180-189`) is harmless only where a single
layer is streamed (R = NL - 1), so that is where the two are compared:
within 1e-5 abs on outputs of rms 1 (fp32, summation order only; 4e-7 seen).
The port is also held to a numpy statement of `layer_compute` (:213-223)
at R=0, where the Pallas probe reads other layers' weights.

The kernel's piece plan: each block owns a strip of column units of every
matrix (`piece_plan`) and reads the weights packed strip by strip
(`pack_weights`). The strips cover every weight byte of each stage once, in
stage order, and a replay of each matvec from the packed strips in the
kernel's order (per thread, every P-th quad of one unit, fp32 sums of
exact products; then the P partial sums of a column in order) equals the
plain chain's matvec on the same activation: bf16 within 1e-5 of
|x| @ |W| (fp32 sums in another order), w8a8 exactly (int32 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fish_speech_tpu.ops.pallas_faststack as jprobe
from fish_speech_tpu_torch.ops import faststack as tprobe

torch.set_num_threads(1)
SMALL = dict(DF=128, DQKV=256, INTER=256, NL=3, STEPS=2)
DIMS = tprobe.ProbeDims(df=128, dqkv=256, inter=256, n_layer=3, steps=2)
ATOL = 1e-5


@pytest.fixture
def small_jax_probe(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(jprobe, name, value)
    return jprobe


def _x():
    return np.full((1, DIMS.df), 0.01, np.float32)


def _numpy_chain(x, weights, variant):
    """`layer_compute` in numpy: the intended math, every layer its own
    weights, float64 products of exact int8 values."""
    def mv(v, wq, s):
        if variant == "w8a8":
            xs = np.float32(np.abs(v).max() / np.float32(127.0))
            vq = np.clip(np.round(v / max(xs, np.float32(1e-12))), -127, 127)
            return (vq.astype(np.float64) @ wq).astype(np.float32) * (xs * s)
        vb = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        return (vb.astype(np.float64) @ wq).astype(np.float32) * s

    def rms(v):
        return v / np.sqrt(np.mean(v * v, axis=-1, keepdims=True) + 1e-5)

    for _ in range(DIMS.steps):
        for layer in range(DIMS.n_layer):
            lw = {k: (w.numpy().astype(np.float64), s.numpy())
                  for k, (w, s) in tprobe.layer_weights(weights, layer,
                                                        DIMS).items()}
            u = mv(x, *lw["qkv"])
            y = u[:, :DIMS.df] * (1.0 + u[:, DIMS.df:].sum() * 1e-3)
            x = x + mv(y, *lw["wo"])
            f = mv(rms(x), *lw["w13"])
            a, b = f[:, :DIMS.inter], f[:, DIMS.inter:]
            x = rms(x + mv(a / (1.0 + np.exp(-a)) * b, *lw["w2"]))
    return x


def test_make_weights_draws_the_jax_numbers(small_jax_probe):
    jw = small_jax_probe.make_weights(1)
    tw = tprobe.make_weights(DIMS, "cpu")
    for kind in DIMS.shapes():
        streamed = np.asarray(jw["hbm"][kind])
        if kind == "w13":  # streamed w13 is stored pre-split (S, 2, DF, INTER)
            streamed = np.concatenate([streamed[:, 0], streamed[:, 1]], axis=-1)
        full = np.concatenate([np.asarray(jw["res"][kind]), streamed], axis=0)
        w, _ = tprobe.layer_weights(tw, 2, DIMS)[kind]
        np.testing.assert_array_equal(w.numpy(), full[2])
        for layer in range(DIMS.n_layer):
            np.testing.assert_array_equal(
                tprobe.layer_weights(tw, layer, DIMS)[kind][1].numpy(),
                np.asarray(jw["sc"][kind][layer]))


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_plain_chain_matches_pallas_probe_with_one_streamed_layer(
        small_jax_probe, variant):
    r = DIMS.n_layer - 1
    run = small_jax_probe.make_probe(r, variant, o_chunk=128, interpret=True)
    want = np.asarray(run(jnp.asarray(_x()), small_jax_probe.make_weights(r)))
    got = tprobe.probe_reference(torch.from_numpy(_x()),
                                 tprobe.make_weights(DIMS, "cpu"), variant, DIMS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert 0.5 < np.abs(want).max() < 5.0  # rms-normed, not degenerate


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_plain_chain_matches_numpy_layer_compute(variant):
    w = tprobe.make_weights(DIMS, "cpu")
    got = tprobe.probe_reference(torch.from_numpy(_x()), w, variant, DIMS)
    np.testing.assert_allclose(got.numpy(), _numpy_chain(_x(), w, variant),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("r", [0, 1, 2])
def test_residency_changes_no_math_and_cpu_counts_no_launch(r):
    w = tprobe.make_weights(DIMS, "cpu")
    n0 = tprobe.faststack_probe.launches
    got = tprobe.make_probe(r, "bf16", DIMS)(torch.from_numpy(_x()), w)
    want = tprobe.probe_reference(torch.from_numpy(_x()), w, "bf16", DIMS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tprobe.faststack_probe.launches == n0
    assert DIMS.frame_bytes(r) == (r + DIMS.steps * (DIMS.n_layer - r)) * (
        128 * 256 + 128 * 128 + 2 * 128 * 256 + 256 * 128)


def test_pallas_probe_race_with_two_streamed_layers(small_jax_probe):
    """The JAX package's fault, kept as a record: with R=0 the Pallas probe
    prefetches piece t+2 into the slot of piece t while t is being read,
    so layers read other layers' weights (0.756 max abs seen against the
    intended chain, outputs of max 1.58). The port computes the intended
    chain."""
    run = small_jax_probe.make_probe(0, "bf16", o_chunk=128, interpret=True)
    racy = np.asarray(run(jnp.asarray(_x()), small_jax_probe.make_weights(0)))
    want = _numpy_chain(_x(), tprobe.make_weights(DIMS, "cpu"), "bf16")
    assert np.abs(racy - want).max() > 0.1


def test_probe_rejects_bad_arguments():
    w = tprobe.make_weights(DIMS, "cpu")
    with pytest.raises(ValueError, match="variant"):
        tprobe.faststack_probe(torch.from_numpy(_x()), w, 0, "fp8", DIMS)
    with pytest.raises(ValueError, match="R=3"):
        tprobe.faststack_probe(torch.from_numpy(_x()), w, 3, "bf16", DIMS)


BLOCKS = [1, 5, 132]  # one block, strips of 9-51 units, the H100's SMs


@pytest.mark.parametrize("dims,n_blocks", [
    *((DIMS, n) for n in BLOCKS),
    (tprobe.ProbeDims(), 132), (tprobe.ProbeDims(), 114)])  # H100 SXM, PCIe
def test_pieces_cover_each_stage_once_in_stage_order(dims, n_blocks):
    plan = tprobe.piece_plan(dims, n_blocks)
    off = 0
    for b, pieces in enumerate(plan):
        assert list(pieces) == list(dims.shapes())  # stage order
        for kind, (u0, nu, at) in pieces.items():
            assert at == off  # a block's strips follow one another
            off += dims.shapes()[kind][0] * tprobe.UNIT * nu
    assert off == dims.layer_bytes
    for kind, (i, o) in dims.shapes().items():  # the units, once each, in order
        units = [(p[kind][0], p[kind][0] + p[kind][1]) for p in plan]
        assert units[0][0] == 0 and units[-1][1] == o // tprobe.UNIT
        assert all(a[1] == b[0] for a, b in zip(units, units[1:]))
        most = max(e - a for a, e in units)
        assert most <= tprobe.CONSUMER_THREADS  # a unit per thread at most
        assert most - min(e - a for a, e in units) <= 1  # balanced


@pytest.mark.parametrize("n_blocks", BLOCKS)
def test_packing_puts_every_weight_byte_where_the_plan_says(n_blocks):
    w = tprobe.make_weights(DIMS, "cpu")
    packed = tprobe.pack_weights(w, DIMS, n_blocks)
    assert packed.shape == w["w"].shape and packed.dtype == torch.int8
    plan = tprobe.piece_plan(DIMS, n_blocks)
    for layer in range(DIMS.n_layer):
        for kind, (wq, _) in tprobe.layer_weights(w, layer, DIMS).items():
            i, o = DIMS.shapes()[kind]
            got = np.zeros((i, o), np.int16) + 999
            for pieces in plan:
                u0, nu, at = pieces[kind]
                tile = packed[layer, at:at + i * 4 * nu].numpy().reshape(
                    i // 4, nu, 4, 4)  # (quad, unit, column, row)
                got[:, 4 * u0:4 * (u0 + nu)] = tile.transpose(0, 3, 1, 2) \
                    .reshape(i, 4 * nu)
            if kind == "w13":  # the kernel's unit order of W13's columns
                wq = tprobe.w13_units(wq, DIMS.inter)
            np.testing.assert_array_equal(got, wq.numpy())


def _replay_mv(act, packed_layer, kind, plan, int_sums):
    """The kernel's column sums of one matvec from the packed strips:
    thread t of an nu-unit strip sums unit t % nu over quads q = t // nu
    (mod P), P = 256 // nu, in order, rows 4q..4q+3 in order; then one
    thread adds a column's P partial sums in four chains, i = 0, 1, 2, 3
    (mod 4), as (s0 + s1) + (s2 + s3)."""
    i = DIMS.shapes()[kind][0]
    cols = []
    for pieces in plan:
        u0, nu, at = pieces[kind]
        if nu == 0:
            continue
        tile = packed_layer[at:at + i * 4 * nu].reshape(i // 4, nu, 4, 4)
        tile = tile.astype(np.int64 if int_sums else np.float32)
        big_p = tprobe.CONSUMER_THREADS // nu
        parts = []
        for p in range(big_p):
            acc = np.zeros((nu, 4), tile.dtype)
            for q in range(p, i // 4, big_p):
                for r in range(4):
                    acc = (acc + act[4 * q + r] * tile[q, :, :, r]).astype(tile.dtype)
            parts.append(acc)
        chains = [np.zeros((nu, 4), tile.dtype) for _ in range(4)]
        for n, part in enumerate(parts):
            chains[n % 4] = (chains[n % 4] + part).astype(tile.dtype)
        total = ((chains[0] + chains[1]).astype(tile.dtype)
                 + (chains[2] + chains[3]).astype(tile.dtype)).astype(tile.dtype)
        cols.append(total.reshape(-1))
    return np.concatenate(cols)


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_piece_replay_matches_the_plain_chain(variant):
    w = tprobe.make_weights(DIMS, "cpu")
    packed = tprobe.pack_weights(w, DIMS, 5).numpy()
    plan = tprobe.piece_plan(DIMS, 5)
    checked = 0

    def mv(x, layer, kind):
        nonlocal checked
        wq, scale = tprobe.layer_weights(w, layer, DIMS)[kind]
        w_cols = tprobe.w13_units(wq, DIMS.inter) if kind == "w13" else wq
        if variant == "w8a8":
            xs = x.abs().max() / 127.0
            xq = torch.clamp(torch.round(x / torch.clamp(xs, min=1e-12)), -127, 127)
            got = _replay_mv(xq[0].numpy().astype(np.int64), packed[layer],
                             kind, plan, True)
            want = (xq.double() @ w_cols.double())[0].numpy()
            np.testing.assert_array_equal(got, want)
        else:
            xb = x.to(torch.bfloat16).float()
            got = _replay_mv(xb[0].numpy(), packed[layer], kind, plan, False)
            want = (xb.double() @ w_cols.double())[0].numpy()
            bound = 1e-5 * (xb.abs().double() @ w_cols.abs().double())[0].numpy()
            assert (np.abs(got - want) <= bound).all()
        checked += 1
        return tprobe._mv(x, wq, scale, variant)

    x = torch.from_numpy(_x())
    for _ in range(DIMS.steps):  # probe_reference's loop, one mv at a time
        for layer in range(DIMS.n_layer):
            u = mv(x, layer, "qkv")
            y = u[:, :DIMS.df] * (1.0 + u[:, DIMS.df:].sum() * 1e-3)
            x = x + mv(y, layer, "wo")
            f = mv(tprobe._rms(x), layer, "w13")
            g = torch.nn.functional.silu(f[:, :DIMS.inter]) * f[:, DIMS.inter:]
            x = tprobe._rms(x + mv(g, layer, "w2"))
    assert checked == 4 * DIMS.n_layer * DIMS.steps
    want = tprobe.probe_reference(torch.from_numpy(_x()), w, variant, DIMS)
    np.testing.assert_array_equal(x.numpy(), want.numpy())
