"""The fast-stack probe's plain version against the JAX package, on the CPU.

Small dims (DF=128, DQKV=256, INTER=256, NL=3, STEPS=2), set in the JAX
module's globals for its side. The port computes the intended chain, each
layer with its own weights; the Pallas probe's prefetch into the slot it
is reading (`pallas_faststack.py:180-189`) is harmless only where a single
layer is streamed (R = NL - 1), so that is where the two are compared:
within 1e-5 abs on outputs of rms 1 (fp32, summation order only; 4e-7 seen).
The port is also held to a numpy statement of `layer_compute` (:213-223)
at R=0, where the Pallas probe reads other layers' weights.
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
    tw = tprobe.make_weights(DIMS)
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
                                 tprobe.make_weights(DIMS), variant, DIMS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert 0.5 < np.abs(want).max() < 5.0  # rms-normed, not degenerate


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_plain_chain_matches_numpy_layer_compute(variant):
    w = tprobe.make_weights(DIMS)
    got = tprobe.probe_reference(torch.from_numpy(_x()), w, variant, DIMS)
    np.testing.assert_allclose(got.numpy(), _numpy_chain(_x(), w, variant),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("r", [0, 1, 2])
def test_residency_changes_no_math_and_cpu_counts_no_launch(r):
    w = tprobe.make_weights(DIMS)
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
    want = _numpy_chain(_x(), tprobe.make_weights(DIMS), "bf16")
    assert np.abs(racy - want).max() > 0.1


def test_probe_rejects_bad_arguments():
    w = tprobe.make_weights(DIMS)
    with pytest.raises(ValueError, match="variant"):
        tprobe.faststack_probe(torch.from_numpy(_x()), w, 0, "fp8", DIMS)
    with pytest.raises(ValueError, match="R=3"):
        tprobe.faststack_probe(torch.from_numpy(_x()), w, 3, "bf16", DIMS)
