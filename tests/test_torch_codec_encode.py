"""The port's codec encode half against the JAX package, on the CPU.

Same random weights (JAX `init_dac` on `dac_tiny`, bridged by
`dac_from_jax`), float32, inputs from numpy with a seed:

  * `vq_encode`, `rvq_encode` (with `n_active` and a quantizer-dropout
    mask) and `downsample_rvq_encode` give JAX's codes exactly (argmax over
    L2-normalised vectors, `_l2_normalize` as JAX computes it), and z_q,
    latents, the reconstruction and the losses within 1e-5 abs;
  * `encoder_forward` is within 1e-5 of the output's largest magnitude;
  * `dac_encode` gives JAX's codes and code_lengths exactly at lengths
    that are and are not multiples of `frame_length`;
  * its codes-only quantizer (`downsample_rvq_codes`) gives
    `downsample_rvq_encode`'s codes;
  * padding a clip to a frame bucket (as the engine does) changes no code
    before the clip's own frames: the encoder, downsample and windowed
    transformers are causal;
  * `init_dac` has the bridge's layout and both codec bodies (encode and
    decode, what the engine's graphs capture) read nothing on the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dac_tiny
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.models.dac import model as jmodel
from fish_speech_tpu.models.dac import rvq as jrvq
from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.convert.from_jax import config_from_jax, dac_from_jax
from fish_speech_tpu_torch.models.dac import model as tmodel
from fish_speech_tpu_torch.models.dac import rvq as trvq

from tests.test_torch_graph_step import _NoHostSync

torch.set_num_threads(1)
ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def codec():
    cfg = dac_tiny()
    jp = init_dac(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    tp = dac_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, config_from_jax(cfg, DACConfig), jp, tp


def _z(rng, b, t, d):
    return rng.standard_normal((b, t, d)).astype(np.float32)


def _check_result(got, want, keys):
    for k in keys:
        if k == "codes":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k], want[k])


RESULT_KEYS = ("z_q", "codes", "latents", "commitment_loss", "codebook_loss")


def test_vq_encode_matches_jax(codec):
    _, _, jp, tp = codec
    z = _z(np.random.default_rng(0), 2, 9, 32)
    want = jrvq.vq_encode(jp["quantizer"]["semantic"][0], jnp.asarray(z))
    got = trvq.vq_encode(tp["quantizer"]["semantic"][0], torch.from_numpy(z))
    assert got["codes"].dtype == torch.int32
    _check_result(got, want, RESULT_KEYS)


@pytest.mark.parametrize("n_active,masked", [(None, False), (1, False),
                                             (None, True)])
def test_rvq_encode_matches_jax(codec, n_active, masked):
    _, _, jp, tp = codec
    rng = np.random.default_rng(1)
    z = _z(rng, 3, 7, 32)
    mask = (np.array([[1, 1], [1, 0], [0, 0]], np.float32) if masked else None)
    want = jrvq.rvq_encode(jp["quantizer"]["residual"], jnp.asarray(z),
                           n_active=n_active,
                           dropout_mask=None if mask is None else jnp.asarray(mask))
    got = trvq.rvq_encode(tp["quantizer"]["residual"], torch.from_numpy(z),
                          n_active=n_active,
                          dropout_mask=None if mask is None else torch.from_numpy(mask))
    assert got["codes"].shape == (3, n_active or 2, 7)
    _check_result(got, want, RESULT_KEYS)


def test_downsample_rvq_encode_matches_jax(codec):
    cfg, tcfg, jp, tp = codec
    z = _z(np.random.default_rng(2), 2, 14, 32)
    want = jrvq.downsample_rvq_encode(jp["quantizer"], cfg.rvq, jnp.asarray(z))
    got = trvq.downsample_rvq_encode(tp["quantizer"], tcfg.rvq, torch.from_numpy(z))
    assert got["codes"].shape == (2, 3, 4) and got["z"].shape == (2, 14, 32)
    _check_result(got, want, ("z", "codes", "latents", "commitment_loss",
                              "codebook_loss"))


def test_codes_only_path_equals_downsample_rvq_encode(codec):
    _, tcfg, _, tp = codec
    z = torch.from_numpy(_z(np.random.default_rng(3), 2, 16, 32))
    full = trvq.downsample_rvq_encode(tp["quantizer"], tcfg.rvq, z)
    assert torch.equal(trvq.downsample_rvq_codes(tp["quantizer"], tcfg.rvq, z),
                       full["codes"])


def test_encoder_forward_matches_jax(codec):
    cfg, tcfg, jp, tp = codec
    x = (np.random.default_rng(4).standard_normal((2, 3000, 1)) * 0.3).astype(np.float32)
    want = np.asarray(jmodel.encoder_forward(jp["encoder"], cfg, jnp.asarray(x)))
    got = tmodel.encoder_forward(tp["encoder"], tcfg, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 6, tcfg.resolved_latent_dim)
    _close(got, want, ATOL * np.abs(want).max())


@pytest.mark.parametrize("length,lengths", [
    (5000, None), (2048 * 3, None), (9999, None), (2047, None),
    (7000, (7000, 2049)),
])
def test_dac_encode_matches_jax(codec, length, lengths):
    cfg, tcfg, jp, tp = codec
    rng = np.random.default_rng(length)
    audio = (rng.standard_normal((2, 1, length)) * 0.3).astype(np.float32)
    al = None if lengths is None else np.array(lengths, np.int32)
    want_codes, want_len = jmodel.dac_encode(
        jp, cfg, jnp.asarray(audio), None if al is None else jnp.asarray(al))
    got_codes, got_len = tmodel.dac_encode(
        tp, tcfg, torch.from_numpy(audio), None if al is None else torch.from_numpy(al))
    assert got_codes.shape[-1] == -(-length // tcfg.frame_length)
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_bucket_padding_changes_no_code_before_n_frames(codec):
    _, tcfg, _, tp = codec
    frame = tcfg.frame_length
    wav = (np.random.default_rng(5).standard_normal(5 * frame - 300) * 0.3).astype(
        np.float32)
    n_frames = -(-len(wav) // frame)
    alone, _ = tmodel.dac_encode(tp, tcfg, torch.from_numpy(wav)[None])
    padded = np.zeros((2, 1, 32 * frame), np.float32)
    padded[0, 0, : len(wav)] = wav
    padded[1, 0] = np.random.default_rng(6).standard_normal(32 * frame) * 0.3
    bucketed, _ = tmodel.dac_encode(tp, tcfg, torch.from_numpy(padded))
    assert alone.shape[-1] == n_frames and bucketed.shape[-1] == 32
    assert torch.equal(bucketed[0, :, :n_frames], alone[0])


def test_init_dac_has_the_bridge_layout_and_bodies_read_nothing_on_the_host(codec):
    _, tcfg, _, tp = codec
    fresh = tmodel.init_dac(0, tcfg, device="cpu")
    assert _shapes(fresh) == _shapes(tp)
    audio = torch.from_numpy(
        (np.random.default_rng(7).standard_normal((1, 1, 4 * tcfg.frame_length))
         * 0.3).astype(np.float32))
    with _NoHostSync():
        codes, _ = tmodel.dac_encode(fresh, tcfg, audio)
        out = tmodel.dac_from_indices(fresh, tcfg, codes)
    assert codes.shape == (1, tcfg.rvq.total_codebooks, 4)
    assert out.shape == audio.shape and bool(torch.isfinite(out).all())
