"""The codec's training round trip in the port against the JAX package, on
the CPU: `dac_forward` without a generator (audio, codes and the VQ losses
on bridged `dac_tiny` weights), `dac_decode`, the residual quantizer under
an injected dropout mask, the quantizer-dropout draw's distribution, and
`VQGANDataset`'s crops on one file list and seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dac_tiny
from fish_speech_tpu.models.dac import model as jmodel
from fish_speech_tpu.models.dac import rvq as jrvq
from fish_speech_tpu_torch import config as tconfig
from fish_speech_tpu_torch.convert.from_jax import config_from_jax, dac_from_jax
from fish_speech_tpu_torch.models.dac import model as tmodel
from fish_speech_tpu_torch.models.dac import rvq as trvq

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def codec():
    cfg = dac_tiny()
    jp = jmodel.init_dac(jax.random.PRNGKey(0), cfg)
    tp = dac_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp, config_from_jax(cfg, tconfig.DACConfig)


@pytest.mark.parametrize("b,t", [(1, 4096), (2, 5000), (1, 777)])
def test_dac_forward_without_a_generator_matches_jax(codec, b, t):
    cfg, jp, tp, tcfg = codec
    x = np.random.default_rng(t).normal(size=(b, 1, t)).astype(np.float32) * 0.1
    want_audio, want = jmodel.dac_forward(jp, cfg, jnp.asarray(x))
    got_audio, got = tmodel.dac_forward(tp, tcfg, torch.from_numpy(x))
    assert tuple(got_audio.shape) == want_audio.shape == (b, 1, t)
    np.testing.assert_allclose(got_audio.numpy(), np.asarray(want_audio), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want["latents"]),
                               rtol=0, atol=1e-5)
    for name in ("commitment_loss", "codebook_loss"):
        assert got[name].shape == (b,)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)
    # the codes are the encode path's
    codes, _ = tmodel.dac_encode(tp, tcfg, torch.from_numpy(x))
    if t % tcfg.frame_length == 0:
        np.testing.assert_array_equal(got["codes"].numpy(), codes.numpy())


def test_dac_decode_matches_jax(codec):
    cfg, jp, tp, tcfg = codec
    z = np.random.default_rng(1).normal(size=(2, 6, cfg.resolved_latent_dim)).astype(np.float32)
    got = tmodel.dac_decode(tp, tcfg, torch.from_numpy(z)).numpy()
    want = np.asarray(jmodel.dac_decode(jp, cfg, jnp.asarray(z)))
    assert got.shape == want.shape == (2, 1, 6 * cfg.hop_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [[3, 1], [1, 2], [0, 0]])
def test_residual_quantizer_under_a_dropout_mask_matches_jax(codec, rows):
    """Equal results under the same mask: the kept codebooks' sum and the
    masked losses (a row's n active codebooks; n = 0 keeps none)."""
    cfg, jp, tp, tcfg = codec
    n = cfg.rvq.n_codebooks
    mask = (np.arange(n)[None, :] < np.minimum(rows, n)[:, None]).astype(np.float32)
    z = np.random.default_rng(2).normal(size=(2, 5, cfg.rvq.input_dim)).astype(np.float32)
    want = jrvq.rvq_encode(jp["quantizer"]["residual"], jnp.asarray(z),
                           dropout_mask=jnp.asarray(mask))
    got = trvq.rvq_encode(tp["quantizer"]["residual"], torch.from_numpy(z),
                          dropout_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got["z_q"].numpy(), np.asarray(want["z_q"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    for name in ("commitment_loss", "codebook_loss"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)


def test_quantizer_dropout_draw_distribution(codec):
    """n active codebooks per sample: all N with probability 1 - p + p / N,
    each n in [1, N - 1] with p / N (JAX's draw, `rvq.py:281-291`), within
    5 standard errors over 20,000 samples; the generator makes the draw
    repeatable, and `dac_forward` with one runs on a drawn mask."""
    cfg, jp, tp, tcfg = codec
    rcfg = config_from_jax(cfg, tconfig.DACConfig).rvq
    n, p, draws = rcfg.n_codebooks, rcfg.quantizer_dropout, 20000
    mask = trvq.quantizer_dropout_mask(rcfg, draws, torch.Generator().manual_seed(0))
    assert mask.shape == (draws, n) and mask.dtype == torch.float32
    counts = mask.sum(1).long()
    # active codebooks are a prefix
    assert torch.equal(mask, (torch.arange(n)[None] < counts[:, None]).float())
    freq = torch.bincount(counts, minlength=n + 1).numpy() / draws
    want = np.full(n + 1, p / n)
    want[0], want[n] = 0.0, 1 - p + p / n
    se = np.sqrt(want * (1 - want) / draws)
    assert np.all(np.abs(freq - want) <= 5 * se + 1e-12), (freq, want)
    again = trvq.quantizer_dropout_mask(rcfg, draws, torch.Generator().manual_seed(0))
    assert torch.equal(mask, again)
    import dataclasses

    assert trvq.quantizer_dropout_mask(
        dataclasses.replace(rcfg, quantizer_dropout=0.0), 4, torch.Generator()) is None
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 1, 4096))
                         .astype(np.float32) * 0.1)
    audio, out = tmodel.dac_forward(tp, tcfg, x, generator=torch.Generator().manual_seed(1))
    drawn = trvq.quantizer_dropout_mask(rcfg, 4, torch.Generator().manual_seed(1))
    z = tmodel.encoder_forward(tp["encoder"], tcfg, x[:, 0, :, None])
    sem, res = trvq._quantize(tp["quantizer"], rcfg, z, drawn)
    np.testing.assert_array_equal(out["commitment_loss"].numpy(),
                                  (sem["commitment_loss"] + res["commitment_loss"]).numpy())
    assert torch.isfinite(audio).all() and audio.shape == x.shape


def _filelist(tmp_path):
    from fish_speech_tpu_torch.audio.io import write_wav

    rng = np.random.default_rng(0)
    names = []
    for i, n in enumerate((3000, 9000, 700, 0)):
        name = f"clip{i}.wav"
        write_wav(tmp_path / name, (0.2 * rng.normal(size=n)).astype(np.float32), 16000)
        names.append(name)
    (tmp_path / "bad.wav").write_bytes(b"not audio at all")
    names.append("bad.wav")
    path = tmp_path / "files.txt"
    path.write_text("\n".join(names) + "\n\n")
    return path


@pytest.mark.parametrize("slice_frames", [None, 4])
def test_vqgan_dataset_crops_match_jax(tmp_path, slice_frames):
    import itertools

    from fish_speech_tpu.data.dataset import VQGANDataset as JData
    from fish_speech_tpu_torch.data.dataset import VQGANDataset as TData

    path = _filelist(tmp_path)
    kw = dict(sample_rate=22050, hop_length=256, slice_frames=slice_frames, seed=3)
    jds, tds = JData(str(path), **kw), TData(str(path), **kw)
    assert len(tds) == len(jds) == 5
    for i in range(len(jds)):
        a, b = tds[i], jds[i]
        assert (a is None) == (b is None)
        if a is not None:
            assert a["audio_length"] == b["audio_length"]
            assert a["audio_length"] % 256 == 0
            if slice_frames:
                assert a["audio_length"] <= slice_frames * 256 or a["audio_length"] % 256 == 0
            np.testing.assert_array_equal(a["audio"], b["audio"])
    for a, b in zip(itertools.islice(iter(tds), 7), itertools.islice(iter(jds), 7)):
        np.testing.assert_array_equal(a["audio"], b["audio"])
    with pytest.raises(ValueError, match="No files"):
        (tmp_path / "empty.txt").write_text("\n")
        TData(str(tmp_path / "empty.txt"))
