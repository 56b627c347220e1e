"""The port's generation tools on the CPU (`--cpu`), mirroring
`tests/test_tools.py`'s `test_codec_cli_roundtrip`,
`test_extract_vq_and_build_dataset` (its extract half) and
`test_tts_cli_tiny`, plus a `batch_tts` job of two items:

  * `tools/codec.py` encodes a WAV into a (codebooks, frames) matrix and
    decodes it back to whole frames, through a native codec checkpoint
    (written by the JAX package's `save_dac`; the port has no writer yet),
    giving the codes the JAX CLI gives on the same checkpoint; `--tiny`
    does the round trip with no checkpoint;
  * `tools/extract_vq.py --tiny` writes a code file beside each clip of a
    speaker tree;
  * `tools/tts.py --tiny` writes codes_0.npy and a WAV; `--int8
    --num-samples 2` one code file and one WAV per sample;
  * `tools/batch_tts.py --tiny` serves a two-item job through the
    continuous batcher (`--pool-size 2`) and writes both WAVs and the
    manifest; its job-file reader and extract_vq's file walk equal the
    JAX tools';
  * `utils/checkpoint.load_codec` (the tools' and the server's codec
    loader) gives the torch layout `dac_from_jax` gives.
"""

import json

import numpy as np
import torch
from click.testing import CliRunner

from fish_speech_tpu_torch.audio.io import read_wav, write_wav
from fish_speech_tpu_torch.config import dac_tiny

from tests.test_tools import audio_tree  # noqa: F401 -- the fixture

torch.set_num_threads(1)


def _wav(path, frames, seed):
    cfg = dac_tiny()
    rng = np.random.default_rng(seed)
    write_wav(path, rng.normal(size=cfg.frame_length * frames).astype(np.float32)
              * 0.1, cfg.sample_rate)


def test_codec_cli_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp

    from fish_speech_tpu.models.dac.model import init_dac
    from fish_speech_tpu.tools.codec import main as jax_main
    from fish_speech_tpu.utils.checkpoint import save_dac
    from fish_speech_tpu_torch.tools.codec import main

    cfg = dac_tiny()
    ckpt = tmp_path / "codec_ckpt"
    save_dac(ckpt, init_dac(jax.random.PRNGKey(0), cfg, dtype=jnp.float32), cfg)
    wav_in = tmp_path / "in.wav"
    _wav(wav_in, 3, seed=3)
    runner = CliRunner()
    codes_out = tmp_path / "codes.npy"
    r = runner.invoke(main, ["-i", str(wav_in), "-o", str(codes_out),
                             "--checkpoint-path", str(ckpt), "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0
    codes = np.load(codes_out)
    assert codes.shape == (cfg.rvq.total_codebooks, 3)
    jax_codes = tmp_path / "jax_codes.npy"
    r = runner.invoke(jax_main, ["-i", str(wav_in), "-o", str(jax_codes),
                                 "--checkpoint-path", str(ckpt), "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0
    np.testing.assert_array_equal(codes, np.load(jax_codes))

    wav_out = tmp_path / "recon.wav"
    r = runner.invoke(main, ["-i", str(codes_out), "-o", str(wav_out),
                             "--checkpoint-path", str(ckpt), "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0
    audio, sr = read_wav(wav_out)  # (channels, T)
    assert sr == cfg.sample_rate
    assert audio.shape == (1, 3 * cfg.frame_length)


def test_codec_cli_tiny_roundtrip(tmp_path):
    from fish_speech_tpu_torch.tools.codec import main

    cfg = dac_tiny()
    _wav(tmp_path / "in.wav", 5, seed=4)
    runner = CliRunner()
    r = runner.invoke(main, ["-i", str(tmp_path / "in.wav"), "-o",
                             str(tmp_path / "c.npy"), "--tiny", "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0
    assert np.load(tmp_path / "c.npy").shape == (cfg.rvq.total_codebooks, 5)
    r = runner.invoke(main, ["-i", str(tmp_path / "c.npy"), "-o",
                             str(tmp_path / "out.wav"), "--tiny", "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0
    audio, _ = read_wav(tmp_path / "out.wav")
    assert audio.shape == (1, 5 * cfg.frame_length)


def test_extract_vq_tiny(audio_tree):  # noqa: F811 -- the fixture
    from fish_speech_tpu_torch.tools.extract_vq import main

    r = CliRunner().invoke(
        main, [str(audio_tree), "--tiny", "--cpu", "--batch-size", "2",
               "--max-seconds", "1"], catch_exceptions=False)
    assert r.exit_code == 0
    npys = sorted(audio_tree.rglob("*.npy"))
    assert len(npys) == 4
    for npy in npys:
        codes = np.load(npy)
        assert codes.shape == (dac_tiny().rvq.total_codebooks, 2)


def test_tts_cli_tiny(tmp_path):
    from fish_speech_tpu_torch.tools.tts import main

    out = tmp_path / "out.wav"
    r = CliRunner().invoke(
        main, ["--tiny", "--cpu", "--text", "hi", "--max-new-tokens", "6",
               "--output", str(out), "--output-dir", str(tmp_path)],
        catch_exceptions=False)
    assert r.exit_code == 0
    assert out.exists()
    codes = np.load(tmp_path / "codes_0.npy")
    assert codes.shape[0] == dac_tiny().rvq.total_codebooks
    audio, _ = read_wav(out)
    assert audio.shape == (1, codes.shape[1] * dac_tiny().frame_length)


def test_tts_cli_int8_samples(tmp_path):
    from fish_speech_tpu_torch.tools.tts import main

    r = CliRunner().invoke(
        main, ["--tiny", "--cpu", "--int8", "--num-samples", "2", "--text",
               "<|speaker:0|>Hello.", "--max-new-tokens", "5", "--output",
               str(tmp_path / "s.wav"), "--output-dir", str(tmp_path)],
        catch_exceptions=False)
    assert r.exit_code == 0
    for i in range(2):
        assert np.load(tmp_path / f"codes_{i}.npy").shape[0] == \
            dac_tiny().rvq.total_codebooks
        assert (tmp_path / f"s_{i}.wav").exists()


def test_batch_tts_job_of_two_items(tmp_path):
    from fish_speech_tpu_torch.tools.batch_tts import main

    job = tmp_path / "job.tsv"
    job.write_text("first\tThe first line.\nsecond\tThe second line.\n")
    out = tmp_path / "out"
    rc = main(["--input", str(job), "--output-dir", str(out), "--tiny", "--cpu",
               "--pool-size", "2", "--decode-chunk-size", "4",
               "--max-new-tokens", "8", "--references-dir", str(tmp_path / "refs")])
    assert rc == 0
    rows = [json.loads(line) for line in (out / "manifest.jsonl").read_text().splitlines()]
    assert sorted(r["id"] for r in rows) == ["first", "second"]
    assert all(r["status"] == "ok" for r in rows)
    for name in ("first", "second"):
        audio, sr = read_wav(out / f"{name}.wav")
        assert sr == dac_tiny().sample_rate and audio.shape[1] > 0


def test_load_codec_gives_the_bridge_layout(tmp_path):
    """`load_codec` (the tools' and the server's codec loader) gives the
    torch layout `dac_from_jax` gives for the same JAX tree."""
    import jax
    import jax.numpy as jnp

    from fish_speech_tpu.models.dac.model import init_dac
    from fish_speech_tpu.utils.checkpoint import save_dac
    from fish_speech_tpu_torch.convert.from_jax import dac_from_jax
    from fish_speech_tpu_torch.utils.checkpoint import load_codec

    cfg = dac_tiny()
    jp = init_dac(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    save_dac(tmp_path, jp, cfg)
    got, got_cfg = load_codec(tmp_path, device="cpu")
    want = dac_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert got_cfg.frame_length == cfg.frame_length
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert torch.equal(g, w)


def test_batch_tts_job_files_read_as_jax_reads_them(tmp_path, audio_tree):  # noqa: F811
    """The tools' host helpers against the JAX tools': `read_items` (tsv,
    jsonl, comments, a bad id and duplicate ids refused alike) and
    `list_audio_files`."""
    import pytest

    from fish_speech_tpu.tools import batch_tts as jbatch
    from fish_speech_tpu.tools import extract_vq as jextract
    from fish_speech_tpu_torch.tools import batch_tts, extract_vq

    tsv = tmp_path / "a.tsv"
    tsv.write_text("# a comment\none\tFirst line.\n\ntwo \t Second\tline.\n")
    jsonl = tmp_path / "b.jsonl"
    jsonl.write_text('{"id": "x", "text": "Hi.", "seed": 3}\n'
                     '{"id": "y", "text": "Yo.", "reference_id": "spk"}\n')
    for path in (tsv, jsonl):
        assert batch_tts.read_items(path) == jbatch.read_items(path)
    for bad in ("bad/id\tText.\n", "a\tOne.\na\tTwo.\n", "no tab here\n"):
        (tmp_path / "c.tsv").write_text(bad)
        with pytest.raises(ValueError) as want:
            jbatch.read_items(tmp_path / "c.tsv")
        with pytest.raises(ValueError) as got:
            batch_tts.read_items(tmp_path / "c.tsv")
        assert str(got.value) == str(want.value)
    assert extract_vq.list_audio_files(audio_tree) == jextract.list_audio_files(audio_tree)
