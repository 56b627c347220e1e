"""The port's native host code against the JAX package's, on the CPU: the
shard parser (`native/pb_stream.cc` through `native/loader.py`) on shards
written by the port's `tools.build_dataset`, the training dataset's
batches with the native parser on and off (and its protobuf fallback
where the build fails), and the libav decoder (`native/av_decode.c`
through `audio/libav.py`) under `load_audio` on mp3 and Ogg/Opus bytes,
with its `ValueError` where the shim cannot load. Both libraries are
built by the system compiler into `native.build_dir()`, keyed by their
source's hash."""

import numpy as np
import pytest
from click.testing import CliRunner

from fish_speech_tpu.audio import io as jio
from fish_speech_tpu.data import dataset as jdata
from fish_speech_tpu.native import loader as jloader
from fish_speech_tpu.tokenizer import build_test_tokenizer as jtok
from fish_speech_tpu_torch import native
from fish_speech_tpu_torch.audio import io as tio
from fish_speech_tpu_torch.data import dataset as tdata
from fish_speech_tpu_torch.native import loader as tloader
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer as ttok


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two shards of the port's `build_dataset`: three speakers of clips of
    10 codebooks, transcripts in several scripts."""
    from fish_speech_tpu_torch.tools.build_dataset import main

    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    texts = ["plain words.", "Übergröße 速度", "emoji 😀 line", ""]
    for s, spk in enumerate(("alice", "bob", "carol")):
        d = root / "codes" / spk
        d.mkdir(parents=True)
        for i in range(4):
            np.save(d / f"{i}.npy", rng.integers(0, 4096, (10, 20 + 9 * i + s)))
            (d / f"{i}.lab").write_text(f"{spk} {texts[i]} {i}")
    r = CliRunner().invoke(main, ["--input", str(root / "codes"), "--output",
                                  str(root / "protos"), "--shard-size-mb", "0"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    files = sorted(str(p) for p in (root / "protos").glob("*.protos"))
    assert len(files) >= 2
    return files


def test_the_parser_builds_into_the_build_dir():
    assert tloader.fast_parse_available()
    lib = native.build_pb()
    assert lib.parent == native.build_dir() and lib.name.startswith("libpb_stream-")
    assert native.build_pb() == lib  # built once per source hash


def test_flat_arrays_equal_jax(shards):
    for path in shards:
        tdata_, tflat = tloader.parse_shard_flat(path)
        jdata_, jflat = jloader.parse_shard_flat(path)
        assert tdata_ == jdata_
        assert set(tflat) == set(jflat)
        assert tflat["n_records"] == jflat["n_records"] > 0
        for k in jflat:
            if k != "n_records":
                np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        for s in range(len(jflat["sent_record"])):
            a = tloader.materialize_sentence(tdata_, tflat, s)
            b = jloader.materialize_sentence(jdata_, jflat, s)
            assert a["text"] == b["text"]
            np.testing.assert_array_equal(a["semantics"], b["semantics"])
        got, want = tloader.fast_read_shard(path), jloader.fast_read_shard(path)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [s["text"] for s in g["sentences"]] == [s["text"] for s in w["sentences"]]
            for gs, ws in zip(g["sentences"], w["sentences"]):
                np.testing.assert_array_equal(gs["semantics"], ws["semantics"])


def _batches(mod, tok, files, native_parser, n=4):
    ds = iter(mod.SemanticIterableDataset(files, tok, seed=3, max_length=512,
                                          num_codebooks=10,
                                          use_native_parser=native_parser))
    collate = mod.TextDataCollator(tok, 512)
    return [collate([next(ds) for _ in range(2)]) for _ in range(n)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize("native_parser", [True, False])
def test_dataset_batches_equal_jax(shards, native_parser):
    want = _batches(jdata, jtok(), shards, native_parser)
    got = _batches(tdata, ttok(), shards, native_parser)
    _equal(got, want)
    # the two readers give the same groups
    _equal(_batches(tdata, ttok(), shards, not native_parser), want)
    ds = tdata.SemanticIterableDataset(shards, ttok(), use_native_parser=native_parser)
    ds._load_groups()
    assert isinstance(ds.groups[0], tdata._NativeGroup) == native_parser


def test_failed_build_reads_with_protobuf(shards, monkeypatch):
    """Where the parser cannot build, the dataset reads with protobuf, as
    JAX's does (`fish_speech_tpu/data/dataset.py:141-151`)."""
    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "build_pb", no_compiler)
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_tried", False)
    assert not tloader.fast_parse_available()
    with pytest.raises(RuntimeError, match="not available"):
        tloader.parse_shard_flat(shards[0])
    ds = tdata.SemanticIterableDataset(shards, ttok(), use_native_parser=True)
    ds._load_groups()
    assert not isinstance(ds.groups[0], tdata._NativeGroup)
    _equal(_batches(tdata, ttok(), shards, True), _batches(jdata, jtok(), shards, False))


def _signal(n, sr, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * 330 * t)[:, None] + 0.02 * rng.normal(size=(n, channels))
    return (x[:, 0] if channels == 1 else x).astype(np.float32)


def _encoded(fmt, sr, channels):
    from fish_speech_tpu_torch.audio.transcode import TranscodeUnavailable, encode_audio

    try:
        return encode_audio(_signal(sr // 2, sr, channels, seed=sr), sr, fmt)
    except TranscodeUnavailable as e:  # pragma: no cover - libraries present here
        pytest.fail(f"the port's {fmt} encoder is unavailable: {e}")


@pytest.mark.parametrize("fmt,sr,channels", [("mp3", 24000, 1), ("mp3", 44100, 2),
                                             ("opus", 48000, 1), ("opus", 24000, 2)])
def test_load_audio_of_libav_formats_equals_jax(tmp_path, fmt, sr, channels):
    from fish_speech_tpu_torch.audio import libav

    assert libav.available()
    data = _encoded(fmt, sr, channels)
    assert data[:4] == (b"OggS" if fmt == "opus" else data[:4])
    (tmp_path / f"a.{fmt}").write_bytes(data)
    for src in (data, tmp_path / f"a.{fmt}"):
        for target in (16000, 44100):
            got, want = tio.load_audio(src, target), jio.load_audio(src, target)
            assert got.dtype == want.dtype and got.ndim == 1 and len(got) > target // 4
            np.testing.assert_array_equal(got, want)
    pcm, rate = libav.decode_bytes(data)
    assert pcm.dtype == np.float32 and pcm.shape[1] == channels
    assert native.build_av().parent == native.build_dir()


def test_missing_shim_raises_value_error(monkeypatch):
    from fish_speech_tpu_torch.audio import libav

    def no_headers():
        raise FileNotFoundError("libavcodec/avcodec.h")

    monkeypatch.setattr(native, "build_av", no_headers)
    monkeypatch.setattr(libav, "_LIB", None)
    monkeypatch.setattr(libav, "_TRIED", False)
    assert not libav.available()
    with pytest.raises(ValueError, match="Unrecognized audio") as err:
        tio.load_audio(_encoded("mp3", 24000, 1), 16000)
    assert "libav shim unavailable" in str(err.value)
