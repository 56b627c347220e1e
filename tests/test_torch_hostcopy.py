"""The port's own copies of the JAX package's host modules against the
originals: configs and presets field for field, the tokenizer's ids,
`sequence`'s encodings, the protobuf messages (one serialized descriptor,
so either module reads the other's bytes), the data pipeline's batches,
brace expansion, the WAV writer and reader, resampling and `load_audio`,
all equal; the reference loader behaves as the original on a temporary
directory. The server's host modules too: FLAC bytes (native and numpy
encoders) and decodes, `load_audio` of FLAC, mp3 and opus bytes where the
system libraries load, the time stretch, the live text segmentation, the
i18n tables, the static UI files, and `load_dac` of a checkpoint the JAX
package wrote. The converter's and the dataset tools' copies: every
function the original's source but the three that take or import torch,
and the state-dict loader equal on a `.pth`."""

import dataclasses
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from fish_speech_tpu import config as jconfig
from fish_speech_tpu import sequence as jseq
from fish_speech_tpu import tokenizer as jtok
from fish_speech_tpu.audio import io as jio
from fish_speech_tpu.data import dataset as jdata
from fish_speech_tpu.data import protos as jprotos
from fish_speech_tpu.data import stream as jstream
from fish_speech_tpu.engine import reference_loader as jref
from fish_speech_tpu.utils import file as jfile
from fish_speech_tpu_torch import config as tconfig
from fish_speech_tpu_torch import sequence as tseq
from fish_speech_tpu_torch import tokenizer as ttok
from fish_speech_tpu_torch.audio import io as tio
from fish_speech_tpu_torch.convert.from_jax import config_from_jax
from fish_speech_tpu_torch.data import dataset as tdata
from fish_speech_tpu_torch.data import protos as tprotos
from fish_speech_tpu_torch.data import stream as tstream
from fish_speech_tpu_torch.engine import reference_loader as tref
from fish_speech_tpu_torch.utils import file as tfile

PRESETS = ["dual_ar_tiny", "dual_ar_s2_pro", "dac_tiny", "dac_s2_pro"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_are_equal_field_for_field(name):
    want = getattr(jconfig, name)()
    got = getattr(tconfig, name)()
    assert type(got).__module__ == "fish_speech_tpu_torch.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config_from_jax(want, type(got)) == got
    if hasattr(got, "resolve"):
        assert dataclasses.asdict(got.resolve()) == dataclasses.asdict(want.resolve())


@pytest.mark.parametrize("cls", ["SamplingConfig", "GenerateConfig",
                                 "CodecTransformerConfig", "RVQConfig"])
def test_config_classes_have_the_same_fields_and_defaults(cls):
    j, t = getattr(jconfig, cls), getattr(tconfig, cls)
    assert ([(f.name, f.default) for f in dataclasses.fields(t)]
            == [(f.name, f.default) for f in dataclasses.fields(j)])


def test_config_json_roundtrip_matches(tmp_path):
    cfg = dataclasses.replace(jconfig.dual_ar_s2_pro(), max_seq_len=2048)
    cfg.to_json(str(tmp_path / "config.json"))
    got = tconfig.DualARConfig.from_json(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig.DualARConfig.from_json(str(tmp_path)))


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.build_test_tokenizer(), ttok.build_test_tokenizer()


TEXTS = ["Hello world.", "<|speaker:0|>Hi <|semantic:17|><|im_end|>",
         "Übergrößenträger 速度 😀", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_are_equal(tokenizers, text):
    j, t = tokenizers
    assert t.encode(text) == j.encode(text)
    assert (t.vocab_size, t.semantic_begin_id, t.semantic_end_id,
            t.im_end_id) == (j.vocab_size, j.semantic_begin_id,
                             j.semantic_end_id, j.im_end_id)


def _conversation(mod, codes):
    conv = mod.Conversation()
    conv.append(mod.Message(role="system", parts=[
        mod.TextPart(text="convert the provided text to speech"),
        mod.VQPart(codes=codes)], add_im_start=True, add_im_end=True))
    conv.append(mod.Message(role="user", parts=[mod.TextPart(text="Hi there")],
                            add_im_start=True, add_im_end=True))
    conv.append(mod.Message(role="assistant", parts=[], modality="voice",
                            add_im_start=True, add_im_end=False))
    return conv


def test_sequence_encodings_are_equal(tokenizers):
    j, t = tokenizers
    codes = np.random.default_rng(0).integers(0, 32, size=(4, 9)).astype(np.int32)
    want = _conversation(jseq, codes).encode_for_inference(j, num_codebooks=4)
    got = _conversation(tseq, codes).encode_for_inference(t, num_codebooks=4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _write_protos(path, protos, stream, rng):
    with open(path, "wb") as f:
        for g in range(3):
            sentences = []
            for s in range(5):
                codes = rng.integers(0, 32, size=(4, int(rng.integers(3, 8))))
                sentences.append(protos.Sentence(
                    texts=[f"sentence {g}-{s}"],
                    semantics=[protos.Semantics(values=c.tolist())
                               for c in codes]))
            stream.write_pb_stream(f, protos.TextData(
                source="test", name=f"spk{g}", sentences=sentences))
    return path


def test_protobuf_messages_cross_read(tmp_path):
    rng = np.random.default_rng(1)
    p = _write_protos(tmp_path / "a.protos", tprotos, tstream, rng)
    with open(p, "rb") as f:
        want = [m.SerializeToString() for m in jstream.read_pb_stream(f)]
    with open(p, "rb") as f:
        got = [m.SerializeToString() for m in tstream.read_pb_stream(f)]
    assert got == want and len(got) == 3


@pytest.mark.parametrize("native", [False, True])
def test_data_pipeline_batches_are_equal(tokenizers, tmp_path, native):
    j, t = tokenizers
    rng = np.random.default_rng(2)
    files = [str(_write_protos(tmp_path / f"d{i}.protos", jprotos, jstream, rng))
             for i in range(2)]
    kw = dict(seed=3, max_length=256, num_codebooks=4)
    jds = iter(jdata.SemanticIterableDataset(files, j, use_native_parser=native,
                                             **kw))
    tds = iter(tdata.SemanticIterableDataset([str(tmp_path / "d{0..1}.protos")],
                                             t, **kw))
    for _ in range(3):
        want = jdata.TextDataCollator(j, 256)([next(jds) for _ in range(2)])
        got = tdata.TextDataCollator(t, 256)([next(tds) for _ in range(2)])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("pattern", ["a{1..3}b", "x{a,b{c,d}}e", "{08..11}",
                                     "plain", "{a}"])
def test_braceexpand_is_equal(pattern):
    assert list(tfile.braceexpand(pattern)) == list(jfile.braceexpand(pattern))


def test_wav_writer_and_header_are_equal(tmp_path):
    x = np.sin(np.linspace(0, 40, 999)).astype(np.float32) * 0.7
    jio.write_wav(tmp_path / "j.wav", x, 22050)
    tio.write_wav(tmp_path / "t.wav", x, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert tio.wav_chunk_header(44100) == jio.wav_chunk_header(44100)


def _wav_bytes(x, sr, bits, float_fmt=False, extra_chunk=False):
    """RIFF bytes of x (channels, T) in [-1, 1]: PCM at `bits` or IEEE
    float32, optionally with an odd-sized chunk before `data`."""
    channels = x.shape[0]
    inter = x.T.reshape(-1)
    if float_fmt:
        raw, code, bits = inter.astype("<f4").tobytes(), 3, 32
    elif bits == 8:
        raw, code = np.clip(inter * 128 + 128, 0, 255).astype(np.uint8).tobytes(), 1
    elif bits == 24:
        v = np.clip(inter * (1 << 23), -(1 << 23), (1 << 23) - 1).astype("<i4")
        raw, code = v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes(), 1
    else:
        dt, scale = {16: ("<i2", 32767), 32: ("<i4", 2**31 - 1)}[bits]
        raw, code = (inter * scale).astype(dt).tobytes(), 1
    fmt = struct.pack("<HHIIHH", code, channels, sr, sr * channels * bits // 8,
                      channels * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 3) + b"abc\0"
    body += b"data" + struct.pack("<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _signal(channels, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.5 * np.sin(2 * np.pi * 220 * t)[None] + 0.1 * rng.standard_normal((channels, n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


WAV_CASES = [(1, 16, False, False), (1, 8, False, False), (1, 24, False, False),
             (1, 32, False, False), (1, 32, True, False), (2, 16, False, False),
             (2, 24, False, True)]


@pytest.mark.parametrize("channels,bits,float_fmt,extra", WAV_CASES)
def test_wav_reader_and_load_audio_are_equal(tmp_path, channels, bits, float_fmt,
                                             extra):
    data = _wav_bytes(_signal(channels, 1601, bits + channels), 16000, bits,
                      float_fmt, extra)
    (tmp_path / "a.wav").write_bytes(data)
    for src in (data, tmp_path / "a.wav"):
        (gx, gsr), (wx, wsr) = tio.read_wav(src), jio.read_wav(src)
        assert gsr == wsr == 16000 and gx.dtype == wx.dtype == np.float32
        assert gx.shape == (channels, 1601)
        np.testing.assert_array_equal(gx, wx)
        for sr in (16000, 44100):
            got, want = tio.load_audio(src, sr), jio.load_audio(src, sr)
            assert got.dtype == want.dtype and got.ndim == 1
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_from,sr_to", [(24000, 44100), (48000, 44100),
                                           (44100, 16000), (44100, 44100)])
def test_resample_is_equal(sr_from, sr_to):
    x = _signal(2, 2000, sr_from)
    got, want = tio.resample(x, sr_from, sr_to), jio.resample(x, sr_from, sr_to)
    assert got.shape == want.shape == (2, -(-2000 * sr_to // sr_from))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [b"MThd" + bytes(60), b"ID3" + bytes(61),
                                  b"OggS" + bytes(60)])
def test_load_audio_refuses_what_is_not_wav(tmp_path, data):
    """Neither WAV nor FLAC: the libav fallback is not ported."""
    with pytest.raises(ValueError, match="item 11"):
        tio.load_audio(data, 44100)
    (tmp_path / "x.bin").write_bytes(data)
    with pytest.raises(ValueError, match="item 11"):
        tio.load_audio(tmp_path / "x.bin", 44100)


def test_reference_loader_behaves_as_the_original(tmp_path):
    """By id (audio files with a same-stem `.lab` only, in name order), by
    hash, the id cache, CRUD and `validate_id`, on two directories."""
    def run(mod, root):
        loader = mod.ReferenceLoader(str(root))
        calls = []
        loader.encode_reference = lambda b: calls.append(b) or np.full(
            (2, len(b) % 7 + 1), len(calls), np.int32)
        log = [loader.list_references()]
        loader.add_reference("spk", b"RIFF-one", "hello there")
        (root / "spk" / "b.wav").write_bytes(b"RIFF-two")
        (root / "spk" / "b.lab").write_text(" second \n")
        (root / "spk" / "c.flac").write_bytes(b"no lab")
        (root / "spk" / "notes.txt").write_text("ignored")
        log.append(loader.load_by_id("spk"))
        log.append(loader.load_by_id("spk", use_cache="on"))
        log.append(len(calls))
        refs = [SimpleNamespace(audio=b"xyz", text="t1"),
                SimpleNamespace(audio=b"pq", text="t2")]
        log.append(loader.load_by_hash(refs, use_cache="on"))
        log.append(loader.load_by_hash(refs, use_cache="on"))
        log.append(len(calls))
        for bad in ("../up", "a/b", "", "ok name-1_2"):
            log.append(mod.ReferenceLoader.validate_id(bad))
        for call in (lambda: loader.load_by_id("missing"),
                     lambda: loader.load_by_id("../up"),
                     lambda: loader.add_reference("spk", b"", ""),
                     lambda: loader.delete_reference("missing")):
            with pytest.raises(Exception) as err:
                call()
            log.append(type(err.value).__name__)
        loader.add_reference("other", b"RIFF-3", "three")
        loader.update_reference("other", "renamed", audio=b"RIFF-4", text="four")
        log.append(loader.list_references())
        log.append(loader.load_by_id("renamed"))
        loader.delete_reference("spk")
        log.append(loader.list_references())
        log.append(sorted(loader.ref_by_id))
        return log

    def plain(x):
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x.tolist() if isinstance(x, np.ndarray) else x

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = run(jref, tmp_path / "j")
    got = run(tref, tmp_path / "t")
    assert plain(got) == plain(want)
    assert want[3] == 2 and want[6] == 4  # two clips by id, two by hash


# -- the server's host modules ---------------------------------------------


def _clip(n=30000, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t)[:, None] + 0.05 * rng.normal(size=(n, channels))
    return (x[:, 0] if channels == 1 else x).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("python", [False, True])
def test_flac_bytes_and_decodes_are_equal(channels, python):
    from fish_speech_tpu.audio import transcode as jtc
    from fish_speech_tpu_torch.audio import transcode as ttc

    x = _clip(channels=channels, seed=channels)
    got = ttc.encode_flac(x, 24000, _force_python=python)
    assert got == jtc.encode_flac(x, 24000, _force_python=python)
    dec_t, dec_j = ttc.decode_flac(got), jtc.decode_flac(got)
    np.testing.assert_array_equal(dec_t[0], dec_j[0])
    assert dec_t[1] == dec_j[1] == 24000
    np.testing.assert_array_equal(ttc.decode_flac_float(got)[0],
                                  jtc.decode_flac_float(got)[0])
    np.testing.assert_array_equal(tio.load_audio(got, 44100),
                                  jio.load_audio(got, 44100))
    if not python:  # the port's native encoder is built beside the checkout
        lib = ttc._flac_lib()
        assert lib is not None and "build/native" in lib._name


def test_native_build_dir_leaves_an_installed_package_alone(tmp_path, monkeypatch):
    """From the source tree the native libraries go to the checkout's
    `build/native/`; from an installed package (no checkout above it) to
    the user's cache, never into the interpreter's library tree."""
    from fish_speech_tpu_torch import native

    root = Path(__file__).resolve().parents[1]
    assert native.build_dir() == root / "build" / "native"
    site = tmp_path / "lib" / "python3.12" / "site-packages"
    monkeypatch.setattr(native, "__file__",
                        str(site / "fish_speech_tpu_torch" / "native" / "__init__.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert native.build_dir() == tmp_path / "cache" / "fish_speech_tpu_torch" / "native"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert native.build_dir() == (tmp_path / "home" / ".cache"
                                  / "fish_speech_tpu_torch" / "native")


def test_transcode_formats_and_codecs_are_equal():
    from fish_speech_tpu.audio import libcodec as jlc
    from fish_speech_tpu.audio import transcode as jtc
    from fish_speech_tpu_torch.audio import libcodec as tlc
    from fish_speech_tpu_torch.audio import transcode as ttc

    assert ttc.available_formats() == jtc.available_formats()
    assert issubclass(tlc.TranscodeUnavailable, Exception)
    x = _clip(n=24000)
    for fmt, dec in (("mp3", "decode_mp3"), ("opus", "decode_opus")):
        try:
            want = jtc.encode_audio(x, 24000, fmt)
        except jtc.TranscodeUnavailable:
            with pytest.raises(ttc.TranscodeUnavailable):
                ttc.encode_audio(x, 24000, fmt)
            continue
        got = ttc.encode_audio(x, 24000, fmt)
        assert len(got) == len(want) and got[:4] == want[:4]
        try:
            a, sr = getattr(tlc, dec)(got)
        except tlc.TranscodeUnavailable:
            continue
        b, sr_j = getattr(jlc, dec)(got)
        np.testing.assert_array_equal(a, b)
        assert sr == sr_j


@pytest.mark.parametrize("speed", [0.5, 1.0, 1.7, 4.0])
def test_time_stretch_is_equal(speed):
    from fish_speech_tpu.audio import stretch as jst
    from fish_speech_tpu_torch.audio import stretch as tst

    x = _clip(n=12000, seed=3)
    np.testing.assert_array_equal(tst.time_stretch(x, speed),
                                  jst.time_stretch(x, speed))
    assert (tst.MIN_SPEED, tst.MAX_SPEED) == (jst.MIN_SPEED, jst.MAX_SPEED)


@pytest.mark.parametrize("text,force,budget", [
    ("hello wor", False, 200), ("One. Two! Thr", False, 200),
    ("no punctuation here", True, 200), ("あ" * 40, False, 100),
    ("你好。接下来", False, 200), ("هل أنت هنا؟ نعم", False, 200)])
def test_text_segmentation_is_equal(text, force, budget):
    from fish_speech_tpu.utils import textseg as jseg
    from fish_speech_tpu_torch.utils import textseg as tseg

    assert (tseg.split_ready(text, force=force, max_buffer=budget)
            == jseg.split_ready(text, force=force, max_buffer=budget))
    assert tseg.TERMINATORS == jseg.TERMINATORS


def test_i18n_tables_and_static_files_are_equal():
    from pathlib import Path

    import fish_speech_tpu.i18n.core as jcore
    import fish_speech_tpu_torch.i18n.core as tcore
    from fish_speech_tpu.i18n import scan as jscan
    from fish_speech_tpu_torch.i18n import scan as tscan

    langs = sorted(p.stem for p in jcore.I18N_FILE_PATH.glob("*.json"))
    assert langs == sorted(p.stem for p in tcore.I18N_FILE_PATH.glob("*.json"))
    for lang in langs:
        assert tcore.load_language_list(lang) == jcore.load_language_list(lang)
        assert tcore.I18nAuto(lang)("Synthesize") == jcore.I18nAuto(lang)("Synthesize")
    src = 'i18n("Text") + i18n("Seed")'
    assert tscan.extract_i18n_keys(src) == jscan.extract_i18n_keys(src)
    jdir = Path(jcore.__file__).parents[1] / "server" / "static"
    tdir = Path(tcore.__file__).parents[1] / "server" / "static"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()


def test_load_dac_reads_what_the_jax_package_wrote(tmp_path):
    import jax
    import torch

    from fish_speech_tpu.models.dac import init_dac
    from fish_speech_tpu.utils import checkpoint as jckpt
    from fish_speech_tpu_torch.utils import checkpoint as tckpt

    cfg = jconfig.dac_tiny()
    params = init_dac(jax.random.PRNGKey(0), cfg)
    jckpt.save_dac(tmp_path, params, cfg)
    got, got_cfg = tckpt.load_dac(tmp_path, device="cpu")
    want, want_cfg = jckpt.load_dac(tmp_path)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert type(got_cfg).__module__ == "fish_speech_tpu_torch.config"
    flat_t, flat_j = {}, {}
    jckpt_flat = jckpt.flatten_pytree(jax.tree_util.tree_map(np.asarray, want))
    for k, v in jckpt_flat.items():
        flat_j[k] = np.asarray(v, np.float32)

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            flat_t[prefix[:-1]] = node.float().numpy()

    walk(got)
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    assert all(t.dtype == torch.float32 for t in [got["decoder"]["conv_in"]["w"]])


# the converter's and the dataset tools' copies: every function is the
# original's source, except the three that take torch tensors or import
# torch at the top (held to the originals on the same inputs in
# `tests/test_torch_convert.py`; the dataset tools' files in
# `tests/test_torch_dataset_tools.py`)
_COPIES = ("convert.torch_state", "convert.dual_ar", "convert.dac",
           "tools.build_dataset", "tools.create_train_split")
_CHANGED = {"convert.torch_state": {"_to_numpy", "load_torch_state_dict"},
            "convert.dual_ar": {"export_dual_ar"}}


@pytest.mark.parametrize("module", _COPIES)
def test_converter_and_dataset_tool_copies_are_the_originals(module):
    import importlib
    import inspect

    orig = importlib.import_module(f"fish_speech_tpu.{module}")
    copy = importlib.import_module(f"fish_speech_tpu_torch.{module}")
    compared = 0
    for name, f in vars(orig).items():
        f = getattr(f, "callback", f)  # a click command: its function
        if not inspect.isfunction(f) or f.__module__ != orig.__name__:
            continue
        g = getattr(copy, name)
        g = getattr(g, "callback", g)
        if name in _CHANGED.get(module, ()):
            assert inspect.getsource(g) != inspect.getsource(f)
        else:
            assert inspect.getsource(g) == inspect.getsource(f), name
        compared += 1
    assert compared >= 2


def test_torch_state_loaders_are_equal_on_a_pth(tmp_path):
    import torch

    from fish_speech_tpu.convert import torch_state as jts
    from fish_speech_tpu_torch.convert import torch_state as tts

    rng = np.random.default_rng(0)
    state = {"model.a.weight": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
             "model.b": torch.from_numpy(rng.normal(size=(5,))).to(torch.bfloat16)}
    torch.save(state, tmp_path / "model.pth")
    got, want = tts.load_torch_state_dict(tmp_path), jts.load_torch_state_dict(tmp_path)
    assert list(got) == list(want) == ["a.weight", "b"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for v in state.values():
        np.testing.assert_array_equal(tts._to_numpy(v), jts._to_numpy(v))
