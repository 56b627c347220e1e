"""The port's own copies of the JAX package's host modules against the
originals: configs and presets field for field, the tokenizer's ids,
`sequence`'s encodings, the protobuf messages (one serialized descriptor,
so either module reads the other's bytes), the data pipeline's batches,
brace expansion and the WAV writer, all equal."""

import dataclasses

import numpy as np
import pytest

from fish_speech_tpu import config as jconfig
from fish_speech_tpu import sequence as jseq
from fish_speech_tpu import tokenizer as jtok
from fish_speech_tpu.audio import io as jio
from fish_speech_tpu.data import dataset as jdata
from fish_speech_tpu.data import protos as jprotos
from fish_speech_tpu.data import stream as jstream
from fish_speech_tpu.utils import file as jfile
from fish_speech_tpu_torch import config as tconfig
from fish_speech_tpu_torch import sequence as tseq
from fish_speech_tpu_torch import tokenizer as ttok
from fish_speech_tpu_torch.audio import io as tio
from fish_speech_tpu_torch.convert.from_jax import config_from_jax
from fish_speech_tpu_torch.data import dataset as tdata
from fish_speech_tpu_torch.data import protos as tprotos
from fish_speech_tpu_torch.data import stream as tstream
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
