"""The port's dataset tools against the JAX package's on the same temporary
tree (CPU): `tools.build_dataset` writes the JAX tool's shards byte for
byte (several shards at a small shard size, a folder skipped for want of
transcripts, a code file of the wrong rank skipped), and
`tools.create_train_split` writes the JAX tool's train and val lists byte
for byte (transcribed and duration filters, a seed, a ratio and a count)."""

import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from fish_speech_tpu_torch.audio.io import write_wav
from fish_speech_tpu_torch.data.stream import read_pb_stream


def _code_tree(root, seed=0):
    """Speaker folders of (C, T) code files beside transcripts: two speakers
    of three clips, one clip without a transcript, one 1-D code file, one
    folder with no transcript at all."""
    rng = np.random.default_rng(seed)
    for spk in ("alice", "bob", "carol"):
        d = root / "speakers" / spk
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"{i}.npy", rng.integers(0, 4096, (10, 40 + 7 * i)))
            if spk != "carol" and i != 2:
                (d / f"{i}.lab").write_text(f"{spk} says line {i}.\n")
    np.save(root / "speakers" / "bob" / "flat.npy", rng.integers(0, 10, (9,)))
    (root / "speakers" / "bob" / "flat.lab").write_text("a 1-D code file")
    (root / "speakers" / "bob" / "2.lab").write_text("   ")  # empty once stripped
    return root / "speakers"


@pytest.mark.parametrize("shard_mb", [10, 0])
def test_build_dataset_writes_the_jax_tools_shards(tmp_path, shard_mb):
    from fish_speech_tpu.tools.build_dataset import main as jax_main
    from fish_speech_tpu_torch.tools.build_dataset import main

    src = _code_tree(tmp_path)
    runner = CliRunner()
    outs = {}
    for name, tool in (("jax", jax_main), ("port", main)):
        out = tmp_path / name
        r = runner.invoke(tool, ["--input", str(src), "--output", str(out),
                                 "--source-name", "test",
                                 "--shard-size-mb", str(shard_mb)],
                          catch_exceptions=False)
        assert r.exit_code == 0, r.output
        outs[name] = (sorted(p.name for p in out.glob("*.protos")),
                      r.output.replace(str(out), "OUT"))
    assert outs["port"] == outs["jax"]
    names = outs["port"][0]
    assert len(names) == (2 if shard_mb == 0 else 1)
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    groups = []
    for name in names:
        with open(tmp_path / "port" / name, "rb") as f:
            groups.extend(read_pb_stream(f))
    assert sorted(g.name for g in groups) == ["alice", "bob"]
    assert [len(g.sentences) for g in groups] == [2, 2]


def _audio_tree(root):
    """Clips of 0.25-2 s (WAV), two without transcripts, and an mp3 name
    (listed by the walk, never opened)."""
    rng = np.random.default_rng(1)
    for spk in ("a", "b"):
        d = root / spk
        d.mkdir(parents=True)
        for i, seconds in enumerate((0.25, 0.5, 1.0, 1.5, 2.0)):
            write_wav(d / f"{i}.wav", 0.1 * rng.standard_normal(int(16000 * seconds)),
                      16000)
            if i != 4:
                (d / f"{i}.lab").write_text("text")
    (root / "b" / "x.mp3").write_bytes(b"not audio")
    return root


@pytest.mark.parametrize("args", [
    ["--val-count", "2", "--filter-transcribed"],
    ["--val-ratio", "0.3", "--min-seconds", "0.4", "--max-seconds", "1.6",
     "--seed", "7"],
    [],
])
def test_create_train_split_writes_the_jax_tools_lists(tmp_path, args):
    from fish_speech_tpu.tools.create_train_split import main as jax_main
    from fish_speech_tpu_torch.tools.create_train_split import main

    runner = CliRunner()
    lists = {}
    for name, tool in (("jax", jax_main), ("port", main)):
        root = _audio_tree(tmp_path / name)
        r = runner.invoke(tool, [str(root), *args], catch_exceptions=False)
        assert r.exit_code == 0, r.output
        lists[name] = [(root / f).read_bytes() for f in
                       ("vq_train_filelist.txt", "vq_val_filelist.txt")]
        lists[name].append(r.output)
        shutil.rmtree(root)
    assert lists["port"] == lists["jax"]
    train, val = (b.decode().splitlines() for b in lists["port"][:2])
    assert val and train and not set(train) & set(val)
