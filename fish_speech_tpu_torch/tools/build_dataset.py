"""Pack .npy code files + .lab transcripts into sharded protobuf streams,
the port's copy of `fish_speech_tpu/tools/build_dataset.py`.

Reference: `tools/llama/build_dataset.py` — groups files by speaker folder,
emits ~10 MB `.protos` shards.

    python -m fish_speech_tpu_torch.tools.build_dataset \
        --input data/ --output data/protos

It only reads and writes files on the host and does no device work, as
the JAX tool does.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path

import click
import numpy as np

from fish_speech_tpu_torch.data.protos import Semantics, Sentence, TextData
from fish_speech_tpu_torch.data.stream import pack_pb_stream


def task_generator_folder(root: Path, text_extension: str):
    grouped = defaultdict(list)
    for npy in sorted(root.rglob("*.npy")):
        grouped[npy.parent].append(npy)
    for folder, files in sorted(grouped.items()):
        yield str(folder.relative_to(root)), files


@click.command()
@click.option("--input", "input_dir", type=click.Path(exists=True, path_type=Path),
              required=True)
@click.option("--output", "output_dir", type=click.Path(path_type=Path),
              required=True)
@click.option("--source-name", default="local")
@click.option("--text-extension", default=".lab")
@click.option("--shard-size-mb", type=int, default=10)
def main(input_dir, output_dir, source_name, text_extension, shard_size_mb):
    output_dir.mkdir(parents=True, exist_ok=True)
    shard_bytes = shard_size_mb * 1024 * 1024

    shard_idx = 0
    current = b""
    n_groups = n_sentences = 0

    def flush():
        nonlocal current, shard_idx
        if current:
            (output_dir / f"{shard_idx:05d}.protos").write_bytes(current)
            shard_idx += 1
            current = b""

    for name, files in task_generator_folder(input_dir, text_extension):
        sentences = []
        for npy in files:
            lab = npy.with_suffix(text_extension)
            if not lab.exists():
                continue
            text = lab.read_text(encoding="utf-8").strip()
            if not text:
                continue
            codes = np.load(npy)
            if codes.ndim != 2:
                continue
            sentences.append(
                Sentence(
                    texts=[text],
                    semantics=[
                        Semantics(values=row.astype(np.uint32).tolist())
                        for row in codes
                    ],
                )
            )
        if not sentences:
            continue
        record = TextData(source=source_name, name=name, sentences=sentences)
        current += pack_pb_stream(record)
        n_groups += 1
        n_sentences += len(sentences)
        if len(current) >= shard_bytes:
            flush()

    flush()
    click.echo(
        f"Wrote {shard_idx} shards, {n_groups} groups, {n_sentences} sentences "
        f"-> {output_dir}"
    )


if __name__ == "__main__":
    main()
