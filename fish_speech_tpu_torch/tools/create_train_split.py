"""Create duration-filtered train/val filelists
(reference `tools/vqgan/create_train_split.py`), the port's copy of
`fish_speech_tpu/tools/create_train_split.py`.

    python -m fish_speech_tpu_torch.tools.create_train_split data/

It only reads and writes files on the host and does no device work, as
the JAX tool does.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path
from random import Random

import click

from fish_speech_tpu_torch.tools.extract_vq import list_audio_files


def wav_duration(path: Path) -> float:
    try:
        with wave.open(str(path)) as f:
            return f.getnframes() / f.getframerate()
    except Exception:
        return -1.0


@click.command()
@click.argument("root", type=click.Path(exists=True, path_type=Path))
@click.option("--val-ratio", type=float, default=None)
@click.option("--val-count", type=int, default=None)
@click.option("--min-seconds", type=float, default=0.0)
@click.option("--max-seconds", type=float, default=math.inf)
@click.option("--filter-transcribed", is_flag=True,
              help="keep only files with a .lab transcript")
@click.option("--seed", type=int, default=42)
def main(root, val_ratio, val_count, min_seconds, max_seconds,
         filter_transcribed, seed):
    files = list_audio_files(root)
    kept = []
    for f in files:
        if filter_transcribed and not f.with_suffix(".lab").exists():
            continue
        if f.suffix.lower() == ".wav" and (
            min_seconds > 0 or max_seconds != math.inf
        ):
            d = wav_duration(f)
            if not (min_seconds <= d <= max_seconds):
                continue
        kept.append(str(f.relative_to(root)))

    Random(seed).shuffle(kept)
    if val_count is None:
        val_count = int(len(kept) * (val_ratio if val_ratio else 0.01))
    val_count = max(min(val_count, len(kept) // 2), 1 if kept else 0)

    val, train = kept[:val_count], kept[val_count:]
    (root / "vq_train_filelist.txt").write_text("\n".join(train))
    (root / "vq_val_filelist.txt").write_text("\n".join(val))
    click.echo(f"train: {len(train)}  val: {len(val)}")


if __name__ == "__main__":
    main()
