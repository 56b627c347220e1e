"""Batch audio -> VQ-code extractor, the port of
`fish_speech_tpu/tools/extract_vq.py`.

Walks a folder of audio files, encodes them with the codec in batches
padded (or cropped) to --max-seconds, and writes sibling `.npy` code
files. Sharding over hosts through --shard-id/--num-shards (or the
RANK/WORLD_SIZE environment).

    python -m fish_speech_tpu_torch.tools.extract_vq data/ \
        --checkpoint-path checkpoints/s2-pro-tpu --batch-size 16

It runs on `cuda:0`; `--cpu` runs it on the CPU. `--tiny` takes `dac_tiny`
with random weights from seed 0. The codec runs in fp32, as the port's
engine runs it.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import click
import numpy as np

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}


def list_audio_files(folder: Path, recursive=True):
    it = folder.rglob("*") if recursive else folder.glob("*")
    return sorted(p for p in it if p.suffix.lower() in AUDIO_EXTENSIONS)


@click.command()
@click.argument("folder", type=click.Path(exists=True, path_type=Path))
@click.option("--checkpoint-path", type=str, default="checkpoints/s2-pro-tpu")
@click.option("--batch-size", type=int, default=16)
@click.option("--max-seconds", type=float, default=30.0,
              help="pad/crop bucket size in seconds")
@click.option("--shard-id", type=int, default=None)
@click.option("--num-shards", type=int, default=None)
@click.option("--tiny", is_flag=True, help="tiny random codec (testing)")
@click.option("--overwrite", is_flag=True)
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(folder, checkpoint_path, batch_size, max_seconds, shard_id,
         num_shards, tiny, overwrite, cpu):
    import torch

    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.models.dac.model import dac_encode

    shard_id = shard_id if shard_id is not None else int(os.getenv("RANK", 0))
    num_shards = (num_shards if num_shards is not None
                  else int(os.getenv("WORLD_SIZE", 1)))
    device = torch.device("cpu" if cpu else "cuda:0")
    if tiny:
        from fish_speech_tpu_torch.config import dac_tiny
        from fish_speech_tpu_torch.models.dac.model import init_dac

        cfg = dac_tiny()
        params = init_dac(0, cfg, device=device)
    else:
        from fish_speech_tpu_torch.utils.checkpoint import load_codec

        params, cfg = load_codec(checkpoint_path, device=device)

    files = list_audio_files(folder)[shard_id::num_shards]
    if not overwrite:
        files = [f for f in files if not f.with_suffix(".npy").exists()]
    click.echo(f"[shard {shard_id}/{num_shards}] {len(files)} files to process",
               err=True)

    bucket = int(max_seconds * cfg.sample_rate)
    bucket = -(-bucket // cfg.frame_length) * cfg.frame_length  # frame multiple

    t0 = time.time()
    total_sec = 0.0
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        audios = np.zeros((len(chunk), 1, bucket), dtype=np.float32)
        lengths = np.zeros(len(chunk), dtype=np.int32)
        for j, f in enumerate(chunk):
            wav = load_audio(str(f), cfg.sample_rate)[:bucket]
            audios[j, 0, : len(wav)] = wav
            lengths[j] = len(wav)
            total_sec += len(wav) / cfg.sample_rate
        with torch.no_grad():
            codes, code_lens = dac_encode(params, cfg,
                                          torch.from_numpy(audios).to(device),
                                          torch.from_numpy(lengths).to(device))
        codes, code_lens = codes.cpu().numpy(), code_lens.cpu().numpy()
        for j, f in enumerate(chunk):
            np.save(f.with_suffix(".npy"), codes[j, :, : code_lens[j]])
        click.echo(f"[shard {shard_id}] {i + len(chunk)}/{len(files)} "
                   f"({total_sec / max(time.time() - t0, 1e-9):.1f} audio-s/s)",
                   err=True)


if __name__ == "__main__":
    main()
