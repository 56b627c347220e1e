"""Codec round-trip CLI, the port of `fish_speech_tpu/tools/codec.py`.

Two modes, chosen by the input's extension:

  audio file in  -> codec ENCODE  -> sibling `.npy` code matrix (1+N, T')
  `.npy` file in -> codec DECODE  -> reconstructed waveform at the codec
                                     sample rate

    python -m fish_speech_tpu_torch.tools.codec -i speech.wav -o codes.npy \
        --checkpoint-path checkpoints/s2-pro-tpu
    python -m fish_speech_tpu_torch.tools.codec -i codes.npy -o fake.wav \
        --checkpoint-path checkpoints/s2-pro-tpu

The codec comes from a native checkpoint (`codec.safetensors` +
`codec_config.json`, `utils/checkpoint.load_codec`), or with `--tiny` is
`dac_tiny` with random weights from seed 0 (a round trip with no
checkpoint). Audio in any supported container is resampled to the codec
rate on load. It runs on `cuda:0`; `--cpu` runs it on the CPU.
"""

from __future__ import annotations

from pathlib import Path

import click
import numpy as np

AUDIO_EXTENSIONS = {".wav", ".flac", ".mp3", ".ogg", ".opus", ".m4a", ".aac"}


@click.command()
@click.option("--input-path", "-i", required=True,
              type=click.Path(exists=True, path_type=Path))
@click.option("--output-path", "-o", default=Path("fake.wav"),
              type=click.Path(path_type=Path))
@click.option("--checkpoint-path", default="checkpoints/s2-pro-tpu",
              help="directory holding codec.safetensors + codec_config.json")
@click.option("--tiny", is_flag=True, help="tiny random codec (testing)")
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(input_path, output_path, checkpoint_path, tiny, cpu):
    import torch

    from fish_speech_tpu_torch.audio.io import load_audio, write_wav
    from fish_speech_tpu_torch.models.dac.model import dac_encode, dac_from_indices

    device = torch.device("cpu" if cpu else "cuda:0")
    if tiny:
        from fish_speech_tpu_torch.config import dac_tiny
        from fish_speech_tpu_torch.models.dac.model import init_dac

        cfg = dac_tiny()
        params = init_dac(0, cfg, device=device)
    else:
        from fish_speech_tpu_torch.utils.checkpoint import load_codec

        params, cfg = load_codec(checkpoint_path, device=device)

    with torch.no_grad():
        if input_path.suffix.lower() in AUDIO_EXTENSIONS:
            audio = load_audio(input_path, cfg.sample_rate)  # (T,) mono float32
            click.echo(f"Encoding {len(audio) / cfg.sample_rate:.2f}s of audio",
                       err=True)
            codes, lens = dac_encode(params, cfg,
                                     torch.from_numpy(audio)[None, None].to(device))
            out = codes[0, :, : int(lens[0])].cpu().numpy()
            np.save(output_path.with_suffix(".npy"), out)
            click.echo(f"Saved code matrix {out.shape} -> "
                       f"{output_path.with_suffix('.npy')}", err=True)
        elif input_path.suffix.lower() == ".npy":
            indices = np.load(input_path)
            if indices.ndim != 2:
                raise click.ClickException(
                    f"Expected a 2D (1+N, T') code matrix, got {indices.ndim}D")
            click.echo(f"Decoding {indices.shape[1]} frames", err=True)
            wav = dac_from_indices(
                params, cfg, torch.from_numpy(indices.astype(np.int32))[None].to(device))
            write_wav(output_path, wav[0, 0].float().cpu().numpy(), cfg.sample_rate)
            click.echo(f"Saved {wav.shape[-1] / cfg.sample_rate:.2f}s -> "
                       f"{output_path}", err=True)
        else:
            raise click.ClickException(f"Unknown input type: {input_path.suffix}")


if __name__ == "__main__":
    main()
