"""HTTP API client (reference `tools/api_client.py`): msgpack POST to
/v1/tts with streaming save-to-file, base64 reference upload, and
optional live playback (`--play`, reference `api_client.py:140-239`).
The port's copy of `fish_speech_tpu/tools/api_client.py`; it does no
device work (the server it calls runs on the card).

    python -m fish_speech_tpu_torch.tools.api_client \
        --url http://127.0.0.1:8080/v1/tts --text "hello" -o out.wav

With `--streaming --play` PCM is played as it arrives off the socket;
without `--streaming`, the saved file is decoded (wav/flac/mp3/opus, all
with in-repo decoders) and played after download. Playback degrades
gracefully to file-only when no audio backend exists.
"""

from __future__ import annotations

import base64
from pathlib import Path

import click
import msgpack
import requests


@click.command()
@click.option("--url", default="http://127.0.0.1:8080/v1/tts")
@click.option("--text", "-t", default="Hello, world!")
@click.option("--output", "-o", type=click.Path(path_type=Path),
              default=Path("generated_audio.wav"))
@click.option("--reference-audio", "-ra", type=click.Path(exists=True),
              multiple=True)
@click.option("--reference-text", "-rt", type=str, multiple=True)
@click.option("--reference-id", type=str, default=None)
@click.option("--api-key", type=str, default=None)
@click.option("--streaming/--no-streaming", default=False)
@click.option("--format", "fmt",
              type=click.Choice(["wav", "pcm", "flac", "mp3", "opus"]),
              default="wav")
@click.option("--chunk-length", type=int, default=200)
@click.option("--max-new-tokens", type=int, default=1024)
@click.option("--top-p", type=float, default=0.8)
@click.option("--temperature", type=float, default=0.8)
@click.option("--repetition-penalty", type=float, default=1.1)
@click.option("--seed", type=int, default=None)
@click.option("--use-memory-cache", type=click.Choice(["on", "off"]),
              default="off")
@click.option("--latency", type=click.Choice(["normal", "balanced"]),
              default="normal")
@click.option("--play/--no-play", default=False,
              help="Play audio locally (live for --streaming).")
def main(url, text, output, reference_audio, reference_text, reference_id,
         api_key, streaming, fmt, chunk_length, max_new_tokens, top_p,
         temperature, repetition_penalty, seed, use_memory_cache, latency,
         play):
    if reference_audio and len(reference_audio) != len(reference_text):
        raise click.UsageError(
            "--reference-audio and --reference-text counts must match"
        )

    references = [
        {
            "audio": base64.b64encode(Path(a).read_bytes()).decode(),
            "text": t,
        }
        for a, t in zip(reference_audio, reference_text)
    ]

    payload = {
        "text": text,
        "references": references,
        "reference_id": reference_id,
        "format": fmt,
        "streaming": streaming,
        "chunk_length": chunk_length,
        "max_new_tokens": max_new_tokens,
        "top_p": top_p,
        "temperature": temperature,
        "repetition_penalty": repetition_penalty,
        "seed": seed,
        "use_memory_cache": use_memory_cache,
        "latency": latency,
    }

    headers = {"Content-Type": "application/msgpack"}
    if api_key:
        headers["Authorization"] = f"Bearer {api_key}"

    import time

    from fish_speech_tpu_torch.tools import playback

    t0 = time.time()
    sink = None
    wav_parser = playback.WavStreamParser() if (streaming and play) else None
    try:
        with requests.post(
            url, data=msgpack.packb(payload, use_bin_type=True),
            headers=headers, stream=streaming, timeout=3600,
        ) as r:
            if r.status_code != 200:
                raise click.ClickException(
                    f"HTTP {r.status_code}: {r.text[:500]}")
            first = None
            with open(output, "wb") as f:
                for chunk in r.iter_content(chunk_size=8192):
                    if first is None:
                        first = time.time() - t0
                    f.write(chunk)
                    if wav_parser is not None:
                        pcm = wav_parser.feed(chunk)
                        if pcm and sink is None:
                            try:
                                sink = playback.open_sink(
                                    wav_parser.rate, wav_parser.channels)
                            except playback.PlaybackUnavailable as e:
                                click.echo(f"playback disabled: {e}", err=True)
                                wav_parser = None
                                continue
                        if pcm and sink is not None:
                            sink.write(pcm)
    finally:
        if sink is not None:
            sink.close()
    click.echo(
        f"Saved {output} (first byte after {first:.2f}s, "
        f"total {time.time() - t0:.2f}s)"
    )

    if play and not streaming:
        try:
            pcm, rate, channels = playback.decode_to_pcm(
                output.read_bytes(), fmt)
            sink = playback.open_sink(rate, channels)
            try:
                sink.write(pcm)
            finally:
                sink.close()
        except (playback.PlaybackUnavailable, ValueError) as e:
            click.echo(f"playback disabled: {e}", err=True)


if __name__ == "__main__":
    main()
