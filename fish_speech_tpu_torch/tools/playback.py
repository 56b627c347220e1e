"""Local audio playback for the API client (reference
`tools/api_client.py:140-239` plays streamed PCM through pyaudio): the
port's copy of `fish_speech_tpu/tools/playback.py`.

Backend ladder, best-first, all optional:

  1. `sounddevice` (portaudio binding, lowest latency)
  2. `pyaudio` (what the reference uses)
  3. an `aplay` / `paplay` / `ffplay` binary fed raw s16le over stdin
  4. none -> PlaybackUnavailable; the client degrades to file-only output

Everything accepts interleaved little-endian int16 PCM so streamed chunks
can be written as they arrive off the socket (live playback, not
play-after-download).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional


class PlaybackUnavailable(RuntimeError):
    """No audio output backend exists in this environment."""


class AudioSink:
    """Incremental PCM sink: write s16le bytes as they arrive."""

    def write(self, pcm: bytes) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class _SounddeviceSink(AudioSink):
    def __init__(self, rate: int, channels: int):
        import sounddevice

        self._stream = sounddevice.RawOutputStream(
            samplerate=rate, channels=channels, dtype="int16")
        self._stream.start()

    def write(self, pcm: bytes) -> None:
        self._stream.write(pcm)

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()


class _PyaudioSink(AudioSink):
    def __init__(self, rate: int, channels: int):
        import pyaudio

        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=pyaudio.paInt16, channels=channels, rate=rate, output=True)

    def write(self, pcm: bytes) -> None:
        self._stream.write(pcm)

    def close(self) -> None:
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


class _SubprocessSink(AudioSink):
    """Pipe raw s16le into a system player binary."""

    _CANDIDATES = (
        ("aplay", lambda r, c: ["aplay", "-q", "-f", "S16_LE",
                                "-r", str(r), "-c", str(c), "-"]),
        ("paplay", lambda r, c: ["paplay", "--raw", "--format=s16le",
                                 f"--rate={r}", f"--channels={c}"]),
        ("ffplay", lambda r, c: ["ffplay", "-loglevel", "quiet", "-nodisp",
                                 "-autoexit", "-f", "s16le", "-ar", str(r),
                                 "-ch_layout", "mono" if c == 1 else "stereo",
                                 "-i", "-"]),
    )

    def __init__(self, rate: int, channels: int):
        for name, argv in self._CANDIDATES:
            if shutil.which(name):
                self._proc = subprocess.Popen(
                    argv(rate, channels), stdin=subprocess.PIPE,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                return
        raise PlaybackUnavailable("no system audio player found")

    def write(self, pcm: bytes) -> None:
        assert self._proc.stdin is not None
        self._proc.stdin.write(pcm)

    def close(self) -> None:
        assert self._proc.stdin is not None
        self._proc.stdin.close()
        self._proc.wait()


_BACKENDS = [_SounddeviceSink, _PyaudioSink, _SubprocessSink]


def open_sink(rate: int, channels: int = 1,
              backends: Optional[List[type]] = None) -> AudioSink:
    """Open the best available playback sink, or raise PlaybackUnavailable.

    `backends` is injectable for tests.
    """
    errors = []
    for cls in (backends if backends is not None else _BACKENDS):
        try:
            return cls(rate, channels)
        except (ImportError, OSError, PlaybackUnavailable) as e:
            errors.append(f"{cls.__name__}: {e}")
    raise PlaybackUnavailable(
        "no playback backend (install sounddevice or pyaudio, or provide "
        "aplay/paplay/ffplay); " + "; ".join(errors))


class WavStreamParser:
    """Incremental WAV demuxer for the streaming --play path.

    Feed socket chunks in; once the fmt + data chunk headers have gone by
    it exposes (rate, channels) and yields every subsequent byte as raw
    PCM. Handles headers split across arbitrary chunk boundaries.
    """

    def __init__(self):
        self._buf = bytearray()
        self.rate: Optional[int] = None
        self.channels: Optional[int] = None
        self._in_data = False

    def feed(self, chunk: bytes) -> bytes:
        """Returns the PCM payload bytes contained in `chunk` (possibly
        empty while the header is still streaming in)."""
        if self._in_data:
            return chunk
        self._buf += chunk
        import struct

        buf = self._buf
        if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
            if len(buf) >= 12:
                raise ValueError("stream is not RIFF/WAVE")
            return b""
        pos = 12
        while pos + 8 <= len(buf):
            cid = bytes(buf[pos:pos + 4])
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            if cid == b"fmt " and pos + 8 + 16 <= len(buf):
                _, ch, rate = struct.unpack("<HHI", buf[pos + 8:pos + 16])
                self.channels, self.rate = ch, rate
            if cid == b"data":
                if self.rate is None:
                    raise ValueError("wav data chunk before fmt chunk")
                self._in_data = True
                pcm = bytes(buf[pos + 8:])
                self._buf = bytearray()
                return pcm
            pos += 8 + size + (size & 1)
        return b""


def decode_to_pcm(body: bytes, fmt: str):
    """Server response body in `fmt` -> (s16le bytes, rate, channels).

    Used by the client's non-streaming --play path; wav/flac/mp3/opus all
    decode with in-repo code (no soundfile/pydub dependency).
    """
    import numpy as np

    if fmt in ("wav",):
        import io
        import wave

        with wave.open(io.BytesIO(body)) as f:
            if f.getsampwidth() != 2:
                raise ValueError("only 16-bit wav playback supported")
            return (f.readframes(f.getnframes()), f.getframerate(),
                    f.getnchannels())
    if fmt == "pcm":
        # server default rate; caller overrides if it knows better
        return body, 44100, 1
    if fmt == "flac":
        from fish_speech_tpu_torch.audio.transcode import decode_flac

        samples, sr = decode_flac(body)
        return samples.astype("<i2").tobytes(), sr, samples.shape[1]
    if fmt == "mp3":
        from fish_speech_tpu_torch.audio.libcodec import decode_mp3

        samples, sr = decode_mp3(body)
        return samples.astype("<i2").tobytes(), sr, samples.shape[1]
    if fmt == "opus":
        from fish_speech_tpu_torch.audio.libcodec import decode_opus

        samples, sr = decode_opus(body)
        pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
        return pcm.tobytes(), sr, pcm.shape[1]
    raise ValueError(f"cannot decode format {fmt!r} for playback")
