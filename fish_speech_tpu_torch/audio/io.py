"""Audio I/O for the port: WAV read/write (stdlib + numpy), the streaming
header, and polyphase resampling (scipy's `resample_poly`).

Copy of the parts of `fish_speech_tpu/audio/io.py` that the port uses, kept
here so the port never imports the JAX package. `load_audio` reads WAV
only: FLAC and the libav fallback need copies of `audio/transcode.py`,
`audio/libav.py` and `native/`, which come with the HTTP server (ROADMAP
§1 item 6).
"""

from __future__ import annotations

import io
import math
import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path_or_bytes: Union[str, Path, bytes]) -> Tuple[np.ndarray, int]:
    """Read a WAV file. Returns (samples (channels, T) float32 in [-1,1], sr).

    Supports PCM 8/16/24/32-bit and IEEE float32.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = io.BytesIO(bytes(path_or_bytes))
    else:
        buf = open(str(path_or_bytes), "rb")
    try:
        data = buf.read()
    finally:
        buf.close()

    # Parse RIFF manually to support float wavs that the `wave` module rejects.
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("Missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt

    if audio_format in (1, 0xFFFE):  # PCM (or extensible, assume PCM)
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / (1 << 23)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code: {audio_format}")

    n = (len(x) // channels) * channels
    x = x[:n].reshape(-1, channels).T  # (channels, T)
    return np.ascontiguousarray(x), sr


def write_wav(path: Union[str, Path], samples: np.ndarray, sr: int) -> None:
    """Write mono/stereo float samples in [-1,1] to a 16-bit PCM WAV."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, _ = samples.shape
    pcm = np.clip(samples.T, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def wav_chunk_header(sample_rate: int = 44100, bit_depth: int = 16,
                     channels: int = 1) -> bytes:
    """A WAV header with zero data length, for chunked HTTP streaming."""
    buffer = io.BytesIO()
    with wave.open(buffer, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(bit_depth // 8)
        f.setframerate(sample_rate)
    header = buffer.getvalue()
    buffer.close()
    return header


def resample(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if sr_from == sr_to:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr_from, sr_to)
    return resample_poly(x, sr_to // g, sr_from // g, axis=-1).astype(np.float32)


def load_audio(path_or_bytes, target_sr: int) -> np.ndarray:
    """Read a WAV clip, downmix to mono, resample. Returns (T,).

    Raises ValueError for anything else (FLAC, mp3, ogg, ...): their
    decoders are not ported yet (ROADMAP §1 item 6)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:4])
    else:
        with open(str(path_or_bytes), "rb") as f:
            head = f.read(4)
    if head != b"RIFF":
        raise ValueError("only WAV audio is read by the port (FLAC and the "
                         "libav formats: ROADMAP §1 item 6, the HTTP server's "
                         "host copies)")
    x, sr = read_wav(path_or_bytes)
    mono = x.mean(axis=0) if x.shape[0] > 1 else x[0]
    return resample(mono, sr, target_sr)
