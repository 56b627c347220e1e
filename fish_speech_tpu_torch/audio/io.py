"""WAV writing for the port: the streaming header and the 16-bit writer.

Copy of the parts of `fish_speech_tpu/audio/io.py` that the port uses, kept
here so the port never imports the JAX package (stdlib + numpy only).
"""

from __future__ import annotations

import io
import wave
from pathlib import Path
from typing import Union

import numpy as np


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
