"""ffmpeg-backed audio decode (any container/codec the system libav stack
demuxes) via the native shim `native/av_decode.c`: the port's copy of
`fish_speech_tpu/audio/libav.py`, the shim built by `native.build_av`
into `native.build_dir()`.

Role in the framework:

- **Input-format parity**: the reference loads reference/prompt audio with
  torchaudio/soundfile (any of mp3/ogg/flac/m4a/...; see reference
  `fish_speech/utils/file.py` AUDIO_EXTENSIONS and the server's reference
  upload paths). Our self-contained readers cover WAV and FLAC;
  `audio/io.py:load_audio` falls back to this decoder for everything else.
- **Cross-validation oracle in tests**: ffmpeg's independent FLAC decoder
  verifies the from-scratch FLAC encoder (`audio/transcode.py`) sample-
  exactly, and its Ogg/Opus/mp3 demux+decode verifies the from-scratch Ogg
  container and LAME framing (`audio/libcodec.py`) — authorship is fully
  independent of ours, closing the "no external decoder" caveat.

Loads lazily; missing libraries or headers raise TranscodeUnavailable and
only disable this fallback (the WAV/FLAC native paths are unaffected).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from fish_speech_tpu_torch.audio.transcode import TranscodeUnavailable

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> ctypes.CDLL:
    global _LIB, _TRIED
    if _LIB is None:
        if _TRIED:
            raise TranscodeUnavailable("libav shim unavailable")
        _TRIED = True
        try:
            from fish_speech_tpu_torch.native import build_av

            lib = ctypes.CDLL(str(build_av()))
        except Exception as e:  # no gcc/headers/libs -> fallback disabled
            raise TranscodeUnavailable(f"libav shim unavailable: {e}") from e
        lib.fsav_decode.restype = ctypes.c_int32
        lib.fsav_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _load()
        return True
    except TranscodeUnavailable:
        return False


def decode_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory audio stream of any libav-supported format.

    Returns (float32 (N, C) in [-1, 1], sample_rate). Raises ValueError on
    non-audio input, TranscodeUnavailable if the shim can't load.
    """
    lib = _load()
    data = bytes(data)
    # Compressed audio rarely exceeds ~12x expansion vs the container size
    # in float32 (mp3@128k is ~11x); grow-and-retry handles the rest.
    cap = max(1 << 16, min(len(data) * 16, 1 << 28))
    while True:
        out = np.empty(cap, dtype=np.float32)
        n = ctypes.c_int64()
        sr = ctypes.c_int32()
        ch = ctypes.c_int32()
        rc = lib.fsav_decode(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
            ctypes.byref(n), ctypes.byref(sr), ctypes.byref(ch))
        if rc == 0:
            break
        if rc == -3:
            cap = max(cap * 2, int(n.value) * 2)
            continue
        raise ValueError(f"libav decode failed (rc={rc})")
    channels = max(int(ch.value), 1)
    pcm = out[: int(n.value)].reshape(-1, channels)
    return pcm, int(sr.value)
