"""Tempo adjustment without pitch change (WSOLA overlap-add).
(The port's copy of `fish_speech_tpu/audio/stretch.py`.)

Backs the `speed` parameter of the OpenAI-compatible `/v1/audio/speech`
endpoint (`server/app.py`). The reference has no speed control anywhere;
OpenAI's TTS API specifies `speed` in [0.25, 4.0] as a tempo change that
preserves pitch, so a naive resample (which shifts pitch) would be wrong.

WSOLA (waveform-similarity overlap-add) in plain numpy: fixed output hop
with 50%-overlap Hann windows, input segments picked near the nominal
time-scaled position but aligned by cross-correlation against the natural
continuation of the previously emitted segment, so overlapping regions stay
phase-coherent and the result is free of the metallic artifacts of plain
OLA. Host-side post-processing — the synthesis path on device is untouched.
"""

from __future__ import annotations

import numpy as np

# speed bounds mirror the OpenAI API contract
MIN_SPEED = 0.25
MAX_SPEED = 4.0


def _hann(n: int) -> np.ndarray:
    # periodic Hann so 50%-overlapped windows sum to exactly 1
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def time_stretch(
    x: np.ndarray,
    rate: float,
    frame: int = 1024,
    search: int = 384,
) -> np.ndarray:
    """Return `x` played at `rate`× tempo (rate>1 → shorter), same pitch.

    Mono float array in, float32 out with length ≈ len(x)/rate. Inputs too
    short for even one analysis window fall back to linear resampling
    (sub-25 ms snippets have no meaningful pitch to preserve).
    """
    if not (MIN_SPEED <= rate <= MAX_SPEED):
        raise ValueError(
            f"speed must be within [{MIN_SPEED}, {MAX_SPEED}], got {rate}"
        )
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"time_stretch expects mono 1-D audio, got {x.shape}")
    if rate == 1.0 or x.size == 0:
        return x
    n_out_target = max(int(round(x.size / rate)), 1)
    if x.size < frame * 2:
        # too short for overlap-add: linear-interp resample
        pos = np.linspace(0.0, x.size - 1.0, n_out_target)
        return np.interp(pos, np.arange(x.size), x).astype(np.float32)

    hop = frame // 2  # output hop; Hann at 50% overlap sums to 1
    win = _hann(frame).astype(np.float32)
    n_frames = max((n_out_target - frame) // hop + 1, 1)

    out = np.zeros(n_frames * hop + frame, dtype=np.float32)
    norm = np.zeros_like(out)

    # first segment: taken verbatim from the start
    prev_start = 0
    out[:frame] += x[:frame] * win
    norm[:frame] += win

    for k in range(1, n_frames):
        nominal = int(round(k * hop * rate))
        # natural continuation of the previous segment — what would follow
        # seamlessly if we kept reading the input at the previous position
        nat = prev_start + hop
        lo = max(nominal - search, 0)
        hi = min(nominal + search, x.size - frame)
        if hi <= lo or nat + hop > x.size:
            start = min(max(nominal, 0), max(x.size - frame, 0))
        else:
            # align the candidate's head with the continuation's head over
            # one hop of samples (the region that overlap-adds next)
            target = x[nat : nat + hop]
            window_region = x[lo : hi + hop]
            corr = np.correlate(window_region, target, mode="valid")
            start = lo + int(np.argmax(corr))
        seg = x[start : start + frame]
        if seg.size < frame:  # tail: zero-pad the last window
            seg = np.pad(seg, (0, frame - seg.size))
        pos = k * hop
        out[pos : pos + frame] += seg * win
        norm[pos : pos + frame] += win
        prev_start = start

    nz = norm > 1e-6
    out[nz] /= norm[nz]
    return out[:n_out_target]
