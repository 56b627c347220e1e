"""Linear and log-mel spectrograms on torch tensors, the port of
`fish_speech_tpu/audio/spectrogram.py`.

Reference: `fish_speech/utils/spectrogram.py` (torchaudio-based), with the
same parameters: center padding with reflect, slaney-scale mel bank, log
clamp at 1e-5. Used by codec training losses and by the quality harness's
spectral similarity proxy (`tools/eval_quality.py:spectral_sim`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(sample_rate: int, n_fft: int, n_mels: int,
                    f_min: float = 0.0, f_max: float = None) -> np.ndarray:
    """Slaney-style mel filterbank, (n_mels, n_fft//2 + 1)."""
    f_max = f_max or sample_rate / 2

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # slaney: linear below 1 kHz, log above
        mel = np.where(
            f < 1000.0, f * 3 / 200.0, 15.0 + 27.0 * np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4)
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(
            m < 15.0, m * 200.0 / 3, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0)
        )

    mels = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)

    bank = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        bank[i] = np.maximum(0.0, np.minimum(up, down))
    # slaney normalization
    enorm = 2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels])
    bank *= enorm[:, None]
    return bank.astype(np.float32)


def stft_magnitude(x, n_fft: int, hop_length: int, win_length: int,
                   center: bool = True):
    """|STFT| of (..., T) -> (..., frames, n_fft//2+1): `torch.stft` with
    the JAX module's periodic Hann window of `win_length`, zero-padded to
    `n_fft` in the middle, and reflect padding of n_fft // 2 on each side
    when `center`."""
    lead = x.shape[:-1]
    win = torch.as_tensor(hann_window(win_length), dtype=x.dtype, device=x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop_length,
                      win_length=win_length, window=win, center=center,
                      pad_mode="reflect", return_complex=True)
    mag = spec.abs().transpose(-1, -2)  # (N, frames, bins)
    return mag.reshape(*lead, *mag.shape[-2:])


def linear_spectrogram(x, n_fft=2048, hop_length=512, win_length=2048):
    return stft_magnitude(x, n_fft, hop_length, win_length)


def log_mel_spectrogram(x, sample_rate=44100, n_fft=2048, hop_length=512,
                        win_length=2048, n_mels=160, f_min=0.0, f_max=None):
    """(..., T) -> (..., n_mels, frames), log-compressed."""
    mag = stft_magnitude(x, n_fft, hop_length, win_length)  # (..., F, bins)
    bank = torch.as_tensor(mel_filter_bank(sample_rate, n_fft, n_mels, f_min, f_max),
                           dtype=mag.dtype, device=mag.device)
    mel = torch.einsum("...fb,mb->...mf", mag, bank)
    return torch.log(torch.clamp(mel, min=1e-5))
