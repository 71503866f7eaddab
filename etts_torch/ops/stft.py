"""Reflect-centred STFT and the Slaney mel filterbank (port of
``etts/ops/stft.py:34-198``, librosa conventions):

  - periodic Hann window of ``win_length``, zero-padded centred to ``n_fft``
  - center=True framing with reflect padding of ``n_fft // 2``
  - Slaney-scale mel filters with Slaney area normalization
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "stft", "mel_filterbank", "MelSpectrogram"]


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window of win_length centred in an n_fft buffer."""
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, np.float32)
    out[lpad:lpad + win_length] = hann_window(win_length)
    return out


def stft(y: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int) -> torch.Tensor:
    """Complex STFT of a 1-D waveform, centred with reflect padding;
    returns (1 + n_fft//2, n_frames) like ``librosa.stft``."""
    window = torch.from_numpy(_padded_window(win_length, n_fft)).to(y.device)
    pad = n_fft // 2
    y = F.pad(y[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = y.unfold(0, n_fft, hop_length)            # (n_frames, n_fft)
    return torch.fft.rfft(frames * window, dim=-1).T


_F_SP = 200.0 / 3          # Slaney linear region step (Hz per mel)
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = float(np.log(6.4) / 27.0)


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                    / _LOGSTEP, f / _F_SP)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (n_mels, 1 + n_fft//2),
    as ``librosa.filters.mel`` with htk=False, norm='slaney'."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


class MelSpectrogram:
    """wav (n,) -> linear-amplitude mel (n_mels, t)."""

    def __init__(self, sample_rate: int, n_fft: int, hop_length: int,
                 win_length: int, n_mels: int, fmin: float = 0.0,
                 fmax: float | None = None):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        mag = stft(wav, self.n_fft, self.hop_length, self.win_length).abs()
        return self.mel_basis.to(wav.device) @ mag
