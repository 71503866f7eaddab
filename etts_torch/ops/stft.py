"""Reflect-centred STFT, its inverse, and the Slaney mel filterbank (port
of ``etts/ops/stft.py:34-198``, librosa conventions):

  - periodic Hann window of ``win_length``, zero-padded centred to ``n_fft``
  - center=True framing with reflect padding of ``n_fft // 2``
  - Slaney-scale mel filters with Slaney area normalization
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "n_frames", "stft", "istft", "mel_filterbank",
           "MelSpectrogram"]


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


def n_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """The frame count ``stft`` gives an ``n_samples`` signal
    (`etts/ops/stft.py:62-72`): the CTC transcriber trims its decode to the
    unpadded wav's frames with it."""
    return max(1, 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length)


def stft(y: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int) -> torch.Tensor:
    """Complex STFT of a 1-D waveform, centred with reflect padding;
    returns (1 + n_fft//2, n_frames) complex64 like ``librosa.stft``.

    The frames are windowed and transformed in float64 and the result cast
    to complex64. With a float32 FFT the two frameworks round the quietest
    bins differently, and the normalizer's log magnifies that (5.2e-3 at a
    bin of amplitude 1e-5 in the golden fixture); in float64 only the JAX
    side's own float32 rounding is left."""
    window = torch.from_numpy(_padded_window(win_length, n_fft)).to(
        y.device, torch.float64)
    pad = n_fft // 2
    y = F.pad(y.double()[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = y.unfold(0, n_fft, hop_length)            # (n_frames, n_fft)
    return torch.fft.rfft(frames * window, dim=-1).T.to(torch.complex64)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Inverse of ``stft``: spec (1 + n_fft//2, n_frames) -> float32
    waveform by windowed overlap-add, divided by the overlapped squared
    window (at least 1e-10); ``center`` drops n_fft // 2 samples at each
    end, ``length`` then keeps the first ``length`` samples
    (`etts/ops/stft.py:90-117`). Computed in float64, as ``stft``."""
    window = torch.from_numpy(_padded_window(win_length, n_fft)).to(
        spec.device, torch.float64)
    frames = torch.fft.irfft(spec.to(torch.complex128).T, n=n_fft,
                             dim=-1) * window           # (n_frames, n_fft)
    n = frames.shape[0]
    total = n_fft + hop_length * (n - 1)
    idx = (torch.arange(n, device=spec.device)[:, None] * hop_length
           + torch.arange(n_fft, device=spec.device)).reshape(-1)
    y = frames.new_zeros(total).index_add_(0, idx, frames.reshape(-1))
    wsq = frames.new_zeros(total).index_add_(
        0, idx, (window ** 2).expand(n, n_fft).reshape(-1))
    y = y / torch.clamp(wsq, min=1e-10)
    if center:
        y = y[n_fft // 2:total - n_fft // 2]
    if length is not None:
        y = y[:length]
    return y.float()


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
        """The filterbank's product summed in float64 and rounded once to
        float32: a float32 product sums its 1 + n_fft // 2 terms in an
        order of the device's and the host's library (cuBLAS, or MKL on
        the host's instruction set), which moved a store's log-mels by
        1.24e-5 card against CPU (``chip_smoke.py`` phase 13's bar 1e-5)."""
        mag = stft(wav, self.n_fft, self.hop_length, self.win_length).abs()
        return (self.mel_basis.to(wav.device, torch.float64)
                @ mag.double()).float()
