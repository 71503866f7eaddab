"""Griffin-Lim phase reconstruction and mel -> linear inversion (port of
``etts/ops/griffin_lim.py``), for ``AudioProcessor.reconstruct_waveform``:
the synthesis path without a vocoder. Plain PyTorch on the tensors'
device; the STFT pair computes in float64 (``ops/stft.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .stft import istft, mel_filterbank, stft

__all__ = ["griffin_lim", "mel_to_linear", "nnls"]


def griffin_lim(mag: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, n_iter: int = 32, momentum: float = 0.99,
                generator: Optional[torch.Generator] = None,
                length: Optional[int] = None) -> torch.Tensor:
    """Waveform from a magnitude spectrogram (1 + n_fft//2, t): accelerated
    Griffin-Lim in librosa's momentum form (`etts/ops/griffin_lim.py:19-52`).
    The initial phase is zero without ``generator``, which is deterministic,
    else uniform in [-pi, pi) drawn from it."""
    mag = mag.float()
    if generator is not None:
        phase = (torch.rand(mag.shape, generator=generator, device=mag.device)
                 * (2 * math.pi) - math.pi)
        angles = torch.polar(torch.ones_like(phase), phase)
    else:
        angles = torch.ones(mag.shape, dtype=torch.complex64,
                            device=mag.device)
    t = mag.shape[1]

    def project(ang):
        """mag * angles -> waveform -> STFT, cut or zero-padded to t frames."""
        rebuilt = stft(istft(mag * ang, n_fft, hop_length, win_length),
                       n_fft, hop_length, win_length)
        if rebuilt.shape[1] < t:
            rebuilt = torch.nn.functional.pad(rebuilt,
                                              (0, t - rebuilt.shape[1]))
        return rebuilt[:, :t]

    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = project(angles)
        upd = rebuilt - (momentum / (1.0 + momentum)) * tprev
        angles = upd / torch.clamp(upd.abs(), min=1e-16)
        tprev = rebuilt
    return istft(mag * angles, n_fft, hop_length, win_length, length=length)


def nnls(A: torch.Tensor, B: torch.Tensor, n_iter: int = 40) -> torch.Tensor:
    """argmin_{X >= 0} |A X - B| by projected gradient with Nesterov
    momentum from the clipped pseudo-inverse solution, step 1 / L with L
    from 8 power iterations on A^T A (`etts/ops/griffin_lim.py:55-83`).
    float32, as etts."""
    A, B = A.float(), B.float()
    AtA = A.T @ A
    v = torch.ones(AtA.shape[0], 1, device=A.device)
    for _ in range(8):
        v = AtA @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
    L = torch.clamp((v.T @ AtA @ v)[0, 0], min=1e-8)
    AtB = A.T @ B
    x = y = torch.clamp(torch.linalg.pinv(A) @ B, min=0.0)
    t = 1.0
    for _ in range(n_iter):
        x_new = torch.clamp(y - (AtA @ y - AtB) / L, min=0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def mel_to_linear(mel_amp: torch.Tensor, sample_rate: int, n_fft: int,
                  n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None,
                  n_iter: int = 40) -> torch.Tensor:
    """Amplitude mel (n_mels, t) -> linear magnitude (1 + n_fft//2, t), as
    ``librosa.feature.inverse.mel_to_stft`` with power 1
    (`etts/ops/griffin_lim.py:86-92`)."""
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin,
                                            fmax)).to(mel_amp.device)
    return nnls(basis, mel_amp, n_iter=n_iter)
