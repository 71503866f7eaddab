"""Mel normalizers (normalize and denormalize) and mu-law decoding (port
of ``etts/ops/normalizers.py:26-120``)."""
from __future__ import annotations

import math

import torch

__all__ = ["MelGAN", "WaveRNNNorm", "get_normalizer", "mu_law_decode",
           "db_to_amp"]


def amp_to_db(x):
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def db_to_amp(x):
    return torch.pow(10.0, x * 0.05)


class MelGAN:
    """Log of the clipped amplitude (`TransformerTTS/utils/audio.py:86-96`)."""

    clip_min = 1.0e-5

    def normalize(self, S):
        return torch.log(torch.clamp(S, min=self.clip_min))

    def denormalize(self, S):
        return torch.exp(S)


class WaveRNNNorm:
    """amp -> dB -> [0, 1] -> [-max_norm, max_norm]
    (`TransformerTTS/utils/audio.py:99-119`): TTS mels live in [-4, 4]."""

    def __init__(self, min_level_db: float = -100.0, max_norm: float = 4.0):
        self.min_level_db = min_level_db
        self.max_norm = max_norm

    def normalize(self, S):
        S = torch.clamp((amp_to_db(S) - self.min_level_db) / -self.min_level_db,
                        0.0, 1.0)
        return S * 2.0 * self.max_norm - self.max_norm

    def denormalize(self, S):
        S = (S + self.max_norm) / (2.0 * self.max_norm)
        return db_to_amp(torch.clamp(S, 0.0, 1.0) * -self.min_level_db
                         + self.min_level_db)


_NORMALIZERS = {"MelGAN": MelGAN, "WaveRNN": WaveRNNNorm}


def get_normalizer(name: str):
    if name not in _NORMALIZERS:
        raise ValueError(f"normalizer must be one of {sorted(_NORMALIZERS)}, "
                         f"got {name!r}")
    return _NORMALIZERS[name]()


def mu_law_decode(y, mu: int, from_labels: bool = True):
    """Inverse mu-law companding (`WaveRNN/utility/dsp.py:100-105`)."""
    if from_labels:
        y = 2.0 * y / (2.0 ** math.log2(mu) - 1.0) - 1.0
    m = mu - 1
    return torch.sign(y) / m * ((1 + m) ** torch.abs(y) - 1.0)
