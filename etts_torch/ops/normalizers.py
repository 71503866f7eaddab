"""Mel normalizers (normalize and denormalize), mu-law companding, the
float-to-label quantization of the vocoder store, and the Tacotron path's
dB normalization and pre-/de-emphasis filters (port of
``etts/ops/normalizers.py:26-141``)."""
from __future__ import annotations

import math

import torch

__all__ = ["MelGAN", "WaveRNNNorm", "get_normalizer", "mu_law_encode",
           "mu_law_decode", "float_to_label",
           "amp_to_db", "db_to_amp", "normalize_db", "denormalize_db",
           "preemphasis", "deemphasis", "vocoder_mel"]


def vocoder_mel(mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A TTS mel in [-4, 4] -> the vocoder's (mel + 4) / 8 in [0, 1],
    float32. The arithmetic runs in ``dtype``, the dtype the mel was made
    in: a bf16 model's mel rounds (mel + 4) to bf16, as etts' numpy bf16
    arithmetic on it does (`etts/api.py:275`)."""
    return ((mel.to(dtype) + 4.0) / 8.0).float()


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


def mu_law_encode(x, mu: int):
    """Float in [-1, 1] -> label in [0, mu - 1], as a float
    (`WaveRNN/utility/dsp.py:94-97`)."""
    m = mu - 1
    fx = torch.sign(x) * torch.log1p(m * torch.abs(x)) / math.log1p(m)
    return torch.floor((fx + 1.0) / 2.0 * m + 0.5)


def float_to_label(x, bits: int):
    """Float in [-1, 1] -> label in [0, 2^bits - 1], as a float (callers
    truncate it to an integer)."""
    x = (x + 1.0) * (2.0 ** bits - 1.0) / 2.0
    return torch.clamp(x, 0.0, 2.0 ** bits - 1.0)


def mu_law_decode(y, mu: int, from_labels: bool = True):
    """Inverse mu-law companding (`WaveRNN/utility/dsp.py:100-105`)."""
    if from_labels:
        y = 2.0 * y / (2.0 ** math.log2(mu) - 1.0) - 1.0
    m = mu - 1
    return torch.sign(y) / m * ((1 + m) ** torch.abs(y) - 1.0)


def normalize_db(S_db, min_level_db: float = -100.0):
    """dB -> [0, 1] (`WaveRNN/utility/dsp.py:54-55`)."""
    return torch.clamp((S_db - min_level_db) / -min_level_db, 0.0, 1.0)


def denormalize_db(S, min_level_db: float = -100.0):
    return torch.clamp(S, 0.0, 1.0) * -min_level_db + min_level_db


def preemphasis(x, coef: float = 0.97):
    """y[t] = x[t] - coef * x[t-1] (FIR; `WaveRNN/utility/dsp.py:86-87`)."""
    return torch.cat([x[:1], x[1:] - coef * x[:-1]])


# samples a block of deemphasis: one (block, block) product per level
_IIR_BLOCK = 256


def deemphasis(x, coef: float = 0.97):
    """The inverse filter y[t] = x[t] + coef * y[t-1], y[-1] = 0, on x's
    device, float32 out. etts runs it as a float32 ``lax.scan``, one
    sample a step; here it is blockwise in float64, with no loop over
    samples: within a block of ``_IIR_BLOCK`` samples, a product with the
    lower-triangular matrix of powers coef^(i - j); across blocks, the
    true last sample of the block before times coef^(i + 1), those last
    samples being the same recurrence at coef^block, solved the same way."""
    return _iir(x.double(), coef).float()


def _iir(x, coef: float):
    n, b = x.shape[0], _IIR_BLOCK
    i = torch.arange(min(n, b), device=x.device)
    powers = torch.tensor(coef, dtype=x.dtype, device=x.device) ** i
    diff = i[:, None] - i[None, :]
    lower = torch.where(diff >= 0, powers[diff.clamp(min=0)], 0.0)
    if n <= b:
        return lower @ x
    nb = -(-n // b)
    local = torch.nn.functional.pad(x, (0, nb * b - n)).view(nb, b) @ lower.T
    last = _iir(local[:, -1], coef ** b)       # each block's true last sample
    carry = torch.cat([last.new_zeros(1), last[:-1]])
    return (local + carry[:, None] * (powers * coef)).reshape(-1)[:n]
