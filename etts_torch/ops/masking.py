"""Sinusoidal positional encoding and padding masks (port of
``etts/ops/masking.py``). Masks are float, 1 = masked, shaped (b, 1, 1, t);
the incremental decode masks the future by reading its caches up to the
current step."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["positional_encoding", "encoder_padding_mask", "mel_padding_mask"]


def positional_encoding(max_position: int, model_dim: int) -> np.ndarray:
    """(1, max_position, model_dim), sin at even / cos at odd dims."""
    pos = np.arange(max_position)[:, None].astype(np.float64)
    i = np.arange(model_dim)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, (2 * (i // 2)) / float(model_dim))
    angle[:, 0::2] = np.sin(angle[:, 0::2])
    angle[:, 1::2] = np.cos(angle[:, 1::2])
    return angle[None].astype(np.float32)


def encoder_padding_mask(token_ids: torch.Tensor) -> torch.Tensor:
    """(b, t) ids -> (b, 1, 1, t); 1 where id == 0 (pad)."""
    return (token_ids == 0).float()[:, None, None, :]


def mel_padding_mask(mel: torch.Tensor) -> torch.Tensor:
    """(b, t, c) -> (b, 1, 1, t); a frame is padding iff all channels are 0."""
    return (mel.abs().sum(-1) == 0).float()[:, None, None, :]
