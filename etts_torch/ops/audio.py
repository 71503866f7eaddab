"""AudioProcessor.mel_spectrogram — the reference-audio front end (port of
``etts/ops/audio.py:44``)."""
from __future__ import annotations

import numpy as np
import torch

from .normalizers import get_normalizer
from .stft import MelSpectrogram

__all__ = ["AudioProcessor"]


class AudioProcessor:
    def __init__(self, config: dict):
        self.sampling_rate = config["sampling_rate"]
        self.hop_length = config["hop_length"]
        self.normalizer = get_normalizer(config.get("normalizer", "WaveRNN"))
        self._mel = MelSpectrogram(
            self.sampling_rate, config["n_fft"], self.hop_length,
            config["win_length"], config["mel_channels"],
            config.get("f_min", 0) or 0, config.get("f_max", None))

    def mel_spectrogram(self, wav) -> torch.Tensor:
        """wav (n,) -> normalized mel (mel_channels, t), float32."""
        if not isinstance(wav, torch.Tensor):
            wav = torch.from_numpy(np.asarray(wav, np.float32))
        return self.normalizer.normalize(self._mel(wav.float()))
