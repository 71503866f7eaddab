"""AudioProcessor: the reference-audio front end ``mel_spectrogram`` and the
vocoder-free synthesis ``reconstruct_waveform`` (port of
``etts/ops/audio.py``). Each computes on its input tensor's device; numpy
input is computed on the CPU."""
from __future__ import annotations

import numpy as np
import torch

from .griffin_lim import griffin_lim, mel_to_linear
from .normalizers import get_normalizer
from .stft import MelSpectrogram

__all__ = ["AudioProcessor"]


class AudioProcessor:
    def __init__(self, config: dict):
        self.sampling_rate = config["sampling_rate"]
        self.n_fft = config["n_fft"]
        self.hop_length = config["hop_length"]
        self.win_length = config["win_length"]
        self.mel_channels = config["mel_channels"]
        self.f_min = config.get("f_min", 0) or 0
        self.f_max = config.get("f_max", None)
        self.normalizer = get_normalizer(config.get("normalizer", "WaveRNN"))
        self._mel = MelSpectrogram(
            self.sampling_rate, self.n_fft, self.hop_length, self.win_length,
            self.mel_channels, self.f_min, self.f_max)

    @staticmethod
    def _tensor(x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.float()

    def mel_spectrogram(self, wav) -> torch.Tensor:
        """wav (n,) -> normalized mel (mel_channels, t), float32."""
        return self.normalizer.normalize(self._mel(self._tensor(wav)))

    @torch.no_grad()
    def reconstruct_waveform(self, mel, n_iter: int = 32) -> torch.Tensor:
        """Normalized mel (mel_channels, t) -> waveform of hop * t samples:
        denormalize, NNLS mel inversion, Griffin-Lim from zero phase
        (`etts/ops/audio.py:49-72`). A mel shorter than n_fft // hop + 2
        frames is right-padded with the normalized value of amplitude 1e-5
        (near silence), so that the STFT's reflect padding stays valid."""
        mel = self._tensor(mel)
        t = mel.shape[1]
        t_min = self.n_fft // self.hop_length + 2
        if t < t_min:
            pad_val = float(self.normalizer.normalize(torch.tensor(1e-5)))
            mel = torch.nn.functional.pad(mel, (0, t_min - t), value=pad_val)
        mag = mel_to_linear(self.normalizer.denormalize(mel),
                            self.sampling_rate, self.n_fft,
                            self.mel_channels, self.f_min, self.f_max)
        wav = griffin_lim(mag, self.n_fft, self.hop_length, self.win_length,
                          n_iter=n_iter)
        return wav[:self.hop_length * t]
