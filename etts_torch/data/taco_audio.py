"""GST-Tacotron's audio chain (port of ``etts/data/taco_builders.py:23-52``):
a waveform's linear and mel spectrograms in Tacotron's [0, 1] dB
convention (pre-emphasis 0.97, dB with a reference level of 20), and the
endpoint that trims synthesized silence. ``data/taco_builders.py`` builds
the training store from them."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.normalizers import amp_to_db, normalize_db, preemphasis
from ..ops.stft import mel_filterbank, stft

__all__ = ["taco_linear_and_mel", "find_endpoint"]


def taco_linear_and_mel(wav, config: dict):
    """wav (n,) -> (linear (t, 1 + n_fft // 2), mel (t, mel_channels)), both
    float32 in [0, 1], computed on the tensor's device (numpy on the CPU)
    (`gst_tacotron/util/audio.py:94-118`). The STFT is the port's float64
    one (``ops/stft.py``)."""
    if not isinstance(wav, torch.Tensor):
        wav = torch.from_numpy(np.asarray(wav, np.float32))
    y = preemphasis(wav.float(), config.get("preemphasis", 0.97))
    mag = stft(y, config["n_fft"], config["hop_length"],
               config["win_length"]).abs()
    ref_db = config.get("ref_level_db", 20)
    min_db = config.get("min_level_db", -100)
    linear = normalize_db(amp_to_db(mag) - ref_db, min_db)
    basis = torch.from_numpy(mel_filterbank(
        config["sampling_rate"], config["n_fft"], config["mel_channels"],
        config.get("f_min", 0) or 0, config.get("f_max"))).to(mag.device)
    mel = normalize_db(amp_to_db(basis @ mag) - ref_db, min_db)
    return linear.T, mel.T


def find_endpoint(wav, sample_rate, threshold_db=-40.0, min_silence_sec=0.8):
    """First long-silence endpoint of a numpy waveform
    (`gst_tacotron/util/audio.py:55-62`)."""
    window = int(sample_rate * min_silence_sec)
    hop = window // 4
    threshold = 10 ** (threshold_db / 20.0)
    for x in range(hop, len(wav) - window, hop):
        if np.max(np.abs(wav[x:x + window])) < threshold:
            return x + hop
    return len(wav)
