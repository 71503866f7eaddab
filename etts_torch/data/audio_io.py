"""WAV reading and writing with scipy alone (own copy of
``etts/data/audio_io.py``): ``load_wav`` reads PCM or float wavs as
float32 in [-1, 1], mixed to mono and resampled by ``resample_poly``;
``save_wav`` writes 16-bit PCM, peak-normalised above 1."""
from __future__ import annotations

from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

__all__ = ["load_wav", "save_wav"]


def load_wav(path, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """(float32 samples in [-1, 1], sample rate), resampled to
    ``sample_rate`` where it is given and differs: ``librosa.load(path,
    sr=...)`` for PCM and float wavs."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        g = gcd(sr, sample_rate)
        y = resample_poly(y, sample_rate // g, sr // g).astype(np.float32)
        sr = sample_rate
    return y, sr


def save_wav(wav, path, sample_rate: int):
    wav = np.asarray(wav, np.float32)
    peak = np.max(np.abs(wav))
    if peak > 1.0:
        wav = wav / peak
    wavfile.write(path, sample_rate, (wav * 32767).astype(np.int16))
