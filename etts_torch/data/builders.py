"""The vocoder's training store, built from a directory of wavs (port of
the vocoder half of ``etts/data/builders.py``; the TTS half,
``build_tts_dataset``, is not ported yet).

``build_vocoder_dataset`` writes what ``train_wavernn --data`` reads:
``mel/{id}.npy``, the WaveRNN-normalised mel of ``ops.audio.AudioProcessor``
in the vocoder's convention, (n_mels, t) in [0, 1] (``(mel + 4) / 8``);
``quant/{id}.npy``, int64 sample labels (16-bit for MOL; mu-law or
``bits``-bit for RAW); and ``dataset.pkl``, the list of ``(id, mel
frames)``. Wavs are read and files written on a thread pool; the mel is
computed on ``device``, one wav at a time, on the main thread; the labels
on the CPU.
"""
from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops.audio import AudioProcessor
from ..ops.normalizers import float_to_label, mu_law_encode
from .audio_io import load_wav

__all__ = ["build_vocoder_dataset"]


def _pipelined_feature_extract(items, load_fn, compute_fn, save_fn,
                               njobs: int) -> list:
    """``save_fn(item, compute_fn(item, load_fn(item)))`` for every item,
    the results in order: loads (at most ``2 * njobs`` ahead) and saves on
    a pool of ``njobs`` threads, the computes in order on this thread.
    etts' tqdm progress bar is left out (no tqdm on the card's machine)."""
    if njobs <= 1:
        return [save_fn(x, compute_fn(x, load_fn(x))) for x in items]
    with ThreadPoolExecutor(max_workers=njobs) as pool:
        window = njobs * 2
        loads = {i: pool.submit(load_fn, items[i])
                 for i in range(min(window, len(items)))}
        saves = []
        for i in range(len(items)):
            loaded = loads.pop(i).result()
            if i + window < len(items):
                loads[i + window] = pool.submit(load_fn, items[i + window])
            saves.append(pool.submit(save_fn, items[i],
                                     compute_fn(items[i], loaded)))
        return [s.result() for s in saves]


def _quantize(y, mode: str, bits: int, mu_law: bool,
              peak_norm: bool) -> np.ndarray:
    """float32 samples -> int64 labels: 16-bit for MOL; for RAW mu-law
    (``2^bits`` classes) or ``bits``-bit linear; peak-normalised first
    with ``peak_norm``."""
    if peak_norm:
        y = y / max(np.max(np.abs(y)), 1e-8)
    y = torch.from_numpy(np.asarray(y, np.float32))
    if mode == "RAW":
        q = mu_law_encode(y, 2 ** bits) if mu_law else float_to_label(y, bits)
    else:
        q = float_to_label(y, 16)
    return q.numpy().astype(np.int64)


def build_vocoder_dataset(wav_dir, out_dir, config: dict, *, mode="MOL",
                          bits=9, mu_law=True, peak_norm=False,
                          extension=".wav", njobs=16, device="cpu") -> str:
    """The store of every ``*{extension}`` in ``wav_dir`` (sorted) under
    ``out_dir``, read at the config's ``sampling_rate``; returns
    ``out_dir``."""
    out = Path(out_dir)
    (out / "mel").mkdir(parents=True, exist_ok=True)
    (out / "quant").mkdir(parents=True, exist_ok=True)
    audio = AudioProcessor({**config, "normalizer": "WaveRNN"})
    wavs = sorted(Path(wav_dir).glob(f"*{extension}"))

    def load(w):
        return load_wav(str(w), config["sampling_rate"])[0]

    def compute(w, y):
        mel = audio.mel_spectrogram(torch.from_numpy(y).to(device))
        return ((mel.cpu().numpy() + 4.0) / 8.0,
                _quantize(y, mode, bits, mu_law, peak_norm))

    def save(w, result):
        mel, quant = result
        np.save(out / "mel" / f"{w.stem}.npy", mel.astype(np.float32))
        np.save(out / "quant" / f"{w.stem}.npy", quant)
        return (w.stem, mel.shape[-1])

    dataset = _pipelined_feature_extract(wavs, load, compute, save, njobs)
    with open(out / "dataset.pkl", "wb") as f:
        pickle.dump(dataset, f)
    return str(out)
