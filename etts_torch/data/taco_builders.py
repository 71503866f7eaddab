"""GST-Tacotron's training store (port of ``etts/data/taco_builders.py``,
`gst_tacotron/preprocess.py` and `datasets/{ljspeech,blizzard,
blizzard2013}.py`): each utterance's linear and mel spectrograms
(``taco_audio.taco_linear_and_mel``, Tacotron's [0, 1] dB convention) as
``taco-linear-{i:05d}.npy`` (t, 1 + n_fft // 2) and ``taco-mel-{i:05d}.npy``
(t, n_mels), float32, and ``train.txt``, a line an utterance kept:
``linear file|mel file|frames|text``, which ``python -m
etts_torch.train_tacotron`` reads.

Readers (``DATASET_FORMATS``): "ljspeech" and "blizzard2013",
``metadata.csv`` rows ``id|...|text`` beside ``wavs/``; "blizzard", the
audiobook layout (each book's tab-separated ``sentence_index.txt``, rows
of confidence above 90 kept, ``wav/`` and ``lab/``), each wav cut to the
span its ``.lab`` silence labels leave. With ``max_out_frames``, an
utterance of more than that many hops of samples is dropped; the file
names keep its index, so they have gaps. Wavs are read and files written
on a thread pool; the spectrograms are computed on ``device``, the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .audio_io import load_wav
from .builders import _pipelined_feature_extract
from .taco_audio import taco_linear_and_mel

__all__ = ["DATASET_FORMATS", "build_tacotron_dataset"]


def _iter_ljspeech(data_dir, config: dict, column_sep: str = "|"):
    """(wav path, text, None) of each ``metadata.csv`` row of two or more
    columns: the id's part before its first dot, the last column."""
    wav_dir = Path(data_dir) / config.get("wav_subdir_name", "wavs")
    meta = Path(data_dir) / config.get("metadata_filename", "metadata.csv")
    with open(meta, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(column_sep)
            if len(parts) >= 2:
                name = parts[0].split(".")[0]
                yield str(wav_dir / (name + ".wav")), parts[-1], None


def _parse_blizzard_labels(path, end_buffer: float = 0.05):
    """(start, end) seconds of a ``.lab`` file's speech: after a leading
    "sil" label's time; up to the label before a trailing "sil", plus
    ``end_buffer`` (None: to the end)."""
    labels = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= 3:
                labels.append((float(parts[0]), " ".join(parts[2:])))
    start, end = 0.0, None
    if labels and labels[0][1] == "sil":
        start = labels[0][0]
    if len(labels) >= 2 and labels[-1][1] == "sil":
        end = labels[-2][0] + end_buffer
    return start, end


def _iter_blizzard(data_dir, config: dict,
                   books=("ATrampAbroad", "TheManThatCorruptedHadleyburg"),
                   min_confidence: float = 90.0):
    """(wav path, text, (start, end) or None) of each book's
    ``sentence_index.txt`` row of 8 tab-separated columns whose confidence
    (column 4) exceeds ``min_confidence``; a missing book is skipped."""
    del config
    for book in books:
        index_file = Path(data_dir) / book / "sentence_index.txt"
        if not index_file.exists():
            continue
        with open(index_file, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if line.startswith("#") or len(parts) != 8:
                    continue
                if float(parts[3]) <= min_confidence:
                    continue
                wav = Path(data_dir) / book / "wav" / f"{parts[0]}.wav"
                lab = Path(data_dir) / book / "lab" / f"{parts[0]}.lab"
                trim = _parse_blizzard_labels(lab) if lab.exists() else None
                yield str(wav), parts[5], trim


DATASET_FORMATS = {"ljspeech": _iter_ljspeech, "blizzard2013": _iter_ljspeech,
                   "blizzard": _iter_blizzard}


def build_tacotron_dataset(config: dict, *, out_dir=None,
                           column_sep: str = "|",
                           dataset_format: str = "ljspeech",
                           max_out_frames: int | None = None,
                           njobs: int = 16, device="cuda") -> str:
    """The store of ``config``'s corpus (``data_directory``) under
    ``out_dir`` (else ``{data_directory}/taco_training``), read by
    ``DATASET_FORMATS[dataset_format]``; returns ``out_dir``. Raises on
    ``device`` "cuda" without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "store on the CPU")
    data_dir = Path(config["data_directory"])
    out = Path(out_dir or data_dir / "taco_training")
    out.mkdir(parents=True, exist_ok=True)
    reader = DATASET_FORMATS[dataset_format]
    rows = list(reader(data_dir, config, column_sep)
                if dataset_format in ("ljspeech", "blizzard2013")
                else reader(data_dir, config))
    sr, hop = config["sampling_rate"], config["hop_length"]

    def load(item):
        _, (wav_path, _, trim) = item
        y, _ = load_wav(wav_path, sr)
        if trim is not None:
            start, end = trim
            y = y[int(start * sr): int(end * sr) if end else len(y)]
        return y

    def compute(item, y):
        if max_out_frames is not None and len(y) > max_out_frames * hop:
            return None
        linear, mel = taco_linear_and_mel(torch.from_numpy(y).to(device),
                                          config)
        return linear.cpu().numpy(), mel.cpu().numpy()

    def save(item, result):
        if result is None:
            return None
        idx, (_, text, _) = item
        linear, mel = result
        lin_f, mel_f = f"taco-linear-{idx:05d}.npy", f"taco-mel-{idx:05d}.npy"
        np.save(out / lin_f, linear.astype(np.float32), allow_pickle=False)
        np.save(out / mel_f, mel.astype(np.float32), allow_pickle=False)
        return f"{lin_f}|{mel_f}|{linear.shape[0]}|{text}\n"

    lines = _pipelined_feature_extract(list(enumerate(rows)), load, compute,
                                       save, njobs)
    with open(out / "train.txt", "w", encoding="utf-8") as f:
        f.writelines([ln for ln in lines if ln is not None])
    return str(out)
