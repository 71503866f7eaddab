"""The training stores built from a corpus (port of
``etts/data/builders.py``).

``build_tts_dataset`` writes what the TTS drivers read
(``train_autoregressive``, ``extract_durations``): the corpus'
``metadata.csv`` rows (``id|...|text``) cleaned and phonemized into
``phonemes.npy`` (an (n, 3) string array, kept as a cache), shuffled by
``np.random.seed(42)``, the first ``n_test`` rows into
``test_metafile.txt`` and the rest but the last into
``train_metafile.txt`` (``id|text|phonemes``), and ``mels/{id}.npy``, the
normalised mel of ``ops.audio.AudioProcessor``, (t, n_mels).

``build_vocoder_dataset`` writes what ``train_wavernn --data`` reads:
``mel/{id}.npy``, the WaveRNN-normalised mel of ``ops.audio.AudioProcessor``
in the vocoder's convention, (n_mels, t) in [0, 1] (``(mel + 4) / 8``);
``quant/{id}.npy``, int64 sample labels (16-bit for MOL; mu-law or
``bits``-bit for RAW); and ``dataset.pkl``, the list of ``(id, mel
frames)``.

Wavs are read and files written on a thread pool; the mels are computed
on ``device``, one wav at a time, on the main thread; the labels on the
CPU.
"""
from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops.audio import AudioProcessor
from ..ops.normalizers import float_to_label, mu_law_encode
from ..text import Pipeline
from .audio_io import load_wav

__all__ = ["build_tts_dataset", "build_vocoder_dataset"]

_PHONEME_BATCH = 250    # sentences a thread's batch (etts' joblib batches)
SPLIT_SEED = 42         # np.random.seed(42); np.random.shuffle(rows)


def _read_metadata(meta_file, column_sep: str = "|") -> list:
    """[(id, text)] of ``meta_file``'s lines: the first column (a
    ``.wav`` suffix cut at its first dot) and the last, stripped."""
    rows = []
    with open(meta_file, "r", encoding="utf-8") as f:
        for line in f.readlines():
            parts = line.split(column_sep)
            filename, text = parts[0], parts[-1].strip()
            if filename.endswith(".wav"):
                filename = filename.split(".")[0]
            rows.append((filename, text))
    return rows


def _parallel_phonemize(phonemizer, texts, njobs: int) -> list:
    """``phonemizer`` of each text, in order, on ``njobs`` threads in
    batches of 250 sentences (the espeak backend runs a process a chunk,
    so threads overlap their wall time)."""
    if njobs <= 1 or len(texts) <= 1:
        return [phonemizer(t) for t in texts]
    batches = [texts[i:i + _PHONEME_BATCH]
               for i in range(0, len(texts), _PHONEME_BATCH)]
    with ThreadPoolExecutor(max_workers=njobs) as pool:
        out = []
        for res in pool.map(lambda b: [phonemizer(t) for t in b], batches):
            out.extend(res)
    return out


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


def build_tts_dataset(config: dict, *, cache_phonemes: bool = True,
                      recompute_phonemes: bool = False,
                      column_sep: str = "|", njobs: int = 16,
                      phonemizer_backend: str | None = None,
                      device="cuda") -> str:
    """The TTS store of ``config``'s corpus (``data_directory`` holding
    ``metadata_filename`` and ``wav_subdir_name``) under
    ``train_data_directory`` (else ``data_directory``); returns that
    directory. Phonemes come from ``phonemes.npy`` there unless it is
    missing or ``recompute_phonemes``; else through the backend named by
    ``phonemizer_backend`` or the config's ``phonemizer_backend`` (with
    neither, this raises), cached unless not ``cache_phonemes``. As etts
    does, the split keeps the shuffled rows ``[n_test:-1]`` for training
    where there are more than ``n_test + 1``: the last row is in neither
    metafile, but its mel is written. The mels are computed on
    ``device``; this raises on "cuda" without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "store on the CPU")
    data_dir = Path(config["data_directory"])
    target_dir = Path(config.get("train_data_directory") or data_dir)
    wav_dir = data_dir / config.get("wav_subdir_name", "wavs")
    meta_file = data_dir / config.get("metadata_filename", "metadata.csv")
    mel_dir = target_dir / "mels"
    mel_dir.mkdir(parents=True, exist_ok=True)
    backend = phonemizer_backend or config.get("phonemizer_backend")
    if backend is None:
        raise ValueError("no phonemizer backend: pass one or set "
                         "phonemizer_backend in data_config.yaml")

    phon_path = target_dir / "phonemes.npy"
    if phon_path.exists() and not recompute_phonemes:
        audio_data = np.load(phon_path)
    else:
        pipeline = Pipeline.default_pipeline(
            config["phoneme_language"], add_start_end=True,
            with_stress=False, backend=backend, strip=True)
        rows = _read_metadata(meta_file, column_sep)
        cleaned = [(fn, pipeline.cleaner(tx)) for fn, tx in rows]
        phonemes = _parallel_phonemize(pipeline.phonemizer,
                                       [tx for _, tx in cleaned], njobs)
        audio_data = np.array([(fn, tx, ph) for (fn, tx), ph in
                               zip(cleaned, phonemes)])
        if cache_phonemes:
            np.save(phon_path, audio_data, allow_pickle=True)

    np.random.RandomState(SPLIT_SEED).shuffle(audio_data)
    n_test = int(config.get("n_test", 100))
    lines = ["|".join([fn, tx, ph]) + "\n" for fn, tx, ph in audio_data]
    with open(target_dir / "test_metafile.txt", "w+", encoding="utf-8") as f:
        f.writelines(lines[:n_test])
    with open(target_dir / "train_metafile.txt", "w+",
              encoding="utf-8") as f:
        f.writelines(lines[n_test:-1] if len(lines) > n_test + 1
                     else lines[n_test:])

    audio = AudioProcessor(config)

    def load(row):
        return load_wav(str(wav_dir / (row[0] + ".wav")),
                        config["sampling_rate"])[0]

    def compute(row, y):
        return audio.mel_spectrogram(
            torch.from_numpy(y).to(device)).cpu().numpy()

    def save(row, mel):
        np.save(mel_dir / row[0], mel.T)

    _pipelined_feature_extract(list(audio_data), load, compute, save, njobs)
    return str(target_dir)


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
                          extension=".wav", njobs=16, device="cuda") -> str:
    """The store of every ``*{extension}`` in ``wav_dir`` (sorted) under
    ``out_dir``, read at the config's ``sampling_rate``; returns
    ``out_dir``. The mels are computed on ``device``; this raises on
    "cuda" without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "store on the CPU")
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
