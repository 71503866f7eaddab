"""The input pipelines (own copy of ``etts/data/dataset.py``'s
``load_files``, ``DataPrepper``, ``GTADataPrepper``, ``ForwardDataPrepper``,
``Dataset`` and ``Prefetcher``, and of the vocoder's ``VocoderDataset``,
``collate_vocoder`` and ``fast_forward_permutation``; the port imports
nothing of etts).

Batches are padded up to multiples (``pad_text_multiple`` 8,
``pad_mel_multiple`` 32) as etts pads them: the Keras-reduced loss divides
by all positions, padding included, so other padding gives another loss.
Shuffling uses Python's ``Random(seed)``, so the same samples and seed give
etts' batches in etts' order, across ``seek`` and ``change_batches``.
"""
from __future__ import annotations

import os
import queue
import threading
from random import Random
from typing import Callable, Optional

import numpy as np

__all__ = ["load_files", "DataPrepper", "GTADataPrepper",
           "ForwardDataPrepper", "Dataset", "Prefetcher", "pad_to_multiple",
           "VocoderDataset", "collate_vocoder", "fast_forward_permutation"]


def load_files(metafile, mel_dir, spk_embed_dir=None, num_samples=None):
    """Parse an ``id|text|phonemes`` metafile into (phonemes, text, mel
    path, speaker path or None) samples (`data_handling.py:59-83`).
    Returns (samples, alphabet). As etts, it keeps one sample past
    ``num_samples``."""
    samples, alphabet, count = [], set(), 0
    with open(metafile, "r", encoding="utf-8") as f:
        for line in f.readlines():
            parts = line.split("|")
            if len(parts) < 3:
                continue
            text = parts[1].strip().lower()
            mel_file = os.path.join(str(mel_dir), parts[0] + ".npy")
            spk_file = (os.path.join(str(spk_embed_dir), parts[0] + ".npy")
                        if spk_embed_dir is not None else None)
            samples.append((parts[2].strip(), text, mel_file, spk_file))
            alphabet.update(list(text))
            count += 1
            if num_samples is not None and count > num_samples:
                break
    return samples, sorted(alphabet)


class DataPrepper:
    """Sample -> (mel with the start and end vectors, token ids, stop
    classes (1, and 2 at the last frame), speaker embedding or [inf])
    (`data_handling.py:86-108`)."""

    may_drop = False  # never returns None: Dataset.seek can skip ahead

    def __init__(self, config: dict, tokenizer):
        self.start_vec = (np.ones((1, config["mel_channels"]))
                          * config["mel_start_value"])
        self.end_vec = (np.ones((1, config["mel_channels"]))
                        * config["mel_end_value"])
        self.tokenizer = tokenizer

    def __call__(self, sample):
        phonemes, text, mel_path, spk_path = sample
        mel = np.load(mel_path)
        spk = np.array([np.inf]) if spk_path is None else np.load(spk_path)
        return self._run(phonemes, text, mel, spk)

    def _run(self, phonemes, text, mel, spk_embed):
        tokens = np.asarray(self.tokenizer(phonemes), np.int32)
        norm_mel = np.concatenate([self.start_vec, mel, self.end_vec],
                                  axis=0).astype(np.float32)
        stop = np.ones(norm_mel.shape[0], np.int32)
        stop[-1] = 2
        return norm_mel, tokens, stop, np.asarray(spk_embed, np.float32)


class GTADataPrepper(DataPrepper):
    """``DataPrepper`` plus a frozen checkpoint's teacher-forced (GTA) mel
    from ``gta_dir`` (same id), repeat-padded or cut to the mel's length
    and given the same start and end vectors: the fifth tensor of a
    ``gta_inputs`` step."""

    def __init__(self, config: dict, tokenizer, gta_dir):
        super().__init__(config, tokenizer)
        self.gta_dir = str(gta_dir)

    def __call__(self, sample):
        phonemes, text, mel_path, spk_path = sample
        mel = np.load(mel_path)
        spk = np.array([np.inf]) if spk_path is None else np.load(spk_path)
        uid = os.path.splitext(os.path.basename(mel_path))[0]
        gta = np.load(os.path.join(self.gta_dir, uid + ".npy"))
        t = mel.shape[0]
        if gta.shape[0] < t:
            gta = np.concatenate(
                [gta, np.repeat(gta[-1:], t - gta.shape[0], 0)], axis=0)
        norm_mel, tokens, stop, spk = self._run(phonemes, text, mel, spk)
        norm_gta = np.concatenate([self.start_vec, gta[:t], self.end_vec],
                                  axis=0).astype(np.float32)
        return norm_mel, tokens, stop, spk, norm_gta


class ForwardDataPrepper:
    """An npy triple (mel (t, n_mels), token ids, durations), as
    ``extract_durations`` writes it, -> float32 mel, int32 ids, float32
    durations (`etts/data/dataset.py:125-143`). A mel longer than
    ``max_frames`` gives None, which the Dataset drops. The triples are
    pickled object arrays: only files this pipeline wrote are read."""

    def __init__(self, max_frames: Optional[int] = None):
        self.max_frames = max_frames

    @property
    def may_drop(self):
        return self.max_frames is not None

    def __call__(self, sample):
        mel, tokens, durations = np.load(str(sample), allow_pickle=True)
        if self.max_frames is not None and mel.shape[0] > self.max_frames:
            return None
        return (np.asarray(mel, np.float32), np.asarray(tokens, np.int32),
                np.asarray(durations, np.float32))


def pad_to_multiple(n: int, m: Optional[int]) -> int:
    return ((n + m - 1) // m) * m if m else n


def _pad_batch(arrays, pad_multiple=None):
    """Stack arrays, zero-padded on axis 0 to the longest rounded up."""
    max_len = pad_to_multiple(max(a.shape[0] for a in arrays), pad_multiple)
    out = np.zeros((len(arrays), max_len) + arrays[0].shape[1:],
                   arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


class Dataset:
    """Shuffling, padded-batching, endlessly repeating iterator over samples
    (`data_handling.py:10-56`): ``next_batch``, ``change_batches``,
    ``seek``; optional length bucketing. ``shard_index`` of
    ``num_shards``: a host's own part of the samples, every
    ``num_shards``-th from ``shard_index`` (`etts/data/dataset.py:175-178`;
    the training drivers instead run the whole stream on every rank and
    keep their rows of each global batch, ``parallel.local_shard``)."""

    def __init__(self, samples, preprocessor: Callable, batch_size: int,
                 shuffle=True, drop_remainder=True, mel_channels=80, seed=42,
                 pad_text_multiple: Optional[int] = 8,
                 pad_mel_multiple: Optional[int] = 32,
                 shard_index: int = 0, num_shards: int = 1,
                 bucket_by_length: bool = False, bucket_groups: int = 32):
        self._random = Random(seed)
        self._samples = list(samples)[shard_index::num_shards]
        self.preprocessor = preprocessor
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.mel_channels = mel_channels
        self.pad_text_multiple = pad_text_multiple
        self.pad_mel_multiple = pad_mel_multiple
        # sort groups of batch_size * bucket_groups items by mel length,
        # batch within a group, shuffle the batches' order
        self.bucket_by_length = bucket_by_length
        self.bucket_groups = bucket_groups
        self.data_iter = self._infinite_iter()

    def __len__(self):
        """The samples of this shard."""
        return len(self._samples)

    def _collate(self, items):
        """(mel, tokens, stop, spk[, gta mel]) items, or the forward
        model's (mel, tokens, durations), -> padded arrays; durations pad
        as the tokens do."""
        cols = list(zip(*items))
        if len(cols) == 3:
            return (_pad_batch(cols[0], self.pad_mel_multiple),
                    _pad_batch(cols[1], self.pad_text_multiple),
                    _pad_batch(cols[2], self.pad_text_multiple))
        batch = (_pad_batch(cols[0], self.pad_mel_multiple),
                 _pad_batch(cols[1], self.pad_text_multiple),
                 _pad_batch(cols[2], self.pad_mel_multiple),
                 np.stack([np.atleast_1d(s) for s in cols[3]]))
        if len(cols) == 5:
            batch += (_pad_batch(cols[4], self.pad_mel_multiple),)
        return batch

    def _one_epoch(self, skip_batches: int = 0):
        samples = self._samples[:]
        if self.shuffle:
            self._random.shuffle(samples)
        if self.bucket_by_length:
            it = self._bucketed_epoch(samples)
            for _ in range(skip_batches):   # a data-dependent sort: replay
                next(it, None)
            yield from it
            return
        # batch k is samples[k * bs:(k + 1) * bs]: skipping loads nothing
        samples = samples[skip_batches * self.batch_size:]
        buf = []
        for s in samples:
            item = self.preprocessor(s)
            if item is None:
                continue
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._collate(buf)

    def _bucketed_epoch(self, samples):
        group_n = self.batch_size * self.bucket_groups
        for g in range(0, len(samples), group_n):
            items = [it for it in (self.preprocessor(s)
                                   for s in samples[g:g + group_n])
                     if it is not None]
            items.sort(key=lambda it: it[0].shape[0])
            batches = [items[i:i + self.batch_size]
                       for i in range(0, len(items), self.batch_size)]
            if self.drop_remainder and batches and \
                    len(batches[-1]) < self.batch_size:
                batches = batches[:-1]
            self._random.shuffle(batches)
            for b in batches:
                yield self._collate(b)

    def _infinite_iter(self, skip_batches: int = 0):
        while True:
            yield from self._one_epoch(skip_batches)
            skip_batches = 0

    def batches_per_epoch(self) -> Optional[int]:
        """The batches of one epoch, or None where they depend on the data
        (a preprocessor that may drop samples)."""
        if getattr(self.preprocessor, "may_drop", True):
            return None
        n, bs = len(self._samples), self.batch_size
        if not self.bucket_by_length:
            return n // bs if self.drop_remainder else -(-n // bs)
        group_n = bs * self.bucket_groups
        total = 0
        for g in range(0, n, group_n):
            gl = min(group_n, n - g)
            total += gl // bs if self.drop_remainder else -(-gl // bs)
        return total

    def seek(self, n_batches: int):
        """Skip the stream ``n_batches`` ahead, so that a resumed run
        continues where the stopped one left off: whole epochs advance the
        shuffle's Random with same-length shuffles (no loads), the rest is
        skipped inside the epoch."""
        if n_batches <= 0:
            return
        epoch = self.batches_per_epoch()
        if epoch == 0:
            raise ValueError(
                f"Dataset.seek: the dataset yields no batch per epoch "
                f"({len(self._samples)} samples < batch_size "
                f"{self.batch_size} with drop_remainder), so there is no "
                "stream to resume")
        if epoch is None:
            for _ in range(n_batches):
                self.next_batch()
            return
        n_epochs, offset = divmod(n_batches, epoch)
        dummy = list(range(len(self._samples)))
        for _ in range(n_epochs):
            if self.shuffle:
                self._random.shuffle(dummy)   # a real epoch's draws
            if self.bucket_by_length:
                group_n = self.batch_size * self.bucket_groups
                for g in range(0, len(self._samples), group_n):
                    gl = min(group_n, len(self._samples) - g)
                    nb = (gl // self.batch_size if self.drop_remainder
                          else -(-gl // self.batch_size))
                    self._random.shuffle(list(range(nb)))
        self.data_iter = self._infinite_iter(skip_batches=offset)

    def next_batch(self):
        return next(self.data_iter)

    def all_batches(self):
        """One pass over the samples, the stream left where it was."""
        return self._one_epoch()

    def change_batches(self, batch_size: int):
        """Switch the batch size (the MINE batch-size schedule); the stream
        restarts its epoch."""
        self.batch_size = batch_size
        self.data_iter = self._infinite_iter()


def fast_forward_permutation(rng, n_items: int, batch_size: int,
                             n_steps: int) -> int:
    """Resume a stream that draws ``rng.permutation(n_items)`` once an
    epoch and batches it in order, dropping the remainder: advance ``rng``
    past the whole epochs that ``n_steps`` batches took, and return the
    batches of the current epoch to skip (`etts/data/dataset.py:27-40`)."""
    epoch_b = n_items // batch_size
    if not n_steps or not epoch_b:
        return 0
    n_epochs, skip = divmod(n_steps, epoch_b)
    for _ in range(n_epochs):
        rng.permutation(n_items)
    return skip


class VocoderDataset:
    """The pairs ``{path}/mel/{id}.npy`` (or ``gta/`` with ``train_gta``),
    (n_mels, t), and ``{path}/quant/{id}.npy``, the sample labels
    (`WaveRNN/utility/dataset.py:16-30`)."""

    def __init__(self, ids, path, train_gta: bool = False):
        self.metadata = list(ids)
        self.mel_path = os.path.join(str(path), "gta" if train_gta else "mel")
        self.quant_path = os.path.join(str(path), "quant")

    def __getitem__(self, index):
        item_id = self.metadata[index]
        return (np.load(os.path.join(self.mel_path, f"{item_id}.npy")),
                np.load(os.path.join(self.quant_path, f"{item_id}.npy")))

    def __len__(self):
        return len(self.metadata)


def _label_to_float(x, bits):
    return 2.0 * x / (2 ** bits - 1.0) - 1.0


def collate_vocoder(batch, seq_len: int, hop_length: int, pad: int,
                    mode: str = "MOL", bits: int = 9,
                    rng: Optional[np.random.Generator] = None):
    """Random crops of (mel, labels) pairs (`WaveRNN/utility/dataset.py:
    65-91`): a window of ``seq_len // hop_length + 2 * pad`` mel frames at
    an offset drawn from ``rng`` per item, and the ``seq_len + 1`` labels
    it conditions. Returns float32 x (b, seq_len), the inputs as floats in
    [-1, 1]; y (b, seq_len), the next samples (floats for MOL, int64
    labels for RAW); mels (b, mel window, n_mels)."""
    rng = rng or np.random.default_rng()
    mel_win = seq_len // hop_length + 2 * pad
    max_offsets = [x[0].shape[-1] - 2 - (mel_win + 2 * pad) for x in batch]
    mel_offsets = [int(rng.integers(0, o)) for o in max_offsets]
    sig_offsets = [(o + pad) * hop_length for o in mel_offsets]
    mels = np.stack([x[0][:, mel_offsets[i]:mel_offsets[i] + mel_win]
                     for i, x in enumerate(batch)]).astype(np.float32)
    labels = np.stack([x[1][sig_offsets[i]:sig_offsets[i] + seq_len + 1]
                       for i, x in enumerate(batch)]).astype(np.int64)
    x, y = labels[:, :seq_len], labels[:, 1:]
    x_bits = 16 if mode == "MOL" else bits
    x = _label_to_float(x.astype(np.float32), x_bits)
    if mode == "MOL":
        y = _label_to_float(y.astype(np.float32), x_bits)
    return x, y, mels.transpose(0, 2, 1)


class Prefetcher:
    """Load and collate the next batches of ``dataset`` in a background
    thread while the device computes. A loading error is raised by the
    ``next_batch`` that would have returned that batch. ``stop`` ends the
    thread."""

    def __init__(self, dataset, depth: int = 2):
        self.dataset = dataset
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.dataset.next_batch()
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                self._put(e)
                return
            self._put(batch)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def next_batch(self):
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
