"""Tiny trainable character-CTC transcriber (port of
``etts/evalsuite/ctc_asr.py``): the offline ASR backend (3) of
``wer.transcribe``, so the WER columns of ``objective_measure`` can be
filled with no network and no pretrained weights.

Smoke-level: trained on a small (possibly synthetic) corpus it checks the
WER pipeline end to end and tracks gross intelligibility regressions; its
WER is not comparable to a pretrained recognizer's.

Model: a log-mel frontend, 2 stride-2 Conv1d with LayerNorm and relu, 2
bidirectional GRU layers (``ops/gru.py::gru_scan``, ``reverse=True`` for
the backward half), a Dense to the 29 symbols of ``CTC_VOCAB`` (0 the
blank); per-sequence CTC loss, greedy collapse decode. Checkpoints stay
etts' flat npz (``__sr__``, ``__n_mels__``, ``__hidden__`` and
``/``-joined flax names in flax's layouts), so a checkpoint saved by
either package loads in the other. Registered through ``ETTS_CTC_ASR=<ckpt
.npz>`` or ``set_default_model(path)``.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..ops.stft import mel_filterbank, n_frames, stft

__all__ = ["CTC_VOCAB", "CTCAsrModel", "CTCTranscriber", "train_ctc_asr",
           "encode_text", "greedy_decode", "save_ckpt", "set_default_model",
           "default_transcriber"]

# index 0 is the CTC blank
CTC_VOCAB = "_ abcdefghijklmnopqrstuvwxyz'"
_CHAR_TO_ID = {c: i for i, c in enumerate(CTC_VOCAB)}
N_FFT = 512
_GRU_PARTS = ("wi", "wh", "bi", "bh")


def encode_text(text: str) -> np.ndarray:
    """Normalized text -> label ids (unknown chars dropped)."""
    text = " ".join(text.lower().split())
    return np.asarray([_CHAR_TO_ID[c] for c in text if c in _CHAR_TO_ID
                       and c != "_"], np.int32)


def _same_pad(x, k: int, stride: int):
    """flax's ``padding="SAME"`` on the time axis of x (b, c, t): the odd
    extra pad on the high side."""
    t = x.shape[-1]
    total = max((math.ceil(t / stride) - 1) * stride + k - t, 0)
    return F.pad(x, (total // 2, total - total // 2))


class CTCAsrModel(nn.Module):
    """mels (b, t, n_mels) -> logits (b, ceil(t / 4), len(CTC_VOCAB)). The
    parameter names are flax's (``conv_{i}``, ``ln_{i}``,
    ``gru{i}_{f,b}_{wi,wh,bi,bh}``, ``out``); the GRU kernels keep flax's
    layout (in, 3h), the convs and the Dense torch's."""

    def __init__(self, n_mels: int = 40, hidden: int = 96,
                 conv_filters: int = 96):
        super().__init__()
        self.n_mels, self.hidden = n_mels, hidden
        for i in range(2):
            setattr(self, f"conv_{i}", nn.Conv1d(
                n_mels if i == 0 else conv_filters, conv_filters, 5, 2))
            setattr(self, f"ln_{i}", nn.LayerNorm(conv_filters, eps=1e-6))
        width = conv_filters
        for i in range(2):
            for d in "fb":
                for part, shape in zip(_GRU_PARTS, ((width, 3 * hidden),
                                                    (hidden, 3 * hidden),
                                                    (3 * hidden,),
                                                    (3 * hidden,))):
                    self.register_parameter(f"gru{i}_{d}_{part}",
                                            nn.Parameter(torch.zeros(shape)))
            width = 2 * hidden
        self.out = nn.Linear(width, len(CTC_VOCAB))

    def _gru(self, i: int, d: str):
        return [getattr(self, f"gru{i}_{d}_{p}") for p in _GRU_PARTS]

    def forward(self, mels):
        x = mels.transpose(1, 2)
        for i in range(2):
            x = getattr(self, f"conv_{i}")(_same_pad(x, 5, 2))
            x = F.relu(getattr(self, f"ln_{i}")(x.transpose(1, 2)))
            x = x.transpose(1, 2)
        x = x.transpose(1, 2)
        for i in range(2):
            yf, _ = gru_scan(*self._gru(i, "f"), x)
            yb, _ = gru_scan(*self._gru(i, "b"), x, reverse=True)
            x = torch.cat([yf, yb], -1)
        return self.out(x)

    def reset_parameters(self, generator: torch.Generator):
        """flax's init of etts' model: conv and Dense kernels
        ``lecun_normal``, GRU input kernels ``lecun_normal``, recurrent
        kernels orthogonal, biases zero, LayerNorm scales one."""
        from ..models.init import _gru, init_flax
        with torch.no_grad():
            init_flax(self, generator)
            for i in range(2):
                for d in "fb":
                    _gru(*self._gru(i, d), generator)
        return self

    # -- etts' flat npz layout ----------------------------------------------

    def flat(self) -> dict:
        """{flax name: numpy array in flax's layout}."""
        out = {}
        for name, p in self.named_parameters():
            a = p.detach().float().cpu().numpy()
            mod, _, leaf = name.rpartition(".")
            if not mod:
                out[name] = a
            elif mod.startswith("ln"):
                out[f"{mod}/{'scale' if leaf == 'weight' else 'bias'}"] = a
            else:
                out[f"{mod}/{'kernel' if leaf == 'weight' else 'bias'}"] = (
                    a.transpose(2, 1, 0) if a.ndim == 3 else
                    a.T if a.ndim == 2 else a)
        return out

    def load_flat(self, flat: dict):
        """Load etts' flat parameters (``flat()``'s layout); every
        parameter must be given, and no other."""
        own = self.flat()
        if set(flat) != set(own):
            raise KeyError(f"checkpoint keys differ: missing "
                           f"{sorted(set(own) - set(flat))}, unexpected "
                           f"{sorted(set(flat) - set(own))}")
        state = {}
        for key, a in flat.items():
            a = np.asarray(a, np.float32)
            if a.shape != own[key].shape:
                raise ValueError(f"{key}: shape {a.shape}, the model has "
                                 f"{own[key].shape}")
            mod, _, leaf = key.rpartition("/")
            if not mod:
                state[key] = a
            else:
                tleaf = "bias" if leaf == "bias" else "weight"
                state[f"{mod}.{tleaf}"] = (a.transpose(2, 1, 0) if a.ndim == 3
                                           else a.T if a.ndim == 2 else a)
        self.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in state.items()})
        return self


def _log_mel(wav, sr: int, n_mels: int = 40, stat_frames=None):
    """wav (n,) tensor -> normalized log-mel (t, n_mels) on its device (25
    ms windows, 10 ms hops at any rate). ``stat_frames`` keeps the
    normalization statistics to the leading real frames, so the bucket's
    trailing silence does not skew them."""
    hop = max(1, int(sr * 0.010))
    win = min(N_FFT, int(sr * 0.025))
    mag = stft(wav.float(), N_FFT, hop, win).abs()
    fb = torch.from_numpy(mel_filterbank(sr, N_FFT, n_mels, 0.0,
                                         sr / 2)).to(wav.device)
    mel = torch.log(torch.clamp(fb @ mag, min=1e-5)).T
    stat = mel if stat_frames is None else mel[:stat_frames]
    return (mel - stat.mean()) / (stat.std(correction=0) + 1e-5)


def _bucketed_mel(wav, sr: int, n_mels: int, device):
    """One utterance's log-mel of its real frames: the wav zero-padded to a
    power of two of at least 4096 samples (as etts buckets it), the
    statistics and the frames those of the unpadded wav. Returns (mel
    (bucket frames, n_mels), real frames)."""
    wav = np.asarray(wav, np.float32)
    n_real = len(wav)
    bucket = 1 << max(12, int(n_real - 1).bit_length())
    real = n_frames(n_real, N_FFT, max(1, int(sr * 0.010)))
    w = torch.from_numpy(np.pad(wav, (0, bucket - n_real))).to(device)
    return _log_mel(w, sr, n_mels, stat_frames=real), real


def greedy_decode(logits) -> str:
    """(t, vocab) -> text via CTC collapse (repeats merged, blanks dropped)."""
    ids = np.asarray(logits).argmax(-1)
    out, prev = [], -1
    for i in ids:
        if i != prev and i != 0:
            out.append(CTC_VOCAB[i])
        prev = i
    return "".join(out).strip()


def prepare_batch(pairs: Sequence[tuple], sr: int, n_mels: int, device):
    """[(wav, text), ...] -> (mels (b, T, n_mels), the logits' real frames
    (b,), labels (b, L) zero-padded, label lengths (b,)) on ``device``, the
    pairs whose 4x-downsampled frames cannot hold their transcript (plus a
    blank between repeats) dropped with a message (`ctc_asr.py:150-166`)."""
    mels = [_bucketed_mel(w, sr, n_mels, device) for w, _ in pairs]
    mels = [m[:real] for m, real in mels]
    labels = [encode_text(t) for _, t in pairs]
    if not all(len(l) > 0 for l in labels):
        raise ValueError("empty transcript")
    keep = []
    for i, (m, l) in enumerate(zip(mels, labels)):
        need = len(l) + int(np.sum(l[1:] == l[:-1]))
        if m.shape[0] // 4 >= need:
            keep.append(i)
        else:
            print(f"! ctc_asr: dropping utterance {i}: "
                  f"{m.shape[0] // 4} output frames < {need} needed for "
                  f"{len(l)}-char transcript (audio too short)")
    if not keep:
        raise ValueError("no CTC-feasible (audio, text) pairs: every "
                         "transcript is longer than its audio's frame count")
    mels = [mels[i] for i in keep]
    labels = [labels[i] for i in keep]
    x = torch.nn.utils.rnn.pad_sequence(mels, batch_first=True)
    out_lens = output_lengths([m.shape[0] for m in mels], x.shape[1])
    y = torch.zeros(len(labels), max(len(l) for l in labels),
                    dtype=torch.long)
    for i, l in enumerate(labels):
        y[i, :len(l)] = torch.from_numpy(l.astype(np.int64))
    lengths = torch.tensor([len(l) for l in labels])
    return x, out_lens.to(device), y.to(device), lengths.to(device)


def output_lengths(frames, t_in: int) -> torch.Tensor:
    """The logits' real frames: ceil(frames / (t_in / t_out)) in float32,
    t_out = ceil(t_in / 4) the two stride-2 convs' output, as etts' logit
    paddings count them (`ctc_asr.py:176-182`)."""
    t_out = -(-t_in // 4)
    ratio = np.float32(t_in / t_out)
    return torch.from_numpy(np.ceil(np.asarray(frames, np.float32)
                                    / ratio).astype(np.int64))


def ctc_loss(model, x, out_lens, y, lengths):
    """The mean over the batch of the per-sequence CTC negative
    log-likelihood, as ``optax.ctc_loss`` gives it (``F.ctc_loss``'s
    "mean" reduction would divide each by its label length)."""
    lp = F.log_softmax(model(x), -1).transpose(0, 1)
    return F.ctc_loss(lp, y, out_lens, lengths, blank=0,
                      reduction="none").mean()


def train_ctc_asr(pairs: Sequence[tuple], sr: int, *, steps: int = 600,
                  lr: float = 3e-3, n_mels: int = 40, hidden: int = 96,
                  seed: int = 0, log_every: int = 0, device="cuda"):
    """Train full-batch on [(wav, text), ...] with Adam (optax's defaults);
    returns (model, final loss). The model is initialised as flax
    initialises etts' (``reset_parameters``) from ``seed``; the draws
    differ from etts'."""
    device = torch.device(device)
    batch = prepare_batch(pairs, sr, n_mels, device)
    model = CTCAsrModel(n_mels=n_mels, hidden=hidden).reset_parameters(
        torch.Generator().manual_seed(seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = torch.tensor(float("inf"))
    for i in range(steps):
        loss = ctc_loss(model, *batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log_every and (i + 1) % log_every == 0:
            print(f"ctc step {i + 1}: loss {float(loss):.4f}", flush=True)
    return model, float(loss)


class CTCTranscriber:
    """Load-once transcriber over a flat npz checkpoint, on ``device``."""

    def __init__(self, ckpt_path: str, device="cuda"):
        data = np.load(ckpt_path, allow_pickle=False)
        self.sr = int(data["__sr__"])
        self.n_mels = int(data["__n_mels__"])
        self.device = torch.device(device)
        self.model = CTCAsrModel(n_mels=self.n_mels,
                                 hidden=int(data["__hidden__"]))
        self.model.load_flat({k: data[k] for k in data.files
                              if not k.startswith("__")})
        self.model.to(self.device).eval()

    @torch.no_grad()
    def transcribe_wav(self, wav, sr_hz) -> str:
        """Greedy transcript of the real frames only: the trainer masks the
        bucket's tail out of the loss, so its logits are untrained."""
        if sr_hz != self.sr:
            from scipy.signal import resample_poly
            wav = resample_poly(np.asarray(wav, np.float64), self.sr, sr_hz)
        mel, real = _bucketed_mel(wav, self.sr, self.n_mels, self.device)
        logits = self.model(mel[None])[0]
        out = int(np.ceil(real / (mel.shape[0] / logits.shape[0])))
        return greedy_decode(logits[:out].cpu().numpy())


def save_ckpt(path: str, model: CTCAsrModel, sr: int):
    """etts' flat npz of ``model``."""
    np.savez(path, __sr__=sr, __n_mels__=model.n_mels,
             __hidden__=model.hidden, **model.flat())


_DEFAULT: dict = {}


def set_default_model(path: Optional[str], device="cuda"):
    """Register (or clear) the checkpoint ``wer.transcribe`` uses, and the
    device it (or a cached wav2vec2) runs on."""
    _DEFAULT.clear()
    _DEFAULT["device"] = device
    if path:
        _DEFAULT["path"] = path


def default_device() -> str:
    """The device ``set_default_model`` named, the card by default."""
    return _DEFAULT.get("device", "cuda")


def default_transcriber() -> Optional[CTCTranscriber]:
    """The registered transcriber (``set_default_model``, else
    ``ETTS_CTC_ASR`` on the card), None where none is registered. A
    registered checkpoint that cannot be read raises."""
    path = _DEFAULT.get("path") or os.environ.get("ETTS_CTC_ASR")
    if not path:
        return None
    device = default_device()
    if _DEFAULT.get("loaded_from") != (path, device):
        _DEFAULT["tr"] = CTCTranscriber(path, device)
        _DEFAULT["loaded_from"] = (path, device)
    return _DEFAULT["tr"]
