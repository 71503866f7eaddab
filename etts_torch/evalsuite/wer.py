"""Word error rate with the reference's number normalization (port of
``etts/evalsuite/wer.py``: a plain Levenshtein, digits verbalized by the
port's own ``text/numbers_en.py``), and ``transcribe``, the ASR of the
WER-syn / WER-ori columns.

One change from etts: ``transcribe`` returns None only where no backend is
available. A backend that is there but fails (a registered CTC checkpoint
that does not load or run, a cached wav2vec2 that does not load or fails
on the input) raises, where etts swallows every exception into an empty WER column.
"""
from __future__ import annotations

import re

import numpy as np

from ..text.numbers_en import number_to_words

__all__ = ["wer", "normalize_for_wer", "transcribe", "backend"]

_num_re = re.compile(r"[0-9]+")
_punct_re = re.compile(r"[^\w\s']")


def normalize_for_wer(text: str) -> list[str]:
    """lowercase, verbalize digits, strip punctuation, split words."""
    text = text.lower()
    text = _num_re.sub(lambda m: number_to_words(int(m.group(0)), andword=""),
                       text)
    text = _punct_re.sub(" ", text)
    return text.split()


def _edit_distance(ref: list, hyp: list) -> int:
    n, m = len(ref), len(hyp)
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[m])


def wer(reference: str, hypothesis: str) -> float:
    ref = normalize_for_wer(reference)
    hyp = normalize_for_wer(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


_W2V2: dict = {}
W2V2_NAME = "facebook/wav2vec2-base-960h"


def _wav2vec2():
    """(processor, model) of a locally cached HuggingFace wav2vec2 CTC
    model, or None where ``huggingface_hub`` or ``transformers`` is missing
    or its config is not in the cache (nothing is downloaded). Once its
    config is cached, a model that fails to load raises. The cache is read
    before ``transformers``, whose import takes seconds, is imported."""
    if "found" not in _W2V2:
        try:
            from huggingface_hub import try_to_load_from_cache
            cached = isinstance(
                try_to_load_from_cache(W2V2_NAME, "config.json"), str)
            if cached:
                from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor
        except ImportError:
            cached = False
        if not cached:
            _W2V2["found"] = None
            return None
        _W2V2["found"] = (
            Wav2Vec2Processor.from_pretrained(W2V2_NAME,
                                              local_files_only=True),
            Wav2Vec2ForCTC.from_pretrained(W2V2_NAME,
                                           local_files_only=True).eval())
    return _W2V2["found"]


def _transcribe_wav2vec2(wav, sr_hz, found, device):
    import torch
    proc, model = found
    if sr_hz != 16000:
        from scipy.signal import resample_poly
        wav = resample_poly(np.asarray(wav, np.float64), 16000, sr_hz)
    inputs = proc(np.asarray(wav, np.float32), sampling_rate=16000,
                  return_tensors="pt")
    with torch.no_grad():
        logits = model.to(device)(inputs.input_values.to(device)).logits
    return proc.decode(logits.argmax(-1)[0].cpu())


def _backend():
    """(name, handle) of the backend ``transcribe`` uses, in etts' order;
    (None, None) where none is available."""
    try:
        import speech_recognition as sr
    except ImportError:
        sr = None
    if sr is not None:
        return "SpeechRecognition", sr
    found = _wav2vec2()
    if found is not None:
        return "wav2vec2", found
    from .ctc_asr import default_transcriber
    tr = default_transcriber()
    return ("char-CTC", tr) if tr is not None else (None, None)


def backend():
    """The name of the backend ``transcribe`` uses ("SpeechRecognition",
    "wav2vec2" or "char-CTC"), None where none is available."""
    return _backend()[0]


def transcribe(wav_path: str):
    """ASR for the WER-syn / WER-ori regime (objective_measure.py:101-137).

    Backends, in etts' order: (1) Google's recognizer through the optional
    SpeechRecognition package (it needs the network); (2) offline
    wav2vec2-CTC where its config is in the local HuggingFace cache; (3)
    the char-CTC transcriber of ``ctc_asr`` where a checkpoint is
    registered (``ETTS_CTC_ASR=<ckpt.npz>`` or
    ``ctc_asr.set_default_model``; train one with ``python -m
    etts_torch.train_ctc_asr``). (2) and (3) run on the device
    ``set_default_model`` names (the card by default). Returns None when
    none is available."""
    name, handle = _backend()
    if name is None:
        return None
    if name == "SpeechRecognition":
        r = handle.Recognizer()
        with handle.AudioFile(wav_path) as source:
            audio = r.record(source)
        return r.recognize_google(audio)
    from ..data.audio_io import load_wav
    wav, sr_hz = load_wav(wav_path)
    if name == "wav2vec2":
        from .ctc_asr import default_device
        return _transcribe_wav2vec2(wav, sr_hz, handle, default_device())
    return handle.transcribe_wav(wav, sr_hz)
