"""Tokenizer + phonemizer backends.

Tokenizer semantics mirror `TransformerTTS/preprocessing/text/tokenizer.py:4-27`:
char-level over a sorted alphabet, ids start at 1 (0 = pad '/'), optional
start '>' / end '<' tokens appended to the vocab, OOV chars dropped.

Copy of ``etts/text/tokenizer.py``. Backends:
  - ``EspeakBackend``: shells out to espeak-ng/espeak when installed
  - ``GraphemeBackend``: deterministic ASCII->IPA letter mapping fallback so the
    full pipeline runs (and is testable) on machines without espeak
The reference used the ``phonemizer`` package with the espeak backend
(`tokenizer.py:30-50`); phoneme caching in the dataset builder makes the exact
backend a preprocessing concern, not a model one.
"""
from __future__ import annotations

import re
import shutil
import subprocess

__all__ = ["Tokenizer", "Phonemizer", "EspeakBackend", "GraphemeBackend"]


class Tokenizer:
    def __init__(self, alphabet, start_token='>', end_token='<', pad_token='/',
                 add_start_end=True):
        self.alphabet = alphabet
        self.idx_to_token = {i: s for i, s in enumerate(self.alphabet, start=1)}
        self.idx_to_token[0] = pad_token
        self.token_to_idx = {s: i for i, s in self.idx_to_token.items()}
        self.vocab_size = len(self.alphabet) + 1
        self.add_start_end = add_start_end
        if add_start_end:
            self.start_token_index = len(self.alphabet) + 1
            self.end_token_index = len(self.alphabet) + 2
            self.vocab_size += 2
            self.idx_to_token[self.start_token_index] = start_token
            self.idx_to_token[self.end_token_index] = end_token

    def __call__(self, sentence):
        seq = [self.token_to_idx[c] for c in sentence if c in self.token_to_idx]
        if self.add_start_end:
            seq = [self.start_token_index] + seq + [self.end_token_index]
        return seq

    def decode(self, sequence):
        return ''.join(self.idx_to_token[int(t)] for t in sequence
                       if int(t) in self.idx_to_token)


_STRESS_MARKS = 'ˈˌ'
_PUNCT_SPLIT_RE = re.compile(r'([!,\-.:;?]+)')


class EspeakBackend:
    """IPA phonemization via the espeak(-ng) CLI, punctuation-preserving."""

    def __init__(self, language='en', with_stress=False):
        self.language = {'en': 'en-us', 'de': 'de'}.get(language, language)
        self.with_stress = with_stress
        self.binary = shutil.which('espeak-ng') or shutil.which('espeak')
        if self.binary is None:
            raise RuntimeError('espeak/espeak-ng binary not found')

    def _phonemize_chunk(self, chunk: str) -> str:
        out = subprocess.run(
            [self.binary, '-q', '--ipa', '-v', self.language, chunk],
            capture_output=True, text=True, check=True).stdout
        out = out.replace('\n', ' ').strip()
        if not self.with_stress:
            out = ''.join(c for c in out if c not in _STRESS_MARKS)
        return out

    def __call__(self, text: str) -> str:
        pieces = _PUNCT_SPLIT_RE.split(text)
        out = []
        for piece in pieces:
            if not piece:
                continue
            if _PUNCT_SPLIT_RE.fullmatch(piece):
                out.append(piece)
            elif piece.strip():
                out.append(self._phonemize_chunk(piece))
        return ' '.join(out)


# ASCII letters that have no identical IPA codepoint get their closest symbol.
_ASCII_TO_IPA = {'g': 'ɡ', 'A': 'a', 'B': 'b', 'C': 'k', 'D': 'd', 'E': 'e',
                 'F': 'f', 'G': 'ɡ', 'H': 'h', 'I': 'i', 'J': 'j', 'K': 'k',
                 'L': 'l', 'M': 'm', 'N': 'n', 'O': 'o', 'P': 'p', 'Q': 'k',
                 'R': 'r', 'S': 's', 'T': 't', 'U': 'u', 'V': 'v', 'W': 'w',
                 'X': 'x', 'Y': 'y', 'Z': 'z'}


class GraphemeBackend:
    """Deterministic letter->IPA fallback when no espeak is installed."""

    def __init__(self, language='en', with_stress=False):
        del language, with_stress

    def __call__(self, text: str) -> str:
        return ''.join(_ASCII_TO_IPA.get(c, c) for c in text)


class Phonemizer:
    """Callable text -> IPA string through an explicitly named backend:
    ``espeak``, ``grapheme`` or ``rule``. Unlike ``etts``, there is no silent
    fallback from espeak to graphemes: a wrong backend changes the ids."""

    def __init__(self, language='en', strip=False, with_stress=False,
                 backend: str | None = None):
        self.language = language
        self.strip = strip
        self.with_stress = with_stress
        if backend == 'espeak':
            self.backend = EspeakBackend(language, with_stress)
        elif backend == 'grapheme':
            self.backend = GraphemeBackend(language, with_stress)
        elif backend == 'rule':
            from .rule_g2p import RuleG2PBackend
            self.backend = RuleG2PBackend(language, with_stress)
        else:
            raise ValueError("phonemizer backend must be 'espeak', 'grapheme' "
                             f"or 'rule', got {backend!r}")

    def __call__(self, text: str) -> str:
        phons = self.backend(text)
        return phons.strip() if self.strip else phons
