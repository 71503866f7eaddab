"""CMU pronouncing dictionary wrapper (`gst_tacotron/text/cmudict.py` parity);
copy of ``etts/text/cmudict.py``."""
from __future__ import annotations

from .symbols import ARPABET_SYMBOLS

valid_symbols = ARPABET_SYMBOLS
_valid_symbol_set = set(valid_symbols)


class CMUDict:
    def __init__(self, file_or_path, keep_ambiguous=True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding='latin-1') as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """List of ARPAbet pronunciations, or None."""
        return self._entries.get(word.upper())


def _parse_cmudict(file):
    d = {}
    for line in file:
        if len(line) and ('A' <= line[0] <= 'Z' or line[0] == "'"):
            parts = line.split('  ')
            if len(parts) < 2:
                continue
            word = parts[0]
            pron = _get_pronunciation(parts[1])
            if pron:
                d.setdefault(word, []).append(pron)
    return d


def _get_pronunciation(s):
    parts = s.strip().split(' ')
    if any(p not in _valid_symbol_set for p in parts):
        return None
    return ' '.join(parts)
