"""keithito-style text<->sequence conversion for the Tacotron path.

Parity with `gst_tacotron/text/__init__.py`: ARPAbet in curly braces, cleaner
selection by name, EOS '~' appended. Copy of ``etts/text/keithito.py``.
"""
from __future__ import annotations

import re

from .symbols import keithito_symbols
from .cleaners import KEITHITO_CLEANERS

_symbol_to_id = {s: i for i, s in enumerate(keithito_symbols)}
_id_to_symbol = {i: s for i, s in enumerate(keithito_symbols)}
_curly_re = re.compile(r'(.*?)\{(.+?)\}(.*)')


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = KEITHITO_CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f'Unknown cleaner: {name}')
        text = cleaner(text)
    return text


def _symbols_to_sequence(symbols):
    return [_symbol_to_id[s] for s in symbols
            if s in _symbol_to_id and s not in ('_', '~')]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(['@' + s for s in text.split()])


def text_to_sequence(text, cleaner_names):
    """Text (with optional {ARPAbet}) -> list of symbol ids, EOS-terminated."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    sequence.append(_symbol_to_id['~'])
    return sequence


def sequence_to_text(sequence):
    result = ''
    for sid in sequence:
        if sid in _id_to_symbol:
            s = _id_to_symbol[sid]
            if len(s) > 1 and s[0] == '@':
                s = '{%s}' % s[1:]
            result += s
    return result.replace('}{', ' ')
