"""Text cleaners for both frontends.

``English``/``German`` mirror `TransformerTTS/preprocessing/text/cleaners.py`
(char filtering -> number expansion -> abbreviation collapse). Copy of
``etts/text/cleaners.py`` without the Tacotron (keithito) cleaners.
"""
from __future__ import annotations

import re
from typing import Union

from .symbols import _alphabet, _punctuations, _numbers
from .numbers_en import Numbers


class English:
    def __init__(self, alphabet=None):
        self.accepted_chars = list(alphabet or (_alphabet + _punctuations + _numbers))
        self.numbers = Numbers(lang_ID='en', comma='comma', thousand='thousands')
        self.abbreviations = {
            'Mrs.': 'Mrs', 'Mr.': 'Mr', 'Dr.': 'Dr', 'St.': 'St', 'Co.': 'Co',
            'Jr.': 'Jr', 'Maj.': 'Maj', 'Gen.': 'Gen', 'Drs.': 'Drs',
            'Rev.': 'Rev', 'Lt.': 'Lt', 'Hon.': 'Hon', 'Sgt.': 'Sgt',
            'Capt.': 'Capt', 'Esq.': 'Esq', 'Ltd.': 'Ltd', 'Col.': 'Col',
            'Ft.': 'Ft', 'a.m.': 'a m', 'p.m.': 'p m', 'e.g.': 'e g',
            'i.e.': 'i e', ';': ',', ':': ','}
        self._abbrev_re = re.compile(
            '|'.join(sorted(re.escape(k) for k in self.abbreviations)))

    def __call__(self, text: Union[str, list]):
        if isinstance(text, list):
            return [self._clean_line(t) for t in text]
        if isinstance(text, str):
            return self._clean_line(text)
        raise TypeError(f'cleaner input must be list or str, not {type(text)}')

    def _filter_chars(self, text):
        return ''.join(c for c in text if c in self.accepted_chars)

    def _clean_line(self, text):
        text = self._filter_chars(text)
        text = self._expand_numbers(text)
        return self._abbrev_re.sub(lambda m: self.abbreviations[m.group(0)], text)

    def _expand_numbers(self, text):
        ends_with_dot = text.endswith('.')
        if ends_with_dot:
            text = text[:-1]
        text = self.numbers.expand_comma(text)
        text = self.numbers.expand_decimal_thousands(text)
        text = self.numbers.expand_decimal_hundreds(text)
        text = self.numbers.expand_decimal_point(text)
        text = self.numbers.expand_number(text)
        return text + '.' if ends_with_dot else text


class German:
    def __init__(self, alphabet=None):
        self.accepted_chars = list(alphabet or (_alphabet + _punctuations + _numbers))
        self.numbers = Numbers(lang_ID='de', comma='Komma', thousand='tausend')
        self._date_re = re.compile(r'([0-9]{1,2}\.+)')
        self._time_re = re.compile(r'([0-9]{1,2}).([0-9]{1,2})(\s*Uhr)')

    def __call__(self, text: Union[str, list]):
        if isinstance(text, list):
            return [self._clean_line(t) for t in text]
        if isinstance(text, str):
            return self._clean_line(text)
        raise TypeError(f'cleaner input must be list or str, not {type(text)}')

    def _clean_line(self, text):
        text = ''.join(c for c in text if c in self.accepted_chars)
        return self._expand_numbers(text)

    def _fix_time(self, m):
        if int(m.group(2)):
            return m.group(1) + m.group(3) + ' ' + m.group(2)
        return m.group(1) + m.group(3)

    def _expand_date(self, m):
        num = int(m.group(0).replace('.', ''))
        suffix = 'ten' if num < 20 else 'sten'
        return m.group(1).replace('.', suffix)

    def _expand_numbers(self, text):
        ends_with_dot = text.endswith('.')
        if ends_with_dot:
            text = text[:-1]
        text = self.numbers.expand_comma(text)
        text = self._time_re.sub(self._fix_time, text)
        text = self.numbers.expand_decimal_thousands(text)
        text = self.numbers.expand_decimal_hundreds(text)
        text = self.numbers.expand_decimal_point(text)
        text = self._date_re.sub(self._expand_date, text)
        text = self.numbers.expand_number(text)
        return text + '.' if ends_with_dot else text

