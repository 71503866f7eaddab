"""Pure-Python number verbalization (English + German).

Replaces the ``num2words`` dependency of
`TransformerTTS/preprocessing/text/numbers.py` and the ``inflect`` dependency
of `gst_tacotron/text/numbers.py` — neither library is assumed available.
Provides cardinals, ordinals, year-style grouping, and the keithito
money/comma/decimal normalization rules. Copy of ``etts/text/numbers_en.py``.
"""
from __future__ import annotations

import re

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen',
         'fifteen', 'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'),
           (10 ** 3, 'thousand'), (100, 'hundred')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def number_to_words(n: int, andword: str = 'and') -> str:
    """Cardinal English verbalization of a non-negative integer."""
    if n < 0:
        return 'minus ' + number_to_words(-n, andword)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ('-' + _ONES[rem] if rem else '')
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            head = number_to_words(major, andword) + ' ' + name
            if not rem:
                return head
            if rem < 100 and andword:
                return head + f' {andword} ' + number_to_words(rem, andword)
            return head + ' ' + number_to_words(rem, andword)
    return _ONES[n]  # unreachable


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    pieces = re.split(r'([ -])', words)
    last = pieces[-1]
    if last in _ORDINAL_IRREGULAR:
        pieces[-1] = _ORDINAL_IRREGULAR[last]
    elif last.endswith('y'):
        pieces[-1] = last[:-1] + 'ieth'
    else:
        pieces[-1] = last + 'th'
    return ''.join(pieces)


def year_to_words(n: int) -> str:
    """keithito year grouping: 1905 -> 'nineteen oh five', 2008 -> 'two thousand eight'
    (behavior of `gst_tacotron/text/numbers.py:46-57`)."""
    if not (1000 < n < 3000):
        return number_to_words(n, andword='')
    if n == 2000:
        return 'two thousand'
    if 2000 < n < 2010:
        return 'two thousand ' + number_to_words(n % 100, andword='')
    if n % 100 == 0:
        return number_to_words(n // 100, andword='') + ' hundred'
    head = number_to_words(n // 100, andword='')
    tail = n % 100
    tail_words = 'oh ' + _ONES[tail] if tail < 10 else number_to_words(tail, andword='')
    return head + ' ' + tail_words


# ---------------------------------------------------------------------------
# German cardinals (for the German cleaner)
# ---------------------------------------------------------------------------

_DE_ONES = ['null', 'eins', 'zwei', 'drei', 'vier', 'fünf', 'sechs', 'sieben',
            'acht', 'neun', 'zehn', 'elf', 'zwölf', 'dreizehn', 'vierzehn',
            'fünfzehn', 'sechzehn', 'siebzehn', 'achtzehn', 'neunzehn']
_DE_TENS = ['', '', 'zwanzig', 'dreißig', 'vierzig', 'fünfzig', 'sechzig',
            'siebzig', 'achtzig', 'neunzig']


def _de_below_100(n: int, final: bool) -> str:
    if n < 20:
        if n == 1 and not final:
            return 'ein'
        return _DE_ONES[n]
    tens, rem = divmod(n, 10)
    if rem == 0:
        return _DE_TENS[tens]
    unit = 'ein' if rem == 1 else _DE_ONES[rem]
    return unit + 'und' + _DE_TENS[tens]


def number_to_words_de(n: int) -> str:
    if n < 0:
        return 'minus ' + number_to_words_de(-n)
    if n < 100:
        return _de_below_100(n, final=True)
    if n < 1000:
        hund, rem = divmod(n, 100)
        head = _de_below_100(hund, final=False) + 'hundert'
        return head + (_de_below_100(rem, final=True) if rem else '')
    if n < 10 ** 6:
        thou, rem = divmod(n, 1000)
        head = (number_to_words_de(thou) if thou >= 100
                else _de_below_100(thou, final=False)) + 'tausend'
        return head + (number_to_words_de(rem) if rem else '')
    mill, rem = divmod(n, 10 ** 6)
    head = ('eine Million' if mill == 1
            else _de_below_100(mill, final=True) + ' Millionen' if mill < 100
            else number_to_words_de(mill) + ' Millionen')
    return head + (' ' + number_to_words_de(rem) if rem else '')


def cardinal(n: int, lang: str = 'en') -> str:
    return number_to_words_de(n) if lang == 'de' else number_to_words(n)


# ---------------------------------------------------------------------------
# TransformerTTS-style Numbers helper (`preprocessing/text/numbers.py:6-47`)
# ---------------------------------------------------------------------------

class Numbers:
    """Regex-based digit expansion: comma decimals, '.000' thousands markers,
    decimal points, then plain cardinals."""

    def __init__(self, lang_ID: str, comma: str, thousand: str):
        self.lang_ID = lang_ID
        self.comma = comma
        self.thousand = thousand
        self._comma_number_re = re.compile(r'([0-9]+,[0-9]+)')
        self._decimal_number_re = re.compile(r'(\d+\.\d{1,2}[^.\d])')
        self._number_re = re.compile(r'[0-9]+')
        self._decimal_thousands_re = re.compile(r'(\.000)')
        self._decimal_hundreds_re = re.compile(r'(\.\d\d\d)')

    def expand_comma(self, text):
        return self._comma_number_re.sub(
            lambda m: m.group(1).replace(',', f' {self.comma} '), text)

    def expand_decimal_thousands(self, text):
        return self._decimal_thousands_re.sub(
            lambda m: m.group(1).replace('.000', self.thousand), text)

    def expand_decimal_hundreds(self, text):
        return self._decimal_hundreds_re.sub(
            lambda m: m.group(1).replace('.', self.thousand), text)

    def expand_decimal_point(self, text):
        return self._decimal_number_re.sub(
            lambda m: m.group(1).replace('.', f' {self.comma} '), text)

    def expand_number(self, text):
        return self._number_re.sub(
            lambda m: cardinal(int(m.group(0)), self.lang_ID), text)


# ---------------------------------------------------------------------------
# keithito-style normalize_numbers (`gst_tacotron/text/numbers.py:62-69`)
# ---------------------------------------------------------------------------

_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return '%s %s, %s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars',
                                 cents, 'cent' if cents == 1 else 'cents')
    if dollars:
        return '%s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars')
    if cents:
        return '%s %s' % (cents, 'cent' if cents == 1 else 'cents')
    return 'zero dollars'


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(',', ''), text)
    text = _pounds_re.sub(r'\1 pounds', text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(
        lambda m: m.group(1).replace('.', ' point '), text)
    text = _ordinal_re.sub(
        lambda m: number_to_ordinal_words(int(re.sub(r'(st|nd|rd|th)$', '', m.group(0)))),
        text)
    text = _number_re.sub(lambda m: year_to_words(int(m.group(0))), text)
    return text
