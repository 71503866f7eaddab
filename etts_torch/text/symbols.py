"""Symbol alphabets for both text frontends.

IPA set mirrors `TransformerTTS/preprocessing/text/symbols.py:1-12`; the
keithito character+ARPAbet set mirrors `gst_tacotron/text/symbols.py` and
`gst_tacotron/text/cmudict.py:4-12`. Copy of ``etts/text/symbols.py``.
"""

_vowels = 'iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ'
_non_pulmonic_consonants = 'ʘɓǀɗǃʄǂɠǁʛ'
_pulmonic_consonants = 'pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ'
_suprasegmentals = 'ˈˌːˑ'
_other_symbols = 'ʍwɥʜʢʡɕʑɺɧ'
_diacrilics = 'ɚ˞ɫ'
_phonemes = sorted(list(
    _vowels + _non_pulmonic_consonants + _pulmonic_consonants
    + _suprasegmentals + _other_symbols + _diacrilics))
_punctuations = '!,-.:;? '
_alphabet = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyzäüöß'
_not_end_punctuation = ',-.:; '
_numbers = '1234567890'

# --- keithito-style symbol table (Tacotron path) ---

ARPABET_SYMBOLS = [
    'AA', 'AA0', 'AA1', 'AA2', 'AE', 'AE0', 'AE1', 'AE2', 'AH', 'AH0', 'AH1',
    'AH2', 'AO', 'AO0', 'AO1', 'AO2', 'AW', 'AW0', 'AW1', 'AW2', 'AY', 'AY0',
    'AY1', 'AY2', 'B', 'CH', 'D', 'DH', 'EH', 'EH0', 'EH1', 'EH2', 'ER',
    'ER0', 'ER1', 'ER2', 'EY', 'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH',
    'IH0', 'IH1', 'IH2', 'IY', 'IY0', 'IY1', 'IY2', 'JH', 'K', 'L', 'M', 'N',
    'NG', 'OW', 'OW0', 'OW1', 'OW2', 'OY', 'OY0', 'OY1', 'OY2', 'P', 'R',
    'S', 'SH', 'T', 'TH', 'UH', 'UH0', 'UH1', 'UH2', 'UW', 'UW0', 'UW1',
    'UW2', 'V', 'W', 'Y', 'Z', 'ZH']

PAD = '_'
EOS = '~'
_characters = '"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!\'(),-.:;? '
# '@' prefix keeps ARPAbet distinct from uppercase letters
keithito_symbols = [PAD, EOS] + list(_characters) + ['@' + s for s in ARPABET_SYMBOLS]
