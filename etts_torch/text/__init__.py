"""Text frontend: cleaner -> phonemizer -> tokenizer.

Own copy of the framework-free ``etts.text`` pipeline (the port imports
nothing of ``etts``), with the keithito/CMUDict stack of the GST-Tacotron
path (`gst_tacotron/text/`). Parity with
`TransformerTTS/preprocessing/text/__init__.py:6-40`.
"""
from .symbols import _phonemes, _punctuations, keithito_symbols
from .cleaners import English, German
from .tokenizer import Tokenizer, Phonemizer
from .cmudict import CMUDict
from .keithito import text_to_sequence, sequence_to_text

__all__ = ["Pipeline", "English", "German", "Tokenizer", "Phonemizer",
           "default_tokenizer", "CMUDict", "text_to_sequence",
           "sequence_to_text", "keithito_symbols"]


def default_tokenizer(add_start_end: bool) -> Tokenizer:
    """The models' tokenizer: the phoneme and punctuation alphabet, with the
    start and end tokens for the autoregressive model. It needs no
    phonemizer, so a dataset of phonemes tokenizes without one."""
    return Tokenizer(sorted(list(_phonemes) + list(_punctuations)),
                     add_start_end=add_start_end)


class Pipeline:
    def __init__(self, cleaner, phonemizer, tokenizer):
        self.cleaner = cleaner
        self.phonemizer = phonemizer
        self.tokenizer = tokenizer

    def __call__(self, input_text):
        return self.tokenizer(self.phonemizer(self.cleaner(input_text)))

    @classmethod
    def default_pipeline(cls, language, add_start_end, with_stress, backend,
                         strip=False):
        """``backend`` is required ('espeak' | 'grapheme' | 'rule');
        ``strip=True`` is the training-time variant."""
        if language == 'en':
            cleaner = English()
        elif language == 'de':
            cleaner = German()
        else:
            raise ValueError(f'language must be "en" or "de", not {language!r}')
        phonemizer = Phonemizer(language=language, strip=strip,
                                with_stress=with_stress, backend=backend)
        return cls(cleaner=cleaner, phonemizer=phonemizer,
                   tokenizer=default_tokenizer(add_start_end))
