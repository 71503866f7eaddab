"""Text frontend: cleaner -> phonemizer -> tokenizer.

Own copy of the framework-free ``etts.text`` pipeline (the port imports
nothing of ``etts``), without the Tacotron-only keithito/CMUDict stack.
Parity with `TransformerTTS/preprocessing/text/__init__.py:6-40`.
"""
from .symbols import _phonemes, _punctuations
from .cleaners import English, German
from .tokenizer import Tokenizer, Phonemizer

__all__ = ["Pipeline", "English", "German", "Tokenizer", "Phonemizer"]


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
        tokenizer = Tokenizer(sorted(list(_phonemes) + list(_punctuations)),
                              add_start_end=add_start_end)
        return cls(cleaner=cleaner, phonemizer=phonemizer, tokenizer=tokenizer)
