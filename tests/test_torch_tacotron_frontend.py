"""GST-Tacotron's front end in the port against etts: the keithito text
stack (cleaners, ARPAbet braces, CMUDict), the dB normalisation, pre- and
de-emphasis, the linear and mel spectrograms, and the endpoint."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.data import taco_builders as jtb
from etts.ops import normalizers as jn
from etts import text as jtext
from etts_torch import text as ttext
from etts_torch.data import taco_audio as tta
from etts_torch.ops import normalizers as tn

SENTENCES = [
    "Scientists at the CERN laboratory say they have discovered a new particle.",
    "Mr. Smith paid $3.50 for 2 apples on May 1st, 1905.",
    "Dr. Jones, Capt. Hook and Mrs. Darling met at St. Mary's in 2008.",
    "The café's crème brûlée cost £12, naïvely priced.",
    "Turn left at {HH AH0 L OW1} then go {W EH1 S T}!",
    "  Mixed   case\tand  whitespace, 1,234,567 and 3.14159.  ",
]


@pytest.mark.parametrize("cleaner", ["english_cleaners", "basic_cleaners",
                                     "transliteration_cleaners"])
def test_text_to_sequence_matches_etts(cleaner):
    assert ttext.keithito_symbols == jtext.keithito_symbols
    for s in SENTENCES:
        got = ttext.text_to_sequence(s, [cleaner])
        assert got == jtext.text_to_sequence(s, [cleaner]), s
        assert got[-1] == ttext.keithito_symbols.index("~")
        assert (ttext.sequence_to_text(got)
                == jtext.sequence_to_text(got))


def test_arpabet_and_sequence_to_text():
    seq = ttext.text_to_sequence("say {HH AH0 L OW1} now",
                                 ["english_cleaners"])
    assert ttext.sequence_to_text(seq) == "say {HH AH0 L OW1} now~"
    with pytest.raises(ValueError):
        ttext.text_to_sequence("x", ["no_such_cleaners"])


def test_cmudict_in_memory_matches_etts():
    src = ("ABOUT  AH0 B AW1 T\nABOUT(1)  AH0 B AW1 T\nREAD  R EH1 D\n"
           "READ  R IY1 D\nBAD  B AE1 XX\n;;; comment\n'TIS  T IH1 Z\n")
    for keep in (True, False):
        got = ttext.CMUDict(io.StringIO(src), keep_ambiguous=keep)
        want = jtext.CMUDict(io.StringIO(src), keep_ambiguous=keep)
        assert len(got) == len(want)
        for w in ("about", "read", "bad", "'tis", "none"):
            assert got.lookup(w) == want.lookup(w)
    assert ttext.CMUDict(io.StringIO(src)).lookup("read") == ["R EH1 D",
                                                              "R IY1 D"]


def test_db_normalisation_matches_etts():
    x = np.linspace(-130.0, 20.0, 301, dtype=np.float32)
    np.testing.assert_allclose(tn.normalize_db(torch.from_numpy(x)).numpy(),
                               np.asarray(jn.normalize_db(x)), atol=1e-7)
    s = np.linspace(-0.2, 1.2, 141, dtype=np.float32)
    np.testing.assert_allclose(
        tn.denormalize_db(torch.from_numpy(s), -80.0).numpy(),
        np.asarray(jn.denormalize_db(s, -80.0)), atol=1e-5)


# de-emphasis: the port's float64 blockwise recurrence against etts'
# float32 scan, within 2e-6 of the output's peak (etts' own rounding,
# carried through a filter of gain 1 / (1 - 0.97))
DEEMPH_RTOL = 2e-6


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 50_000])
def test_pre_and_deemphasis_match_etts(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    pre = tn.preemphasis(torch.from_numpy(x))
    np.testing.assert_array_equal(pre.numpy(),
                                  np.asarray(jn.preemphasis(jnp.asarray(x))))
    want = np.asarray(jn.deemphasis(jnp.asarray(x)))
    got = tn.deemphasis(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=DEEMPH_RTOL * np.abs(want).max())
    # and it inverts the pre-emphasis
    np.testing.assert_allclose(tn.deemphasis(pre).numpy(), x, atol=1e-5)


CFG = dict(sampling_rate=16000, n_fft=512, hop_length=100, win_length=400,
           mel_channels=40, f_min=40, f_max=None, preemphasis=0.97,
           ref_level_db=20, min_level_db=-100)


def test_taco_linear_and_mel_match_etts():
    """Within 2e-5 (0.002 dB) on every bin: etts' STFT is float32, the
    port's float64 (4.4e-6 measured on the linear, 2.3e-7 on the mel)."""
    rng = np.random.default_rng(3)
    t = np.arange(8000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) * np.hanning(8000)
           + 0.01 * rng.standard_normal(8000)).astype(np.float32)
    lin, mel = tta.taco_linear_and_mel(wav, CFG)
    jlin, jmel = jtb.taco_linear_and_mel(wav, CFG)
    assert lin.shape == jlin.shape == (81, 257)
    assert mel.shape == jmel.shape == (81, 40)
    for got, want in ((lin.numpy(), jlin), (mel.numpy(), jmel)):
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert (want > 0.0).mean() > 0.99 and want.max() < 1.0  # unclipped


def test_find_endpoint_matches_etts():
    sr = 16000
    rng = np.random.default_rng(1)
    speech = 0.5 * rng.standard_normal(sr)
    for wav in (np.concatenate([speech, np.zeros(2 * sr), speech]),
                speech, np.zeros(3 * sr), np.zeros(100)):
        assert (tta.find_endpoint(wav.astype(np.float32), sr)
                == jtb.find_endpoint(wav.astype(np.float32), sr))
    assert tta.find_endpoint(np.concatenate([speech, np.zeros(2 * sr)]),
                             sr) < 2 * sr
