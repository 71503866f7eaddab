"""Front end of the port against etts: the reference-audio mel
(AudioProcessor.mel_spectrogram) and the text -> ids pipeline."""
from pathlib import Path

import numpy as np
import pytest

from etts.ops.audio import AudioProcessor as JAudio
from etts.text import Pipeline as JPipeline
from etts_torch.ops.audio import AudioProcessor as TAudio
from etts_torch.text import Pipeline as TPipeline

FIXTURE = Path(__file__).parent / "fixtures" / "mel_golden.npz"
CFGS = {
    "melgan": dict(sampling_rate=16000, n_fft=1024, hop_length=256,
                   win_length=1024, mel_channels=80, f_min=0, f_max=None,
                   normalizer="MelGAN"),
    "wavernn": dict(sampling_rate=16000, n_fft=2048, hop_length=200,
                    win_length=800, mel_channels=80, f_min=40, f_max=None,
                    normalizer="WaveRNN"),
}
# Tolerance: 1e-4 on every bin whose linear mel amplitude is at least 1e-3
# (within ~80 dB of the peak); the float32 FFTs of the two frameworks round
# differently in the last bits, and the log of the quietest bins (down to
# the -100 dB floor) magnifies that to at most 5e-3 there.
ATOL, QUIET_ATOL, QUIET = 1e-4, 5e-3, 1e-3


def _check(got, want, amp):
    assert got.shape == want.shape
    loud = amp >= QUIET
    assert loud.mean() > 0.3
    np.testing.assert_allclose(got[loud], want[loud], atol=ATOL)
    np.testing.assert_allclose(got, want, atol=QUIET_ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_mel_matches_jax_and_golden(name):
    fx = np.load(FIXTURE)
    cfg = CFGS[name]
    got = TAudio(cfg).mel_spectrogram(fx["wav"]).numpy()
    ja = JAudio(cfg)
    amp = np.asarray(ja._mel(fx["wav"]))
    _check(got, np.asarray(ja.mel_spectrogram(fx["wav"])), amp)
    _check(got, fx[f"mel_{name}"], amp)


def test_mel_random_wav_matches_jax():
    wav = (np.random.default_rng(5).standard_normal(5000) * 0.2).astype(
        np.float32)
    cfg = CFGS["wavernn"]
    ja = JAudio(cfg)
    _check(TAudio(cfg).mel_spectrogram(wav).numpy(),
           np.asarray(ja.mel_spectrogram(wav)), np.asarray(ja._mel(wav)))


SENTENCES = [
    "Scientists at the CERN laboratory say they have discovered a new particle.",
    "It cost 1,000,000 dollars; really?",
    "Dr. Smith arrived at 10.30 p.m. with 3 friends.",
    "The year 1999 had 365 days, and 2024 had 366!",
    "Mrs. Jones paid 12.5 percent - not 13.",
    "Hello, world: this is test number 42.",
    "Wait... what? No way!",
    "e.g. numbers like 7, 77 and 777 expand.",
    "Ms. O'Neil's co-worker scored 98 points.",
    "Über naïve façades in 2 acts.",
]


@pytest.mark.parametrize("backend", ["grapheme", "rule"])
def test_text_ids_match_etts(backend):
    j = JPipeline.default_pipeline("en", True, False, backend=backend)
    t = TPipeline.default_pipeline("en", True, False, backend=backend)
    assert t.tokenizer.vocab_size == j.tokenizer.vocab_size == 126
    for s in SENTENCES:
        assert t(s) == j(s), s


def test_backend_must_be_named():
    with pytest.raises(ValueError, match="backend"):
        TPipeline.default_pipeline("en", True, False, backend=None)
