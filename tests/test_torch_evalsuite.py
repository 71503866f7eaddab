"""The port's evaluation suite against ``etts.evalsuite`` on seeded wavs:
the metrics (the same numpy code, so 1e-12 relative), WER and its
normalization, and DTW (the C++ library built from
``etts_torch/csrc/dtw.cpp`` against the numpy version against etts, with a
band and without one); ``transcribe``'s backends."""
import importlib

import numpy as np
import pytest
import torch

from etts.evalsuite import dtw as jdtw
from etts.evalsuite import metrics as jmetrics
from etts_torch.evalsuite import dtw as tdtw
from etts_torch.evalsuite import metrics as tmetrics

# the packages' ``wer`` attribute is the function, not the module
jwer = importlib.import_module("etts.evalsuite.wer")
twer = importlib.import_module("etts_torch.evalsuite.wer")
SR = 16000


def _voice(rng, f0, seconds=0.6):
    """A harmonic tone with a vibrato, an envelope and noise."""
    t = np.arange(int(SR * seconds)) / SR
    f = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(f) / SR
    wav = sum(a * np.sin((k + 1) * phase)
              for k, a in enumerate((1.0, 0.4, 0.2)))
    wav *= np.hanning(len(t)) ** 0.5
    return (0.3 * wav + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return _voice(rng, 200.0), _voice(rng, 230.0, seconds=0.7)


@pytest.mark.parametrize("name, call", [
    ("mel_cepstrum", lambda m, r, s: m.mel_cepstrum(r, SR)),
    ("mcd", lambda m, r, s: m.mcd(r, s, SR)),
    ("f0_autocorr", lambda m, r, s: m.f0_autocorr(s, SR)),
    ("f0_rmse", lambda m, r, s: m.f0_rmse(r, s, SR)),
    ("stoi", lambda m, r, s: m.stoi(r, s, SR)),
    ("pesq_proxy", lambda m, r, s: m.pesq_proxy(r, s, SR)),
])
def test_metrics_match_etts(pair, name, call):
    ref, syn = pair
    want, got = call(jmetrics, ref, syn), call(tmetrics, ref, syn)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-12)
    assert np.all(np.isfinite(np.asarray(got, np.float64)))


def test_compute_all_metrics_matches_etts(pair):
    ref, syn = pair
    want = jmetrics.compute_all_metrics(ref, syn, SR)
    got = tmetrics.compute_all_metrics(ref, syn, SR)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12), k


@pytest.mark.parametrize("ref, hyp", [
    ("I have 3 apples, and 21 pears!", "i have three apples and twenty one "
                                       "pears"),
    ("The year 1999 was odd.", "the year one thousand nine hundred ninety "
                               "nine was"),
    ("Don't stop: 100%", "dont stop one hundred"),
    ("", "extra words"),
    ("", ""),
    ("ba do gi", "ba gi gi do"),
])
def test_wer_matches_etts(ref, hyp):
    assert twer.normalize_for_wer(ref) == jwer.normalize_for_wer(ref)
    assert twer.normalize_for_wer(hyp) == jwer.normalize_for_wer(hyp)
    assert twer.wer(ref, hyp) == jwer.wer(ref, hyp)


@pytest.mark.parametrize("band", [None, 4])
@pytest.mark.parametrize("dims", [1, 3])
def test_dtw_native_numpy_and_etts_agree(band, dims):
    rng = np.random.default_rng(dims)
    x = rng.normal(size=(37, dims) if dims > 1 else 37)
    y = rng.normal(size=(29, dims) if dims > 1 else 29)
    d_lib, p_lib = tdtw.dtw_path(x, y, band)
    d_np, p_np = tdtw.dtw_path(x, y, band, backend="numpy")
    d_j, p_j = jdtw.dtw_path(x, y, band)
    assert d_lib == d_np == d_j
    assert p_lib == p_np == p_j
    assert p_lib[0] == (0, 0) and p_lib[-1] == (36, 28)
    assert tdtw.dtw_distance(x, y, band) == d_lib


def test_dtw_library_is_built_from_the_port_source():
    """The library comes from etts_torch/csrc/dtw.cpp under build/, never
    from native/libdtw.so."""
    lib = tdtw.native_library()
    assert str(tdtw.BUILD_DIR) in lib._name
    assert tdtw.SOURCE.name == "dtw.cpp" and "etts_torch" in str(tdtw.SOURCE)
    with pytest.raises(ValueError):
        tdtw.dtw_path(np.zeros(3), np.zeros(3), backend="fastdtw")


def test_transcribe_without_a_backend_is_none(tmp_path, monkeypatch):
    """None only where no ASR backend exists (no recognizer package, no
    cached wav2vec2, no registered CTC checkpoint)."""
    from etts_torch.data.audio_io import save_wav
    from etts_torch.evalsuite import ctc_asr
    monkeypatch.setitem(twer._W2V2, "found", None)
    monkeypatch.delenv("ETTS_CTC_ASR", raising=False)
    ctc_asr.set_default_model(None)
    p = tmp_path / "a.wav"
    save_wav(np.zeros(1600, np.float32), str(p), SR)
    assert twer.transcribe(str(p)) is None


def _fake_wav2vec2(monkeypatch, tmp_path, loads):
    """Fake ``huggingface_hub`` (its config cached) and ``transformers``
    modules whose wav2vec2 fails to load or, with ``loads``, transcribes
    "hello" and records the device of its input."""
    import sys
    import types
    seen = {}

    class Model(torch.nn.Module):
        def forward(self, x):
            seen["device"] = x.device
            logits = torch.zeros(1, 3, 4)
            return types.SimpleNamespace(logits=logits)

    class Processor:
        def __call__(self, wav, sampling_rate, return_tensors):
            return types.SimpleNamespace(
                input_values=torch.from_numpy(wav)[None])

        def decode(self, ids):
            return "hello"

    def from_pretrained(make):
        def load(name, local_files_only):
            assert local_files_only
            if not loads:
                raise OSError(f"{name}: no weights in the cache")
            return make()
        return staticmethod(load)

    hub = types.ModuleType("huggingface_hub")
    hub.try_to_load_from_cache = lambda repo, name: str(tmp_path / name)
    tf = types.ModuleType("transformers")
    tf.Wav2Vec2Processor = type("P", (), {
        "from_pretrained": from_pretrained(Processor)})
    tf.Wav2Vec2ForCTC = type("M", (), {
        "from_pretrained": from_pretrained(Model)})
    monkeypatch.setitem(sys.modules, "speech_recognition", None)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    monkeypatch.setitem(sys.modules, "transformers", tf)
    monkeypatch.setattr(twer, "_W2V2", {})
    return seen


@pytest.mark.parametrize("loads", [False, True])
def test_cached_wav2vec2(tmp_path, monkeypatch, loads):
    """A wav2vec2 whose config is in the HuggingFace cache is the backend
    before a registered CTC checkpoint (etts' order). One that fails to
    load raises, where etts falls through to the next backend; one that
    loads runs on the device ``set_default_model`` names."""
    from etts_torch.data.audio_io import save_wav
    from etts_torch.evalsuite import ctc_asr
    seen = _fake_wav2vec2(monkeypatch, tmp_path, loads)
    p = tmp_path / "a.wav"
    save_wav(np.zeros(1600, np.float32), str(p), SR)
    ctc_asr.set_default_model(None, device="meta")
    try:
        if not loads:
            with pytest.raises(OSError):
                twer.transcribe(str(p))
        else:
            assert twer.backend() == "wav2vec2"
            assert twer.transcribe(str(p)) == "hello"
            assert seen["device"].type == "meta"
    finally:
        ctc_asr.set_default_model(None)
