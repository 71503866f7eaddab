"""The port's end-to-end path on the CPU at a tiny size: text + reference
wav -> mel (TTSSynthesizer) -> wav (VocoderSynthesizer), from a config dir
and flat npz exports, against the etts chain on the same weights:
AudioProcessor -> encode_ref -> autoregressive_predict, and generate.
The vocoder is peaky RAW, so its sampling is deterministic."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from etts.models.autoregressive import (AutoregressiveTransformer as JM,
                                        autoregressive_predict)
from etts.models.wavernn import generate as jgenerate
from etts.ops.audio import AudioProcessor
from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
from etts_torch.ops.kernels.decoder_step import can_fuse
from torch_parity import ROOT, small_workspace

TEXT = "Hello world, this is 42 tests."


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return small_workspace(tmp_path_factory.mktemp("cfg"))


@pytest.fixture(scope="module")
def jax_out(workspace):
    """(reference mel, autoregressive_predict's outputs) of the etts chain,
    computed once."""
    ws = workspace
    cm, model, variables = ws["autoregressive"]
    ref_mel = np.asarray(AudioProcessor(cm.config).mel_spectrogram(
        ws["wav"])).T
    ids = np.asarray(cm.get_text_pipeline()(TEXT), np.int32)[None]
    out = autoregressive_predict(
        model, variables, jnp.asarray(ids),
        JM.encode_ref(jnp.asarray(ref_mel), 2),
        jnp.asarray(ws["spk"]).reshape(1, 1, -1), r=2, max_length=20,
        key=jax.random.PRNGKey(0), prenet_dropout=0.0)
    return ref_mel, out


@pytest.fixture(scope="module")
def jax_mel(jax_out):
    """(reference mel, predicted mel) of the etts chain."""
    ref_mel, out = jax_out
    return ref_mel, np.asarray(out["mel"][0][:int(out["mel_length"])])


def test_text_and_ref_wav_to_mel(workspace, jax_mel):
    tts = TTSSynthesizer(workspace["dir"],
                         workspace["dir"] / "autoregressive.npz", "cpu")
    assert tts.r == 2 and tts.prenet_dropout == 0.0 and can_fuse(tts.model)
    ref_mel, want = jax_mel
    got_ref = tts.mel_from_wav(workspace["wav"])
    np.testing.assert_allclose(got_ref, ref_mel, atol=5e-3)
    mel = tts.predict(TEXT, got_ref, workspace["spk"], max_length=20)["mel"]
    assert mel.shape == want.shape
    np.testing.assert_allclose(mel, want, atol=1e-4)


@pytest.mark.parametrize("path", ["fused", "plain"])
def test_predict_style_outputs(workspace, jax_out, path, monkeypatch):
    """predict returns etts' gst_tokens and gst_attention
    (`etts/api.py:186-191`) on the fused decode and on the plain one, from
    the same reference mel: deterministic, before any feedback, so 1e-5."""
    tts = TTSSynthesizer(workspace["dir"],
                         workspace["dir"] / "autoregressive.npz", "cpu")
    if path == "plain":
        monkeypatch.setattr("etts_torch.api.can_fuse", lambda m: False)
    ref_mel, want = jax_out
    got = tts.predict(TEXT, np.array(ref_mel), workspace["spk"], max_length=20)
    for key, wkey in (("gst_tokens", "gst_tokens"),
                      ("gst_attention", "gst_encoder_attention")):
        assert sorted(got[key]) == sorted(want[wkey])
        for k, v in want[wkey].items():
            assert isinstance(got[key][k], np.ndarray)
            np.testing.assert_allclose(got[key][k], np.asarray(v), atol=1e-5)
    np.testing.assert_allclose(got["mel"], np.asarray(
        want["mel"][0][:int(want["mel_length"])]), atol=1e-4)


def test_mel_to_wav(workspace, jax_mel):
    cm, model, variables = workspace["wavernn"]
    _, mel = jax_mel
    voc_mel = (mel + 4.0) / 8.0
    want = np.asarray(jgenerate(model, variables, jnp.asarray(voc_mel),
                                batched=True, target=600, overlap=50,
                                mu_law=True, key=jax.random.PRNGKey(0),
                                use_pallas=False))
    voc = VocoderSynthesizer(workspace["dir"],
                             workspace["dir"] / "wavernn.npz", "cpu")
    got = voc.generate(voc_mel)
    assert got.shape == want.shape == ((mel.shape[0] - 1) * 200,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_missing_conditioning_raises(workspace):
    tts = TTSSynthesizer(workspace["dir"],
                         workspace["dir"] / "autoregressive.npz", "cpu")
    with pytest.raises(ValueError, match="reference"):
        tts.predict(TEXT, None, workspace["spk"])
    with pytest.raises(ValueError, match="speaker"):
        tts.predict(TEXT, tts.mel_from_wav(workspace["wav"]), None)


def test_synthesize_cli(workspace, tmp_path):
    from etts_torch.synthesize import write_wav
    ref = tmp_path / "ref.wav"
    write_wav(ref, workspace["wav"], 16000)
    np.save(tmp_path / "spk.npy", workspace["spk"])
    d = workspace["dir"]
    out = subprocess.run(
        [sys.executable, "-m", "etts_torch.synthesize",
         "--tts_config", str(d), "--tts_weights", str(d / "autoregressive.npz"),
         "--voc_config", str(d), "--voc_weights", str(d / "wavernn.npz"),
         "--ref_wav", str(ref), "--spk_embed", str(tmp_path / "spk.npy"),
         "--sentences", TEXT, "--max_length", "20", "--device", "cpu",
         "--out_dir", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mel = np.load(tmp_path / "out" / "0_mel.npy")
    assert (tmp_path / "out" / "0.wav").stat().st_size == 44 + 2 * (
        mel.shape[0] - 1) * 200
