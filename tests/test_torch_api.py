"""The port's end-to-end path on the CPU at a tiny size: text + reference
wav -> mel (TTSSynthesizer) -> wav (VocoderSynthesizer), from a config dir
and flat npz exports, against the etts chain on the same weights:
AudioProcessor -> encode_ref -> autoregressive_predict, and generate.
The vocoder is peaky RAW, so its sampling is deterministic."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from etts.models.autoregressive import (AutoregressiveTransformer as JM,
                                        autoregressive_predict)
from etts.models.wavernn import generate as jgenerate
from etts.ops.audio import AudioProcessor
from etts.utils.config import ConfigManager
from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
from etts_torch.ops.kernels.decoder_step import can_fuse
from torch_parity import flatten

ROOT = Path(__file__).resolve().parents[1]
TEXT = "Hello world, this is 42 tests."
TTS_SMALL = dict(
    decoder_model_dimension=32, encoder_model_dimension=32,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    decoder_prenet_dimension=24, encoder_prenet_dimension=32,
    encoder_attention_conv_filters=32, decoder_attention_conv_filters=32,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=2, decoder_dense_blocks=2,
    ref_encoder_filters=[4, 8], ref_encoder_gru_cell_units=8,
    gst_style_embed_dim=16, gst_multi_num_heads=2, gst_heads=5,
    reduction_factor_schedule=[[0, 2], [80000, 1]])
VOC_SMALL = dict(voc_mode="RAW", voc_rnn_dims=16, voc_fc_dims=16,
                 voc_compute_dims=8, voc_res_out_dims=8, voc_res_blocks=2,
                 voc_target=600, voc_overlap=50)


def _jit_init(model, kind):
    """The inputs of etts.utils.config._init_variables, under jit (a few
    times faster than its eager init)."""
    k = jax.random.PRNGKey(0)
    if kind == "autoregressive":
        rngs = {"params": k, "dropout": k, "prenet": k}
        return jax.jit(lambda g, ids, mel, spk: model.init(g, ids, mel, spk,
                                                           r=1))(
            rngs, jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 6, 80)),
            jnp.zeros((1, 1, 256)))
    return jax.jit(lambda g, x, mel: model.init(g, x, mel, False))(
        k, jnp.zeros((1, 4 * 200)), jnp.zeros((1, 8, 80)))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    for kind, over in (("autoregressive", TTS_SMALL), ("wavernn", VOC_SMALL),
                       ("data", {"phonemizer_backend": "grapheme",
                                 "log_directory": str(d / "logs")})):
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    out = {"dir": d}
    for kind in ("autoregressive", "wavernn"):
        cm = ConfigManager(str(d), kind)
        model = cm.get_model(ignore_hash=True)
        variables = dict(_jit_init(model, kind))
        if kind == "wavernn":   # near-delta categorical: argmax sampling
            p = {k: dict(v) if hasattr(v, "items") else v
                 for k, v in variables["params"].items()}
            p["fc3"]["kernel"] = p["fc3"]["kernel"] * 1e6
            variables["params"] = p
        np.savez(d / f"{kind}.npz", **flatten(variables))
        out[kind] = (cm, model, variables)
    wav = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    out["wav"] = 0.2 * wav
    out["spk"] = np.random.default_rng(1).standard_normal(256).astype(
        np.float32)
    return out


@pytest.fixture(scope="module")
def jax_mel(workspace):
    """(reference mel, predicted mel) of the etts chain, computed once."""
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
