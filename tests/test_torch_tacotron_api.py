"""GST-Tacotron serving in the port against etts, as a whole: text ->
linear spectrogram -> wav through ``TacotronSynthesizer.synthesize`` (2
Griffin-Lim iterations in the tiny config), and ``python -m
etts_torch.eval_tacotron`` on the CPU.

etts' synthesizer is built on the same tiny weights without a checkpoint;
its model's ``generate`` is applied under ``jax.jit`` (the same function
as its eager apply, which takes some 12 s to trace here). The prenets keep
every unit on both sides (etts' ``variable_rate_dropout`` replaced in this
process, the port's uniforms 0). Tolerances: the linear spectrogram and the
alignments 1e-5 absolute; the wav after 2 Griffin-Lim iterations and
de-emphasis 1e-4 of its peak (etts' STFT pair is float32, the port's
float64; at n_fft 64 they stay that close, as in
``tests/test_torch_griffin_lim.py``)."""
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import etts.models.tacotron as jtaco
from etts.api import TacotronSynthesizer as JSynth
from etts.data.taco_builders import taco_linear_and_mel as jlinear_and_mel
from etts.text import text_to_sequence as jtext_to_sequence
from etts.utils.config import ConfigManager
from etts_torch.api import TacotronSynthesizer
from etts_torch.eval_tacotron import main as eval_tacotron
from etts_torch.synthesize import write_wav
from etts_torch.text import keithito_symbols
from torch_parity import ROOT, taco_flat, unflatten

TEXT = "Dr. Smith paid $3.50 for {HH AH0 L OW1} 2 apples."
# TACO_TINY in tacotron_config.yaml's keys; the data config at n_fft 64
TACO_CONFIG = dict(
    embed_depth=16, attention_depth=16, rnn_depth=16, num_freq=33,
    outputs_per_step=2, prenet_depths=[16, 8], num_gst=4, num_heads=2,
    style_embed_depth=16, style_att_dim=8, reference_filters=[4, 8],
    reference_depth=8, max_iters=6, cbhg_width=8, griffin_lim_iters=2)
DATA_CONFIG = dict(mel_channels=10, n_fft=64, hop_length=16, win_length=64)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A config dir of configs/default shrunk to TACO_TINY, the flat export
    of one draw of every variable of etts' model (vocabulary: the keithito
    table) and a seeded reference wav."""
    d = tmp_path_factory.mktemp("taco")
    for kind, over in (("tacotron", TACO_CONFIG),
                       ("data", dict(DATA_CONFIG,
                                     log_directory=str(d / "logs")))):
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    flat = taco_flat(seed=4, vocab_size=len(keithito_symbols))
    np.savez(d / "tacotron.npz", **flat)
    t = np.arange(4000) / 16000
    wav = (0.4 * np.sin(2 * np.pi * 300 * t) + 0.02 * np.random.default_rng(
        0).standard_normal(t.shape)).astype(np.float32)
    write_wav(d / "ref.wav", wav, 16000)
    return {"dir": d, "flat": flat, "wav": wav}


class _Jitted:
    """etts' flax model with ``apply(..., method=Tacotron.generate)`` under
    ``jax.jit``."""

    def __init__(self, model):
        self.f = jax.jit(lambda v, i, n, ref, rngs: model.apply(
            v, i, n, ref, method=jtaco.Tacotron.generate, rngs=rngs))

    def apply(self, variables, ids, lengths, ref, method, rngs):
        assert method is jtaco.Tacotron.generate
        return self.f(variables, ids, lengths, ref, rngs)


def test_synthesize_matches_etts(workspace, monkeypatch):
    d = workspace["dir"]
    monkeypatch.setattr(jtaco, "variable_rate_dropout",
                        lambda x, rate, rng: x / (1.0 - rate))
    cm = ConfigManager(str(d), "tacotron")
    js = object.__new__(JSynth)
    js.config = cm.config
    js.model = _Jitted(cm.get_model(ignore_hash=True))
    js.variables = unflatten(workspace["flat"])

    ts = TacotronSynthesizer(d, d / "tacotron.npz", "cpu")
    draw = ts.model.draw_uniforms
    monkeypatch.setattr(ts.model, "draw_uniforms", lambda *a, **k: {
        key: torch.zeros_like(u) for key, u in draw(*a, **k).items()})

    ref_mel = np.array(jlinear_and_mel(workspace["wav"], js.config)[1])
    seq = ts.encode_text(TEXT)
    assert seq.tolist() == jtext_to_sequence(TEXT, ["english_cleaners"])
    want = js.model.f(js.variables, jnp.asarray(seq)[None],
                      jnp.asarray([len(seq)]), jnp.asarray(ref_mel)[None],
                      {n: jax.random.PRNGKey(0) for n in ("prenet",
                                                          "zoneout",
                                                          "dropout",
                                                          "style")})
    got = ts.model.generate(torch.from_numpy(seq)[None],
                            torch.tensor([len(seq)]),
                            torch.from_numpy(ref_mel)[None])
    for k in ("linear_outputs", "alignments"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)

    jwav, jalign = js.synthesize(TEXT, reference_mel=ref_mel)
    wav, align = ts.synthesize(TEXT, reference_mel=ref_mel)
    jwav = np.asarray(jwav)
    assert wav.shape == jwav.shape == ((6 * 2 - 1) * 16,)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    np.testing.assert_allclose(wav, jwav, rtol=0,
                               atol=1e-4 * np.abs(jwav).max())
    np.testing.assert_allclose(align, np.asarray(jalign), rtol=0, atol=1e-5)


def test_eval_tacotron_cli(workspace, tmp_path, capsys):
    """Sentences with a reference wav, then a sentences file cut by
    --n_utts, without one: one <id>.wav each, at most (max_iters * r - 1) * hop
    samples of 16-bit PCM at the config's rate."""
    d = workspace["dir"]
    out = tmp_path / "out"
    eval_tacotron(["--config", str(d), "--weights", str(d / "tacotron.npz"),
                   "--reference_audio", str(d / "ref.wav"), "--sentences",
                   "Hello there.", "A second one.", "--out_dir", str(out),
                   "--device", "cpu"])
    (tmp_path / "rows.txt").write_text("a1|First row.\nbad line\n"
                                       "a2|Second row.|x\na3|Third.\n")
    eval_tacotron(["--config", str(d), "--weights", str(d / "tacotron.npz"),
                   "--sentences_file", str(tmp_path / "rows.txt"),
                   "--n_utts", "2", "--out_dir", str(out), "--device",
                   "cpu"])
    names = sorted(p.name for p in out.glob("*.wav"))
    assert names == ["a1.wav", "a2.wav", "eval_0.wav", "eval_1.wav"]
    for p in out.glob("*.wav"):
        with wave.open(str(p), "rb") as f:
            assert f.getframerate() == 16000 and f.getsampwidth() == 2
            assert 0 < f.getnframes() <= (6 * 2 - 1) * 16
    assert "Wrote outputs to" in capsys.readouterr().out
