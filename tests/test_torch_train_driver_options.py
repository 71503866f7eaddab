"""The driver with each option etts' driver takes, a few steps on the CPU on
a tiny corpus: mine_type MINE, CLUB and MINE_CLUB, the adversarial game,
scheduled sampling with the style loss and the MINE batch of its own, GTA
decoder inputs with the pretrained freeze. Each must run to its end with
finite losses and its checkpoints."""
import math

import numpy as np
import pytest
import torch

from etts_torch.train_autoregressive import main
from etts_torch.utils.config import ConfigManager
from etts_torch.utils.logging import read_scalars
from torch_parity import tiny_corpus

CASES = {
    "mine": {},
    "club": {"mine_type": "CLUB"},
    "mine_club_adversarial": {"mine_type": "MINE_CLUB",
                              "mine_adversarial": True},
    "sampling_style_sep_call": {
        "scheduled_sampling_schedule": [[0, 0.5]], "use_style_loss": True,
        "mine_sep_call": True, "divergence_type": "reyni",
        "mine_smoothing_factor": 0.9},
    "gta_pretrained": {"gta": True, "use_pretrained": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_option_runs(tmp_path, case):
    over = dict(CASES[case])
    gta = over.pop("gta", False)
    ids = tiny_corpus(tmp_path, **over)
    extra = []
    if gta:
        gdir = tmp_path / "gta"
        gdir.mkdir()
        for u in ids:
            mel = np.load(tmp_path / "corpus" / "mels" / f"{u}.npy")
            np.save(gdir / f"{u}.npy", mel[:-1] * 0.9)
        extra = ["--gta_mel_dir", str(gdir)]
    main(["--config", str(tmp_path), "--device", "cpu", "--session_name",
          "s", "--max_steps", "3", *extra])
    cm = ConfigManager(tmp_path, "autoregressive", "s")
    logs = read_scalars(cm.log_dir)
    assert len(logs["train/loss"]) == 3
    assert all(math.isfinite(v) for v in logs["train/loss"].values())
    n_mi = sum(1 for tag in logs if tag.startswith("mi/"))
    assert n_mi == len(cm.mine_weights_dir) > 0
    for w in [cm.weights_dir] + cm.mine_weights_dir:
        assert (w / "ckpt-3.pt").exists()
    if over.get("use_pretrained"):
        tree = torch.load(cm.weights_dir / "ckpt-3.pt", weights_only=True)
        assert len(tree["optimizer"]["state"]) < len(
            [k for k in tree["model"] if "running" not in k])


def test_profile_trace_and_prediction_audio(tmp_path):
    """``--profile_dir`` writes the trace of steps start + 10 to start + 30
    (each step a ``step N`` span), and the predictions (every 5 steps)
    from ``audio_start_step`` 20 at ``audio_prediction_frequency`` 10 (the
    steps whose count, step + 1, is 20 and 30) leave their Griffin-Lim wav
    beside their mel: at the config's sampling rate, finite, hop samples
    a frame of the mel."""
    import json

    from etts_torch.data.audio_io import load_wav
    tiny_corpus(tmp_path, use_mine=False, weights_save_frequency=100,
                prediction_frequency=5, audio_start_step=20,
                audio_prediction_frequency=10)
    prof = tmp_path / "prof"
    main(["--config", str(tmp_path), "--device", "cpu", "--session_name",
          "s", "--max_steps", "32", "--profile_dir", str(prof)])
    trace = prof / "trace_steps_10-30.json"
    assert trace.exists()
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("name", "").startswith("step ")}
    assert spans == {f"step {n}" for n in range(10, 31)}
    cm = ConfigManager(tmp_path, "autoregressive", "s")
    wavs = sorted(p.name for p in cm.log_dir.glob("*.wav"))
    assert wavs == ["prediction_audio_19.wav", "prediction_audio_29.wav"]
    for step in (19, 29):
        wav, sr = load_wav(cm.log_dir / f"prediction_audio_{step}.wav")
        mel = np.load(cm.log_dir / f"prediction_mel_{step}.npy")
        assert sr == cm.config["sampling_rate"]
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0
        assert len(wav) == cm.config["hop_length"] * len(mel)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_float32_unchanged(reverse):
    """``gru_scan``'s float32 path, which the vocoder and GST-Tacotron
    train through, is bit for bit the loop it was before the bf16 path:
    the vocoder's two GRUs at VOC_TINY's width (16), forwards and
    backwards, with and without a start state."""
    from etts_torch.ops.gru import gru_cell, gru_scan

    def before(wi, wh, bi, bh, xs, h0=None):
        b, t, _ = xs.shape
        h = xs.new_zeros(b, wh.shape[0]) if h0 is None else h0
        gi = (xs @ wi + bi).unbind(1)
        ys = [None] * t
        for i in (reversed(range(t)) if reverse else range(t)):
            h = gru_cell(gi[i], h, wh, bh)
            ys[i] = h
        return torch.stack(ys, 1), h

    g = torch.Generator().manual_seed(0)
    d = 16
    for in_dim, h0 in ((d + 3, None), (2 * d, torch.randn(3, d, generator=g))):
        args = [torch.randn(in_dim, 3 * d, generator=g),
                torch.randn(d, 3 * d, generator=g) / 4,
                torch.randn(3 * d, generator=g), torch.randn(3 * d, generator=g),
                torch.randn(3, 40, in_dim, generator=g)]
        want = before(*args, h0)
        got = gru_scan(*args, h0=h0, reverse=reverse)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
