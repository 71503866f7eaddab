"""GST-Tacotron's training flow of the port on the CPU, at a tiny size:
seeded wavs through ``build_tacotron_dataset``, then ``python -m
etts_torch.train_tacotron`` at TACO_TINY's widths (batch 2, r = 2):

  - its logged losses, step by step, against ``make_tacotron_train_step``
    (held against etts' step in test_torch_tacotron_train.py) on the
    batches etts' driver builds (`scripts/train_tacotron.py:58-85`, its
    keithito ids and zero padding to a multiple of r, from one
    ``default_rng(42)`` permutation stream) with the driver's optimizer
    (held against etts' there too) and ``fold_in(42, step)``'s uniforms:
    equal, bit for bit on the CPU; the scalars, checkpoints and
    alignments it writes, at its cadence, the newest 5 checkpoints kept;
  - a run cut at 4 steps and resumed to 6 (an epoch of 3 batches: the
    resume replays an epoch and skips a batch) against one run of 6: the
    checkpoints equal bit for bit;
  - the loss guard; the entry point's float32 and its refusal of the
    card without one;
  - a step-2 checkpoint exported (``export_flat``, with its moved
    BatchNorm statistics) and served through ``TacotronSynthesizer``."""
import contextlib
import io

import numpy as np
import pytest
import torch
import yaml

from etts.text import text_to_sequence as j_text_to_sequence
from etts_torch import train_tacotron
from etts_torch.api import TacotronSynthesizer
from etts_torch.convert import export_flat
from etts_torch.data.taco_audio import taco_linear_and_mel
from etts_torch.models.init import init_flax
from etts_torch.train.steps import fold_in, make_tacotron_train_step
from etts_torch.utils.config import ConfigManager, build_tacotron
from etts_torch.utils.logging import read_scalars
from torch_parity import TACO_AUDIO as AUDIO
from torch_parity import TACO_TINY, taco_workspace, voc_wav


@pytest.fixture
def workspace(tmp_path):
    """``torch_parity.taco_workspace``'s config dir and store."""
    return taco_workspace(tmp_path)


def run(d, session, steps, *extra):
    """``train_tacotron`` on the CPU; its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_tacotron.main(["--config", str(d), "--device", "cpu",
                             "--session_name", session, "--max_steps",
                             str(steps), *extra])
    return buf.getvalue()


def _etts_batches(store, n_steps, batch_size=2, r=2):
    """``scripts/train_tacotron.py:58-85``'s batches, with etts' text:
    (batch, its mel frames) of the first n_steps steps."""
    rows = [ln.strip().split("|") for ln in open(store / "train.txt")]
    rng = np.random.default_rng(42)
    out = []
    while len(out) < n_steps:
        order = rng.permutation(len(rows))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            group = [rows[j] for j in order[i:i + batch_size]]
            texts = [np.asarray(j_text_to_sequence(g[3],
                                                   ["english_cleaners"]),
                                np.int32) for g in group]
            mels = [np.load(store / g[1]) for g in group]
            lins = [np.load(store / g[0]) for g in group]
            mlen = -(-max(m.shape[0] for m in mels) // r) * r
            inputs = np.zeros((batch_size, max(map(len, texts))), np.int32)
            mel_t = np.zeros((batch_size, mlen, mels[0].shape[1]),
                             np.float32)
            lin_t = np.zeros((batch_size, mlen, lins[0].shape[1]),
                             np.float32)
            for k, (t_, m_, l_) in enumerate(zip(texts, mels, lins)):
                inputs[k, :len(t_)] = t_
                mel_t[k, :len(m_)] = m_
                lin_t[k, :len(l_)] = l_
            out.append(((inputs, np.array([len(t) for t in texts],
                                          np.int32), mel_t, lin_t),
                        sum(len(m) for m in mels)))
    return out[:n_steps]


def test_train_tacotron_follows_its_step(workspace):
    """4 steps: each logged loss and its parts equal to the step's on etts'
    batches; the scalars, checkpoints (steps 2 and 4) and alignments
    (steps 1 and 3, (decoder steps, ids) of the batch's first row)."""
    out = run(workspace, "s", 4)
    cm = ConfigManager(workspace, "tacotron", "s")
    got = read_scalars(cm.log_dir)
    config = cm.config
    model = build_tacotron(config)
    init_flax(model, torch.Generator().manual_seed(train_tacotron.INIT_SEED))
    state = train_tacotron.train_state(model, config)
    step = make_tacotron_train_step(model)
    batches = _etts_batches(cm.train_datadir, 4)
    for k, (b, frames) in enumerate(batches):
        met = step(state, train_tacotron.to_device(b, "cpu"), fold_in(42, k))
        for tag in ("loss", "mel_loss", "linear_loss", "ref_enc_loss"):
            assert got[f"train/{tag}"][k] == float(met[tag]), (k, tag)
        assert got["meta/target_frames"][k] == frames
        if k % 2:
            align = np.load(cm.log_dir / f"train_alignment_{k}.npy")
            np.testing.assert_array_equal(
                align, met["alignments"][0].numpy())
            assert align.shape == (b[2].shape[1] // 2, b[0].shape[1])
    assert sorted(got["time/step_ms"]) == [0, 1, 2, 3]
    assert len(set(got["train/loss"].values())) == 4
    assert sorted(p.name for p in cm.weights_dir.glob("ckpt-*.pt")) == [
        "ckpt-2.pt", "ckpt-4.pt"]
    assert sorted(p.name for p in cm.log_dir.glob("*.npy")) == [
        "train_alignment_1.npy", "train_alignment_3.npy"]
    assert "step 3: loss" in out and "Done." in out
    assert (cm.base_dir / "tacotron_config.yaml").exists()


def test_train_tacotron_resume_and_checkpoints_kept(workspace):
    """A checkpoint every step: one run of 6 steps keeps the newest 5; a
    run of 4 resumed to 6 (an epoch of 3 batches: the resume replays one
    epoch's permutation and skips a batch of the next) ends bit-equal to
    it."""
    cfg = workspace / "tacotron_config.yaml"
    cfg.write_text(yaml.safe_dump(dict(yaml.safe_load(cfg.read_text()),
                                       checkpoint_interval=1)))
    run(workspace, "one", 6)
    assert "restored" not in run(workspace, "cut", 4)
    assert "restored weights at step 4" in run(workspace, "cut", 6)
    one, cut = (ConfigManager(workspace, "tacotron", s) for s in ("one",
                                                                  "cut"))
    assert sorted(p.name for p in one.weights_dir.glob("ckpt-*.pt")) == [
        f"ckpt-{i}.pt" for i in range(2, 7)]
    a, b = (torch.load(cm.weights_dir / "ckpt-6.pt", weights_only=True)
            for cm in (one, cut))
    assert a["step"] == b["step"] == 6
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    opt = lambda o: [t for s in o["state"].values() for t in s.values()]
    for x, y in zip(opt(a["optimizer"]), opt(b["optimizer"]), strict=True):
        assert torch.equal(x, y)
    assert (read_scalars(one.log_dir)["train/loss"]
            == read_scalars(cut.log_dir)["train/loss"])


def test_train_tacotron_loss_guard(workspace, monkeypatch):
    """A loss above the limit, or not a number, raises at its sync."""
    monkeypatch.setattr(train_tacotron, "LOSS_LIMIT", 0.0)
    with pytest.raises(RuntimeError, match="Loss exploded .* at step 0"):
        run(workspace, "g", 2)
    with pytest.raises(RuntimeError, match="nan at step 3"):
        train_tacotron._guard(float("nan"), 3)


def test_entry_point_pins_float32_and_needs_a_card(workspace):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    run(workspace, "p", 1)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_tacotron.main(["--config", str(workspace), "--max_steps",
                                 "1"])


def test_trained_session_serves(workspace):
    """The step-2 checkpoint through ``ConfigManager.load_model`` and its
    flat export (moved BatchNorm statistics) through
    ``TacotronSynthesizer``: text and a reference mel -> a finite wav."""
    run(workspace, "srv", 2)
    cm = ConfigManager(workspace, "tacotron", "srv")
    with contextlib.redirect_stdout(io.StringIO()):
        model, step, _ = cm.load_model()
    assert step == 2
    flat = export_flat(model)
    stats = {k: v for k, v in flat.items() if k.startswith("batch_stats")}
    assert stats and all(not (np.all(v == 0) or np.all(v == 1))
                         for v in stats.values())
    synth = TacotronSynthesizer(workspace, flat, "cpu")
    ref = taco_linear_and_mel(voc_wav(np.random.default_rng(3), 300),
                              synth.config)[1]
    wav, align = synth.synthesize("Hello there.", ref.numpy())
    assert np.isfinite(wav).all() and wav.shape == (
        (TACO_TINY["max_iters"] * 2 - 1) * AUDIO["hop_length"],)
    assert align.shape == (TACO_TINY["max_iters"], len(
        synth.encode_text("Hello there.")))
