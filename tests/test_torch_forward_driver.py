"""The forward model's training flow of the port on the CPU, at a tiny
size (tests/torch_parity.py::tiny_corpus):

  - ``python -m etts_torch.extract_durations`` on an r = 1 checkpoint of
    the port's ``train_autoregressive`` against etts' extraction pipeline
    (its Dataset, validation step, string-sorted last block and
    ``get_durations_from_alignment``) on the same weights, the prenet's
    dropout keeping every unit on both sides: the triples' ids equal,
    their mels within 1e-4, their durations equal but at a rounding tie
    (shown: the normalised duration within 1e-5 of a half-integer); a
    speaker system (configs/default's) with the default flags, where
    etts' script loads no speaker embeddings and fails, so its pipeline
    is fed them here; and a text-only system with conv decoder blocks and
    every flag;
  - ``python -m etts_torch.train_forward``: its losses step by step
    against etts' train step fed etts' Dataset batches from the same
    initial weights, dropout 0 (1e-4 relative, as the AR driver's test);
    a run cut after 2 steps and resumed against one run of 4, bit for
    bit, dropout on; the trained export served by
    ``TTSSynthesizer(model_kind="forward")``."""
import contextlib
import functools
import io
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from etts.align import get_durations_from_alignment as j_durations
from etts.data import dataset as jdata
from etts.models import layers as jl
from etts.train import TrainState as JState
from etts.train import (make_autoregressive_val_step, make_forward_train_step,
                        make_optimizer)
from etts.utils.config import ConfigManager as JConfigManager
from etts_torch import train_forward
from etts_torch.align import normalized_durations
from etts_torch.api import TTSSynthesizer
from etts_torch.convert import export_flat
from etts_torch.extract_durations import main as extract
from etts_torch.extract_durations import save_triple
from etts_torch.models import layers as tl
from etts_torch.models.init import init_flax
from etts_torch.text import default_tokenizer
from etts_torch.train_autoregressive import SEED
from etts_torch.utils.config import ConfigManager, build_forward
from etts_torch.utils.logging import read_scalars
from torch_parity import FWD_SMALL, ROOT, r1_session, tiny_corpus, unflatten

TIE = 1e-5
FWD_CFG = dict(FWD_SMALL, max_frames=48, tts_batch_size=4,
               weights_save_frequency=2, prediction_frequency=2,
               metrics_sync_frequency=1, keep_n_weights=2,
               learning_rate_tts_schedule=[[0, 1e-3]])


def etts_triples(d, flags):
    """etts' extraction (scripts/extract_durations.py:44-90) on the port's
    checkpoint, the speaker embeddings loaded where the model has a
    speaker: {split: [(mel, ids, durations, normalised durations)]}."""
    jcm = JConfigManager(str(d), "autoregressive", "s")
    c = jcm.config
    model, _, _ = ConfigManager(d, "autoregressive", "s").load_model()
    v = unflatten(export_flat(model))
    state = JState(v["params"], None, v.get("batch_stats", {}), 0)
    jm = jcm.get_model(ignore_hash=True)
    val_step = make_autoregressive_val_step(jm, stop_scaling=c.get(
        "stop_loss_scaling", 1.0))
    prepper = jdata.DataPrepper(
        c, jcm.get_text_pipeline(backend="grapheme").tokenizer)
    spk = jcm.train_datadir / "spk_embeds" if model.has_speaker else None
    out = {}
    for split, metafile in (("train", "train_metafile.txt"),
                            ("val", "test_metafile.txt")):
        samples, _ = jdata.load_files(jcm.train_datadir / metafile,
                                      jcm.train_datadir / "mels", spk)
        ds = jdata.Dataset(samples, prepper, 16, shuffle=False,
                           drop_remainder=False, mel_channels=12)
        rows = out[split] = []
        for batch in ds.all_batches():
            res = val_step(state, batch, jax.random.PRNGKey(0), r=1)
            keys = sorted(res["decoder_attention"])
            att = np.asarray(res["decoder_attention"][keys[-1]])
            durs, mels, phon, _ = j_durations(
                att, batch[0], batch[1], weighted="--best" not in flags,
                binary="--binary" in flags, fix_jumps="--fix_jumps" in flags,
                fill_gaps=True,
                fill_mode="max" if "--fill_mode_max" in flags else "next")
            pred = np.asarray(res["final_output"])
            mel_lens, phon_lens = row_lengths(batch)
            for i in range(len(durs)):
                mel = (mels[i] if "--use_GT" in flags
                       else pred[i, :mels[i].shape[0]])
                rows.append((mel, phon[i], durs[i], normalized_durations(
                    att[i], mel_lens[i], phon_lens[i],
                    "--best" not in flags)))
        out["keys"] = keys
    return out


def row_lengths(batch):
    mel, phon = np.asarray(batch[0]), np.asarray(batch[1])
    return ((np.abs(mel).sum(-1) != 0).sum(-1).tolist(),
            (phon != 0).sum(-1).tolist())


@pytest.mark.parametrize("system, over, flags", [
    ("speaker_style_text", {}, []),
    ("text", {"decoder_dense_blocks": 1},
     ["--best", "--binary", "--fix_jumps", "--fill_mode_max", "--use_GT"])],
    ids=["speaker-default", "text-conv-every-flag"])
def test_extract_durations_matches_etts(tmp_path, monkeypatch, system, over,
                                        flags):
    monkeypatch.setattr(jl, "variable_rate_dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tl, "variable_rate_dropout",
                        lambda x, rate, generator=None: x)
    corpus = r1_session(tmp_path, system_type=system, **over)
    extract(["--config", str(tmp_path), "--device", "cpu", "--session_name",
             "s", *flags])
    want = etts_triples(tmp_path, flags)
    if over:    # etts' string sort: the dense block, not the last (conv)
        assert want["keys"] == ["Decoder_ConvBlock1_CrossAttention",
                                "Decoder_DenseBlock1_CrossAttention"]
    for split, n in (("train", 12), ("val", 3)):
        files = sorted((corpus / "forward_data" / split).glob("*.npy"))
        assert len(files) == len(want[split]) == n
        for i, (mel, ids, dur, norm) in enumerate(want[split]):
            got = np.load(files[0].parent / f"{split}_{i}.npy",
                          allow_pickle=True)
            np.testing.assert_array_equal(got[1], ids)
            np.testing.assert_allclose(got[0], mel, atol=1e-4)
            assert got[2].sum() == got[0].shape[0] == mel.shape[0]
            off = np.nonzero(got[2] != dur)[0]
            if "--binary" in flags:
                assert off.size == 0
            frac = norm[off] - np.floor(norm[off])
            assert (np.abs(frac - 0.5) <= TIE).all(), (split, i, off)


def test_extract_durations_refuses_r_above_one(tmp_path):
    r1_session(tmp_path)
    cfg_path = tmp_path / "autoregressive_config.yaml"
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["reduction_factor_schedule"] = [[0, 1], [2, 3]]
    cfg_path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="reduction factor 1"):
        extract(["--config", str(tmp_path), "--device", "cpu",
                 "--session_name", "s"])
    with pytest.raises(SystemExit):
        extract(["--config", str(tmp_path), "--device", "cpu",
                 "--fix_jumps"])


def forward_corpus(d, **over):
    """Seeded triples as extract_durations writes them, 10 for training
    (one longer than max_frames) and 3 for validation, under a tiny corpus,
    and forward_config.yaml shrunk by FWD_CFG and ``over``."""
    tiny_corpus(d, n=2)
    rng = np.random.default_rng(7)
    data = d / "corpus" / "forward_data"
    for split, n in (("train", 10), ("val", 3)):
        (data / split).mkdir(parents=True)
        for i in range(n):
            k = int(rng.integers(4, 12))
            dur = rng.integers(0, 6, k).astype(np.float64)
            t = int(dur.sum()) + (60 if (split, i) == ("train", 4) else 0)
            save_triple(data / split / f"{split}_{i}.npy",
                        (rng.uniform(-4, 4, (t, 12)).astype(np.float32),
                         rng.integers(1, 40, k).astype(np.int32), dur))
    cfg = yaml.safe_load(open(ROOT / "configs/default/forward_config.yaml"))
    cfg.update(FWD_CFG, **over)
    yaml.safe_dump(cfg, open(d / "forward_config.yaml", "w"))
    return data


def run(d, session, steps):
    train_forward.main(["--config", str(d), "--device", "cpu",
                        "--session_name", session, "--max_steps", str(steps)])
    return ConfigManager(d, "forward", session)


def test_train_forward_follows_etts(tmp_path, monkeypatch):
    """4 steps at dropout 0 on both sides (etts' build_forward has none
    but flax's 0.1: both models are built at 0 here): each logged loss,
    mel loss and duration loss within 1e-4 relative of etts' step on
    etts' batches (the overlong triple dropped by hand)."""
    data = forward_corpus(tmp_path)
    monkeypatch.setattr(train_forward, "build_forward",
                        functools.partial(build_forward, dropout_rate=0.0))
    cm = run(tmp_path, "s", 4)
    got = read_scalars(cm.log_dir)
    jcm = JConfigManager(str(tmp_path), "forward", "s")
    c = jcm.config
    model = build_forward(c, default_tokenizer(False).vocab_size, 0.0)
    init_flax(model, torch.Generator().manual_seed(SEED))
    jm = jcm.get_model(ignore_hash=True).clone(dropout_rate=0.0)
    tx = make_optimizer(c["learning_rate_tts_schedule"])
    state = JState.create(unflatten(export_flat(model)), tx)
    step = make_forward_train_step(jm, tx, max_frames=48)
    files = [f for f in sorted((data / "train").glob("*.npy"))
             if np.load(f, allow_pickle=True)[0].shape[0] <= 48]
    assert len(files) == 9
    ds = jdata.Dataset(files, jdata.ForwardDataPrepper(None), 4,
                       mel_channels=12, pad_mel_multiple=48)
    for i in range(4):
        state, met = step(state, ds.next_batch(), jax.random.PRNGKey(i))
        for k in ("loss", "mel_loss", "duration_loss"):
            assert got[f"train/{k}"][i] == pytest.approx(float(met[k]),
                                                         rel=1e-4), (k, i)
    assert len(set(got["train/loss"].values())) == 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of 4 steps and one cut at 2 and resumed to 4, dropout 0.1
    (etts' rate), the stdout of the resumed run."""
    d = tmp_path_factory.mktemp("fwd")
    forward_corpus(d)
    one = run(d, "one", 4)
    run(d, "two", 2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        two = run(d, "two", 4)
    return d, one, two, buf.getvalue()


def test_train_forward_resume_is_bit_for_bit(trained):
    """The checkpoints of step 4 (weights, BatchNorm statistics, Adam
    state, step), the losses of steps 2-3 and the validation durations of
    step 3 equal; the overlong triple dropped through the sidecar."""
    d, one, two, out = trained
    assert "restored weights at step 2" in out
    x = torch.load(one.weights_dir / "ckpt-4.pt", weights_only=True)
    y = torch.load(two.weights_dir / "ckpt-4.pt", weights_only=True)
    assert x["step"] == y["step"] == 4
    for k in x["model"]:
        assert torch.equal(x["model"][k], y["model"][k]), k
    flat = lambda o: [t for s in o["state"].values() for t in s.values()]
    assert all(torch.equal(a, b) for a, b in zip(flat(x["optimizer"]),
                                                 flat(y["optimizer"])))
    a, b = read_scalars(one.log_dir), read_scalars(two.log_dir)
    for k in ("train/loss", "train/duration_loss", "val/loss"):
        assert a[k] == b[k], k
    assert sorted(a["meta/target_frames"]) == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        np.load(one.log_dir / "val_durations_3.npy"),
        np.load(two.log_dir / "val_durations_3.npy"))
    sidecar = d / "corpus" / "forward_data" / "train" / ".frame_counts.json"
    counts = yaml.safe_load(sidecar.read_text())
    assert len(counts) == 10 and counts["train_4.npy"][1] > 48


def test_trained_forward_export_serves(trained, tmp_path):
    """The step-4 checkpoint through ConfigManager.load_model, exported to
    the flat npz and served: the mel is the model's own pass, cut to its
    regulated length."""
    d, one, _, _ = trained
    model, step, sched = one.load_model()
    assert step == 4 and sched["reduction_factor"] == 1
    npz = tmp_path / "fwd.npz"
    np.savez(npz, **export_flat(model))
    shutil.copy(d / "data_config.yaml", tmp_path)
    shutil.copy(d / "forward_config.yaml", tmp_path)
    tts = TTSSynthesizer(tmp_path, npz, "cpu", phonemizer_backend="grapheme",
                         model_kind="forward")
    mel = tts.predict("Hello there.")["mel"]
    ids = torch.from_numpy(tts.encode_text("Hello there."))[None]
    with torch.no_grad():
        out = model(ids, max_frames=48)
    n = int(out["mel_lengths"][0])
    assert 0 < mel.shape[0] == min(n, 48) and mel.shape[1] == 12
    np.testing.assert_array_equal(mel, out["mel"][0, :n].numpy())
