"""The vocoder's training flow of the port on the CPU, at a tiny size
(tests/torch_parity.py::voc_store, VOC_TINY's widths):

  - ``python -m etts_torch.train_wavernn``: its losses step by step
    against etts' train step (scripts/train_wavernn.py's split, filter,
    generators and collate) from the same initial weights, 1e-4 relative;
    a run cut at 2 steps and resumed to 4 against one run of 4: the
    step-2 checkpoints equal bit for bit, the resumed run restores it and
    takes the permutation stream's utterances (its crops restart, by
    etts' design); ``--gta`` trains only on the ids that have GTA mels;
  - ``python -m etts_torch.make_gta`` on an AR checkpoint of the port
    against etts' scripts/make_gta.py pipeline on the same weights, the
    prenet's dropout keeping every unit on both sides: both layouts'
    files within 1e-5 (the vocoder's [0, 1]; the TTS layout's [-4, 4]
    within 8e-5, the same bar);
  - ``python -m etts_torch.gen_wavernn`` and ``VocoderSynthesizer`` on the
    trained session and on its flat export, which carries the trained
    BatchNorm statistics;
  - each new entry point pins float32 and refuses the card's device
    without a card."""
import contextlib
import io
import pickle
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from etts.data import dataset as jdata
from etts.models import layers as jl
from etts.train import TrainState as JState
from etts.train import (make_autoregressive_val_step, make_optimizer,
                        make_wavernn_train_step)
from etts.utils.config import ConfigManager as JConfigManager
from etts_torch import gen_wavernn, make_gta, preprocess_wavernn
from etts_torch import train_wavernn
from etts_torch.api import VocoderSynthesizer
from etts_torch.convert import export_flat
from etts_torch.data.audio_io import load_wav
from etts_torch.models import layers as tl
from etts_torch.models.init import init_flax
from etts_torch.utils.config import ConfigManager, build_vocoder
from etts_torch.utils.logging import read_scalars
from torch_parity import r1_session, unflatten, voc_store


class Recorded(train_wavernn.VocoderDataset):
    """The driver's dataset, recording the ids it reads in ``log``
    (``None`` for every dataset but the first made, the training set)."""
    log = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.own = [] if Recorded.log is None else None
        if Recorded.log is None:
            Recorded.log = self.own

    def __getitem__(self, index):
        if self.own is not None:
            self.own.append(self.metadata[index])
        return super().__getitem__(index)


def run(d, store, session, steps, *extra):
    """``train_wavernn`` on the CPU; (its stdout, the ids its training set
    read, in order)."""
    Recorded.log = None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_wavernn.main(["--config", str(d), "--data", str(store),
                            "--device", "cpu", "--session_name", session,
                            "--max_steps", str(steps), *extra])
    return buf.getvalue(), Recorded.log


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(train_wavernn, "VocoderDataset", Recorded)


def test_train_wavernn_follows_etts(tmp_path, recorded):
    """4 steps: each logged loss within 1e-4 relative of etts' step on
    etts' batches (scripts/train_wavernn.py:54-121) from the port's
    initial weights; the driver's files."""
    store = voc_store(tmp_path)
    run(tmp_path, store, "s", 4)
    cm = ConfigManager(tmp_path, "wavernn", "s")
    got = read_scalars(cm.log_dir)
    jcm = JConfigManager(str(tmp_path), "wavernn", "s")
    c = jcm.config
    jm = jcm.get_model(ignore_hash=True)
    model = build_vocoder(c)
    init_flax(model, torch.Generator().manual_seed(train_wavernn.INIT_SEED))
    tx = make_optimizer([[0, c["learning_rate_tts_schedule"][0][1]]])
    state = JState.create(unflatten(export_flat(model)), tx)
    step = make_wavernn_train_step(jm, tx)
    index = pickle.load(open(store / "dataset.pkl", "rb"))
    ids = [x[0] for x in index if x[1] > 5 + 4 * 2 + 3]
    random.seed(1234)
    random.shuffle(ids)
    train = jdata.VocoderDataset(ids[:-2], str(store))
    perm, crop = np.random.default_rng(1234), np.random.default_rng(4321)
    batches = []
    while len(batches) < 4:
        order = perm.permutation(len(train))
        for i in range(0, len(order) - 3, 4):
            batches.append(jdata.collate_vocoder(
                [train[j] for j in order[i:i + 4]], 50, 10, 2, mode="MOL",
                rng=crop))
    for i, b in enumerate(batches[:4]):
        state, met = step(state, b, jax.random.PRNGKey(i))
        assert got["train/loss"][i] == pytest.approx(float(met["loss"]),
                                                     rel=1e-4), i
    assert len(set(got["train/loss"].values())) == 4
    assert set(got["meta/target_samples"].values()) == {200.0}
    assert sorted(got["time/step_ms"]) == [0, 1, 2, 3]
    assert sorted(p.name for p in cm.log_dir.glob("gen_*.wav")) == [
        "gen_2_0.wav", "gen_4_0.wav"]
    assert sorted(p.name for p in cm.weights_dir.glob("ckpt-*.pt")) == [
        "ckpt-2.pt", "ckpt-4.pt"]


def test_train_wavernn_resume(tmp_path, recorded):
    """One run of 4 steps against a run of 2 resumed to 4 (8 training
    utterances, 2 batches an epoch: the resume starts an epoch)."""
    store = voc_store(tmp_path)
    _, one = run(tmp_path, store, "one", 4)
    _, first = run(tmp_path, store, "two", 2)
    out, resumed = run(tmp_path, store, "two", 4)
    assert "restored vocoder weights at step 2" in out
    a, b = (torch.load(ConfigManager(tmp_path, "wavernn", s).weights_dir
                       / "ckpt-2.pt", weights_only=True)
            for s in ("one", "two"))
    assert a["step"] == b["step"] == 2
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    flat = lambda o: [t for s in o["state"].values() for t in s.values()]
    assert all(torch.equal(x, y) for x, y in zip(flat(a["optimizer"]),
                                                 flat(b["optimizer"])))
    # the utterances of steps 2 and 3 (the recordings run on into the
    # prefetched batches)
    assert first[:8] == one[:8] and resumed[:8] == one[8:16]
    assert sorted(one[8:16]) == sorted(one[:8])   # one epoch each
    two = read_scalars(ConfigManager(tmp_path, "wavernn", "two").log_dir)
    assert sorted(two["train/loss"]) == [0, 1, 2, 3]
    # a session's earlier checkpoint served by step
    voc = VocoderSynthesizer(tmp_path, device="cpu", session_name="one",
                             checkpoint=2)
    for k, v in voc.model.state_dict().items():
        assert torch.equal(v, a["model"][k]), k


def test_train_wavernn_gta_keeps_ids_with_gta_mels(tmp_path, recorded):
    store = voc_store(tmp_path)
    (store / "gta").mkdir()
    index = pickle.load(open(store / "dataset.pkl", "rb"))
    have = [i for i, _ in index][:7]
    for i in have:
        shutil.copy(store / "mel" / f"{i}.npy", store / "gta" / f"{i}.npy")
    out, seen = run(tmp_path, store, "g", 1, "--gta")
    assert "gta: skipping 3 ids without GTA mels" in out
    assert seen and set(seen) <= set(have)


@pytest.fixture
def keep_all_dropout(monkeypatch):
    monkeypatch.setattr(jl, "variable_rate_dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tl, "variable_rate_dropout",
                        lambda x, rate, generator=None: x)


def etts_gta(d):
    """scripts/make_gta.py:44-99 on the port's checkpoint, the speaker
    embeddings loaded: {id: (t, n_mels) in [-4, 4]}, an id of both splits
    kept as the later split writes it."""
    jcm = JConfigManager(str(d), "autoregressive", "s")
    c = jcm.config
    model, _, sched = ConfigManager(d, "autoregressive", "s").load_model()
    v = unflatten(export_flat(model))
    state = JState(v["params"], None, v.get("batch_stats", {}), 0)
    val_step = make_autoregressive_val_step(jcm.get_model(ignore_hash=True))
    prepper = jdata.DataPrepper(
        c, jcm.get_text_pipeline(backend="grapheme").tokenizer)
    out = {}
    for split in ("train_metafile.txt", "test_metafile.txt"):
        samples, _ = jdata.load_files(jcm.train_datadir / split,
                                      jcm.train_datadir / "mels",
                                      jcm.train_datadir / "spk_embeds")
        ids = iter(s[2].rsplit("/", 1)[-1][:-4] for s in samples)
        ds = jdata.Dataset(samples, prepper, 16, shuffle=False,
                           drop_remainder=False, mel_channels=12)
        for batch in ds.all_batches():
            res = val_step(state, batch, jax.random.PRNGKey(0),
                           r=sched["reduction_factor"])
            pred = np.asarray(res["final_output"])
            for b in range(pred.shape[0]):
                n = int((np.abs(np.asarray(batch[0][b])).sum(-1) != 0)
                        .sum()) - 2
                out[next(ids)] = pred[b, :n]
    return out


def test_make_gta_matches_etts(tmp_path, keep_all_dropout):
    r1_session(tmp_path)
    make_gta.main(["--config", str(tmp_path), "--device", "cpu",
                   "--session_name", "s", "--voc_data",
                   str(tmp_path / "voc"), "--tts_out", str(tmp_path / "tts")])
    want = etts_gta(tmp_path)
    # 12 training and 3 test utterances, the test split's ids also
    # training ids: its files written last, on both sides
    gta = sorted((tmp_path / "voc" / "gta").glob("*.npy"))
    assert len(gta) == len(want) == 12
    for p in gta:
        w = want[p.stem]
        got = np.load(p)
        assert got.dtype == np.float32 and got.shape == w.T.shape
        np.testing.assert_allclose(got, (w.T + 4.0) / 8.0, atol=1e-5,
                                   err_msg=p.stem)
        np.testing.assert_allclose(np.load(tmp_path / "tts" / p.name), w,
                                   atol=8e-5, err_msg=p.stem)
        mel = np.load(tmp_path / "corpus" / "mels" / p.name)
        assert got.shape[1] == mel.shape[0]


def test_trained_session_serves(tmp_path):
    """gen_wavernn --data and --file on the trained session; the session
    and its flat export through VocoderSynthesizer: the export carries
    the moved BatchNorm statistics, and both vocode the same wav."""
    store = voc_store(tmp_path)
    run(tmp_path, store, "s", 2)
    out = tmp_path / "out"
    for args in (["--data", str(store), "--samples", "2"],
                 ["--file", str(store / "mel" / "w03.npy"),
                  "--unbatched"]):
        gen_wavernn.main(["--config", str(tmp_path), "--session_name", "s",
                          "--out_dir", str(out), "--device", "cpu", *args])
    index = dict(pickle.load(open(store / "dataset.pkl", "rb")))
    for name, frames in (("w09_batched", index["w09"]),
                         ("w10_batched", index["w10"]),
                         ("w03_unbatched", index["w03"])):
        wav, sr = load_wav(out / f"{name}.wav")
        assert sr == 16000 and wav.shape == ((frames - 1) * 10,)
    voc = VocoderSynthesizer(tmp_path, device="cpu", session_name="s")
    flat = export_flat(voc.model)
    stats = {k: v for k, v in flat.items() if k.startswith("batch_stats:")}
    assert len(stats) == 2 * 5 and not any(
        np.array_equal(v, np.zeros_like(v)) or np.array_equal(
            v, np.ones_like(v)) for v in stats.values())
    npz = tmp_path / "voc.npz"
    np.savez(npz, **flat)
    mel = np.load(store / "mel" / "w03.npy").T
    a = voc.generate(mel, seed=3)
    b = VocoderSynthesizer(tmp_path, npz, "cpu").generate(mel, seed=3)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0


@pytest.mark.parametrize("name", ["preprocess_wavernn", "train_wavernn",
                                  "gen_wavernn", "make_gta"])
def test_entry_points_pin_float32_and_need_a_card(name, tmp_path):
    main = {"preprocess_wavernn": preprocess_wavernn.main,
            "train_wavernn": train_wavernn.main,
            "gen_wavernn": gen_wavernn.main, "make_gta": make_gta.main}[name]
    argv = {"preprocess_wavernn": ["--wav_dir", "w", "--out_dir", "o"],
            "train_wavernn": ["--data", "s"],
            "gen_wavernn": ["--data", "s"],
            "make_gta": ["--voc_data", "v"]}[name]
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the refusal cannot show")
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--config", str(tmp_path), *argv])
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
