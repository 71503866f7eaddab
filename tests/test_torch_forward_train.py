"""The forward (duration) model's training in the port against etts on the
CPU, float32, at a tiny size (tests/torch_parity.py::FWD_TINY):

  - ``init_flax`` starts the duration predictor's output bias at one, as
    flax does, and draws every other value as before (the AR model's and
    the forward model's draws held by their fingerprints);
  - one train step against etts' ``make_forward_train_step`` (gradients
    read exactly on etts' side through ``torch_parity.capture_tx``, dropout
    0 on both sides): ``assert_step_close``'s bars (each gradient 1e-4
    relative L2, 1e-7 absolute; the BatchNorm statistics 1e-6; the metrics
    1e-5 relative);
  - the validation step against etts' (1e-5 on metrics and durations, 1e-4
    on the mel, as test_torch_forward.py);
  - ``ForwardDataPrepper`` and the 3-tuple collate against etts';
  - inference bit for bit the forward pass it was before the train mode,
    and the train mode's draws from its generator."""
import jax
import numpy as np
import pytest
import torch

from etts.data import dataset as jdata
from etts.train import TrainState as JState
from etts.train import make_forward_train_step as j_train_step
from etts.train import make_forward_val_step as j_val_step
from etts_torch.convert import export_flat
from etts_torch.data import dataset as tdata
from etts_torch.extract_durations import save_triple
from etts_torch.models.autoregressive import AutoregressiveTransformer as TM
from etts_torch.models.forward import ForwardTransformer as TF
from etts_torch.models.init import init_flax
from etts_torch.ops.expand import regulate_lengths
from etts_torch.ops.masking import encoder_padding_mask, mel_padding_mask
from etts_torch.train.steps import (make_forward_train_step,
                                    make_forward_val_step)
from etts_torch.utils.config import build_forward, load_config
from torch_parity import (AR_TINY, FWD_TINY, ROOT, SPK_DIM, assert_step_close,
                          capture_state, capture_tx, forward_train_batch,
                          forward_train_pair, to_jax, to_torch)

MAX_FRAMES = 48

# Fingerprints of init_flax(model, Generator().manual_seed(0)) taken with
# the init before the duration bias was repaired: (sum of the state
# entries, in name order, each against np.random.default_rng(its index)
# normal weights; sum of squares), float64. A changed draw moves the first
# by about 0.1; the tolerance covers only float rounding.
AR_INIT = (-23.291654151752905, 2104.75391625178)
FWD_INIT_BUT_BIAS = (-21.651474798770238, 2277.5307569244646)


def fingerprint(module, skip=()):
    s1 = s2 = 0.0
    for i, (name, x) in enumerate(sorted(module.state_dict().items())):
        if name in skip or name.endswith("num_batches_tracked"):
            continue
        a = x.detach().double().numpy().ravel()
        r = np.random.default_rng(i).standard_normal(a.size)
        s1 += float(a @ r)
        s2 += float(a @ a)
    return s1, s2


def test_init_starts_duration_bias_at_one_and_keeps_every_draw():
    fwd = init_flax(TF(**FWD_TINY), torch.Generator().manual_seed(0))
    assert fwd.dur_pred.linear.bias.tolist() == [1.0]
    assert fingerprint(fwd, ("dur_pred.linear.bias",)) == pytest.approx(
        FWD_INIT_BUT_BIAS, rel=1e-9, abs=1e-6)
    ar = init_flax(TM(system_type="speaker_style_text",
                      speaker_embed_dim=SPK_DIM, **AR_TINY),
                   torch.Generator().manual_seed(0))
    assert fingerprint(ar) == pytest.approx(AR_INIT, rel=1e-9, abs=1e-6)


def test_build_forward_keeps_etts_dropout():
    """etts' build_forward does not pass the config's dropout_rate: the
    model runs flax's default 0.1 whatever the config says."""
    cfg = dict(load_config(ROOT / "configs/default", "forward"),
               dropout_rate=0.5)
    model = build_forward(cfg, 40)
    rates = {m.dropout_rate for m in model.modules()
             if hasattr(m, "dropout_rate")}
    assert rates == {0.1}
    assert {m.dropout_rate for m in build_forward(cfg, 40, 0.0).modules()
            if hasattr(m, "dropout_rate")} == {0.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_matches_etts(seed):
    jm, v, tm = forward_train_pair(seed)
    batch = forward_train_batch(seed, max_frames=MAX_FRAMES)
    jst, jmet = j_train_step(jm, capture_tx(), max_frames=MAX_FRAMES)(
        JState.create(v, capture_tx()), to_jax(batch),
        jax.random.PRNGKey(0))
    cs = capture_state(tm)
    tmet = make_forward_train_step(tm, MAX_FRAMES)(cs, to_torch(batch), 0)
    assert sorted(tmet) == sorted(jmet) == ["duration_loss", "loss",
                                            "mel_loss"]
    assert_step_close((jst, jmet), (cs, tmet, export_flat(tm)))
    # the postnet's statistics moved (flax's momentum, batch variance)
    moved = export_flat(tm)
    assert not np.allclose(
        moved["batch_stats:['decoder_postnet']['norm_out']['mean']"],
        v["batch_stats"]["decoder_postnet"]["norm_out"]["mean"])


def test_val_step_matches_etts():
    """Dropout 0.1 on both sides: the val step runs with the train flags
    off, so it draws nothing and the statistics stay."""
    jm, v, tm = forward_train_pair(2, dropout_rate=0.1)
    batch = forward_train_batch(2, max_frames=MAX_FRAMES)
    before = export_flat(tm)
    jmet, jout = j_val_step(jm, max_frames=MAX_FRAMES)(
        JState(v["params"], None, v["batch_stats"], 0), to_jax(batch),
        jax.random.PRNGKey(0))
    tmet, tout = make_forward_val_step(tm, MAX_FRAMES)(to_torch(batch), 0)
    for k, w in jmet.items():
        np.testing.assert_allclose(float(tmet[k]), float(w), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tout["duration"].numpy(),
                               np.asarray(jout["duration"]), atol=1e-5)
    np.testing.assert_allclose(tout["mel"].numpy(), np.asarray(jout["mel"]),
                               atol=1e-4)
    after = export_flat(tm)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_forward_data_matches_etts(tmp_path):
    """Triples written as extract_durations writes them, one longer than
    max_frames: the preppers, with and without the cap, and the batches of
    a shuffled Dataset padded at max_frames (durations as the ids)."""
    rng = np.random.default_rng(4)
    files = []
    for i, t in enumerate([10, 30, 60, 17, 25, 40, 12]):
        n = int(rng.integers(3, 11))
        f = tmp_path / f"train_{i}.npy"
        save_triple(f, (rng.normal(size=(t, 12)).astype(np.float32),
                        rng.integers(1, 40, n).astype(np.int32),
                        rng.integers(0, 6, n).astype(np.float64)))
        files.append(f)
    for cap in (None, MAX_FRAMES):
        jp, tp = jdata.ForwardDataPrepper(cap), tdata.ForwardDataPrepper(cap)
        assert jp.may_drop == tp.may_drop == (cap is not None)
        for f in files:
            want, got = jp(f), tp(f)
            if want is None:
                assert got is None and cap is not None
                continue
            for a, b in zip(want, got):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    kw = dict(mel_channels=12, pad_mel_multiple=MAX_FRAMES)
    jd = jdata.Dataset(files, jdata.ForwardDataPrepper(MAX_FRAMES), 2, **kw)
    td = tdata.Dataset(files, tdata.ForwardDataPrepper(MAX_FRAMES), 2, **kw)
    for _ in range(7):
        want, got = jd.next_batch(), td.next_batch()
        assert len(got) == 3 and got[0].shape[1] == MAX_FRAMES
        assert got[2].shape == got[1].shape
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def _forward_before(tm, ids, tgt, max_frames):
    """The inference pass as the port ran it before the train mode: the
    same modules called with their defaults."""
    padding_mask = encoder_padding_mask(ids)
    h, _ = tm.encoder(tm.embedding(ids), padding_mask)
    durations = tm.dur_pred(h)
    durations = (1.0 - padding_mask[:, 0, 0, :, None]) * durations
    used = tgt if tgt is not None else durations
    mels, _ = regulate_lengths(h, used[..., 0], max_frames)
    mels = tm.decoder_prenet(mels, 0.0, None)
    mels, _ = tm.decoder(mels, mel_padding_mask(mels))
    return tm.decoder_postnet(tm.out(mels)), durations


@pytest.mark.parametrize("targets", [False, True],
                         ids=["predicted", "target"])
def test_inference_unchanged_and_train_mode_draws(targets):
    _, _, tm = forward_train_pair(3, dropout_rate=0.1)
    mel, ids, dur = forward_train_batch(3, max_frames=MAX_FRAMES)
    ids = torch.from_numpy(ids).long()
    tgt = torch.from_numpy(dur)[..., None] if targets else None
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    with torch.no_grad():
        want_mel, want_dur = _forward_before(tm, ids, tgt, MAX_FRAMES)
        got = tm(ids, tgt, max_frames=MAX_FRAMES, drop_n_heads=1,
                 generator=g)
    assert torch.equal(g.get_state(), state)       # no draw
    assert torch.equal(got["mel"], want_mel)
    assert torch.equal(got["duration"], want_dur)
    # train mode: dropout and head drop from the generator, reproducible
    stats = export_flat(tm)
    runs = []
    for seed in (5, 5, 6):
        with torch.no_grad():
            runs.append(tm(ids, tgt, max_frames=MAX_FRAMES, train=True,
                           drop_n_heads=1,
                           generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(runs[0]["mel"], runs[1]["mel"])
    assert not torch.equal(runs[0]["mel"], runs[2]["mel"])
    assert not torch.equal(runs[0]["mel"], got["mel"])
    moved = export_flat(tm)
    key = "batch_stats:['decoder_postnet']['norm_0']['var']"
    assert not np.array_equal(stats[key], moved[key])
