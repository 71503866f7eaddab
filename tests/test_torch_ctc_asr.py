"""The port's char-CTC transcriber against etts' flax one, at n_mels 24,
hidden 16 on three tone utterances (``tests/test_ctc_asr.py``'s
``_synth``): the log-mel frontend, the logits from etts' parameters, the
per-sequence CTC loss against ``optax.ctc_loss``, every gradient against
``jax.grad``'s, the text codec, and checkpoints moving both ways; a
registered checkpoint that cannot be loaded makes ``transcribe`` raise."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etts.evalsuite import ctc_asr as jctc
from etts_torch.evalsuite import ctc_asr as tctc

twer = importlib.import_module("etts_torch.evalsuite.wer")
SR = 8000
TONES = {"ba": 220.0, "do": 440.0, "gi": 880.0}
N_MELS, HIDDEN = 24, 16
TEXTS = ["ba do gi", "gi ba", "do do ba"]


def _synth(text, rng):
    segs = []
    for w in text.split():
        t = np.arange(int(SR * 0.25)) / SR
        segs.append(0.5 * np.sin(2 * np.pi * TONES[w] * t)
                    * np.hanning(len(t)))
        segs.append(np.zeros(int(SR * 0.06)))
    wav = np.concatenate(segs)
    return (wav + 0.005 * rng.standard_normal(len(wav))).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    return [(_synth(t, rng), t) for t in TEXTS]


@pytest.fixture(scope="module")
def batch(pairs):
    """The port's batch (mels, logit lengths, labels, label lengths) and
    etts' padded arrays built from it as its trainer builds them."""
    x, out_lens, y, lengths = tctc.prepare_batch(pairs, SR, N_MELS, "cpu")
    t_out = -(-x.shape[1] // 4)
    lpad = (np.arange(t_out)[None] >= out_lens.numpy()[:, None]).astype(
        np.float32)
    ypad = (np.arange(y.shape[1])[None] >= lengths.numpy()[:, None]).astype(
        np.float32)
    return (x, out_lens, y, lengths), (x.numpy(), lpad, y.numpy(), ypad)


@pytest.fixture(scope="module")
def params(batch):
    """etts' init of its model, the output bias of the blank lowered so
    that the greedy transcripts are not empty."""
    jm = jctc.CTCAsrModel(n_mels=N_MELS, hidden=HIDDEN)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch[1][0]))
    flat = {k: np.asarray(v) for k, v in jctc._flatten(p["params"]).items()}
    flat["out/bias"] = flat["out/bias"].copy()
    flat["out/bias"][0] -= 3.0
    return jm, flat


def _port(flat):
    return tctc.CTCAsrModel(n_mels=N_MELS, hidden=HIDDEN).load_flat(flat)


def test_log_mel_matches_etts(pairs):
    for wav, _ in pairs:
        bucket = 1 << max(12, int(len(wav) - 1).bit_length())
        real = tctc.n_frames(len(wav), 512, SR // 100)
        padded = np.pad(wav, (0, bucket - len(wav)))
        want = np.asarray(jctc._log_mel(padded, SR, N_MELS,
                                        stat_frames=real))
        got = tctc._log_mel(torch.from_numpy(padded), SR, N_MELS,
                            stat_frames=real).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_logits_from_etts_parameters(batch, params):
    jm, flat = params
    x = batch[1][0]
    want = np.asarray(jm.apply({"params": jctc._unflatten(flat)},
                               jnp.asarray(x)))
    got = _port(flat)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, -(-x.shape[1] // 4),
                                       len(tctc.CTC_VOCAB))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ctc_loss_matches_optax(batch, params):
    """Per sequence, on the same logits, within 1e-5 relative; the loss the
    trainer takes is their mean."""
    jm, flat = params
    (x, out_lens, y, lengths), (xj, lpad, yj, ypad) = batch
    logits = np.asarray(jm.apply({"params": jctc._unflatten(flat)},
                                 jnp.asarray(xj)))
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), lpad, yj, ypad))
    lp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    got = torch.nn.functional.ctc_loss(lp, y, out_lens, lengths,
                                       reduction="none").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    model = _port(flat)
    assert float(tctc.ctc_loss(model, *batch[0]).detach()) == pytest.approx(
        float(want.mean()), rel=1e-5)


def test_gradients_match_jax(batch, params):
    jm, flat = params
    xj, lpad, yj, ypad = batch[1]

    def loss_fn(p):
        return jnp.mean(optax.ctc_loss(jm.apply({"params": p},
                                                jnp.asarray(xj)),
                                       lpad, yj, ypad))
    want = jctc._flatten(jax.grad(loss_fn)(jctc._unflatten(flat)))
    model = _port(flat)
    tctc.ctc_loss(model, *batch[0]).backward()
    grads = tctc.CTCAsrModel(n_mels=N_MELS, hidden=HIDDEN)
    grads.load_state_dict({n: p.grad for n, p in model.named_parameters()})
    got = grads.flat()
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("text", ["Hello, world!", "ba DO  gi's", "42 x"])
def test_encode_text_matches_etts(text):
    np.testing.assert_array_equal(tctc.encode_text(text),
                                  jctc.encode_text(text))


def test_greedy_decode_matches_etts():
    logits = np.random.default_rng(3).normal(size=(40, len(tctc.CTC_VOCAB)))
    logits[::3, 0] += 3.0
    assert tctc.greedy_decode(logits) == jctc.greedy_decode(logits)
    assert tctc.CTC_VOCAB == jctc.CTC_VOCAB


def test_checkpoints_move_both_ways(tmp_path, pairs, params):
    """An etts-saved npz loads in the port and transcribes to etts'
    strings; the port's save loads in etts with the same parameters."""
    jm, flat = params
    path = str(tmp_path / "etts.npz")
    jctc.save_ckpt(path, {"params": jctc._unflatten(flat)}, SR, N_MELS,
                   HIDDEN)
    jt, tt = jctc.CTCTranscriber(path), tctc.CTCTranscriber(path, "cpu")
    for wav, _ in pairs:
        want = jt.transcribe_wav(wav, SR)
        assert want and tt.transcribe_wav(wav, SR) == want
    back = str(tmp_path / "port.npz")
    tctc.save_ckpt(back, tt.model, SR)
    a, b = np.load(path), np.load(back)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jb = jctc.CTCTranscriber(back)
    assert [jb.transcribe_wav(w, SR) for w, _ in pairs] == [
        jt.transcribe_wav(w, SR) for w, _ in pairs]


def test_training_lowers_the_loss(pairs):
    model, loss = tctc.train_ctc_asr(pairs, SR, steps=1, n_mels=N_MELS,
                                     hidden=HIDDEN, device="cpu")
    _, later = tctc.train_ctc_asr(pairs, SR, steps=25, n_mels=N_MELS,
                                  hidden=HIDDEN, device="cpu")
    assert np.isfinite(loss) and later < loss


def test_a_checkpoint_that_fails_raises(tmp_path, pairs, params,
                                        monkeypatch):
    """A registered checkpoint that cannot be loaded raises in
    ``transcribe``, where etts leaves the WER column empty; so does a
    registered path that does not exist."""
    from etts_torch.data.audio_io import save_wav
    monkeypatch.setitem(twer._W2V2, "found", None)
    wav_path = tmp_path / "utt.wav"
    save_wav(pairs[0][0], str(wav_path), SR)
    _, flat = params
    bad = dict(flat)
    bad.pop("out/bias")
    np.savez(tmp_path / "bad.npz", __sr__=SR, __n_mels__=N_MELS,
             __hidden__=HIDDEN, **bad)
    for path in (tmp_path / "bad.npz", tmp_path / "missing.npz"):
        tctc.set_default_model(str(path), device="cpu")
        try:
            with pytest.raises((KeyError, FileNotFoundError)):
                twer.transcribe(str(wav_path))
        finally:
            tctc.set_default_model(None)
