"""AutoregressiveTransformer inference of the port against flax, float32:
encode for all four system types, decode_step, and autoregressive_predict
with its stop rules. Tolerance 1e-4 (float32 reduction order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.autoregressive import (AutoregressiveTransformer as JM,
                                        autoregressive_predict as jpredict)
from etts_torch.models.autoregressive import (
    AutoregressiveTransformer as TM, autoregressive_predict as tpredict)
from etts_torch.convert import load_into
from torch_parity import SPK_DIM, ar_pair, flatten, t

ATOL = 1e-4
SYSTEMS = ["text", "style_text", "speaker_text", "speaker_style_text"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 40, (2, 9)).astype(np.int32)
    ids[1, 6:] = 0                                # padded second row
    ref = (rng.standard_normal((2, 17, 12)) * 0.5).astype(np.float32)
    spk = rng.standard_normal((2, 1, SPK_DIM)).astype(np.float32)
    return ids, ref, spk


@pytest.mark.parametrize("system_type", SYSTEMS)
def test_encode(system_type):
    jm, v, tm = ar_pair(system_type)
    ids, ref, spk = _inputs()
    ref = ref if jm.has_style else None
    spk = spk if jm.has_speaker else None
    want, want_mask, *_ = jm.apply(
        v, jnp.asarray(ids), None if ref is None else jnp.asarray(ref),
        None if spk is None else jnp.asarray(spk), method=JM.encode)
    with torch.no_grad():
        got, mask = tm.encode(t(ids).long(), None if ref is None else t(ref),
                              None if spk is None else t(spk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_encode_ref():
    mel = np.arange(30 * 4, dtype=np.float32).reshape(30, 4)
    want = np.asarray(JM.encode_ref(jnp.asarray(mel), 3))
    got = TM.encode_ref(t(mel), 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 3])
def test_decode_step(r):
    """Three incremental steps with KV caches; mel_linear and the last
    block's cross-attention match."""
    jm, v, tm = ar_pair("style_text")
    ids, ref, _ = _inputs(1)
    enc, mask, *_ = jm.apply(v, jnp.asarray(ids), jnp.asarray(ref),
                             method=JM.encode)
    from etts.models.autoregressive import (_cross_attention_kv,
                                            _decoder_cache_spec)
    caches = _decoder_cache_spec(jm, 2, 4)
    for entry, (ck, cv) in zip(caches, _cross_attention_kv(jm, v, enc)):
        entry["ck"], entry["cv"] = ck, cv
    with torch.no_grad():
        tenc, tmask = tm.encode(t(ids).long(), t(ref))
        tcaches = tm.init_caches(tenc, 4)
    frames = np.random.default_rng(2).standard_normal((3, 2, 1, 12)) * 0.3
    for i in range(3):
        f = frames[i].astype(np.float32)
        mel, caches, attn = jm.apply(
            v, jnp.asarray(f), enc, mask, caches, i, r, 0.0, 0, True,
            method=JM.decode_step, rngs={"prenet": jax.random.PRNGKey(i)})
        with torch.no_grad():
            tmel, tattn = tm.decode_step(t(f), tenc, tmask, tcaches, i, r,
                                         prenet_dropout=0.0)
        np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=ATOL)
        np.testing.assert_allclose(tattn.numpy(), np.asarray(attn),
                                   atol=ATOL)


def _predict_both(jm, v, tm, ids, r, steps, **kw):
    want = jpredict(jm, v, jnp.asarray(ids), r=r, max_length=steps * r - 1,
                    prenet_dropout=0.0, **kw)
    got = tpredict(tm, t(ids).long(), r=r, max_length=steps * r - 1,
                   prenet_dropout=0.0, **kw)
    return want, got


@pytest.mark.parametrize("r", [1, 2])
def test_predict_free_running(r):
    """Whole decode, stop disabled: 12 steps of feedback."""
    jm, v, tm = ar_pair("text")
    ids, _, _ = _inputs(3)
    want, got = _predict_both(jm, v, tm, ids, r, 12, stop_enabled=False)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=ATOL)
    assert got["steps"] == int(want["steps"]) == 12
    np.testing.assert_array_equal(got["mel_lengths"].numpy(),
                                  np.asarray(want["mel_lengths"]))


def _forced_stop(variables, bias):
    sl = variables["params"]["Postnet"]["stop_linear"]
    sl["kernel"] = jnp.zeros_like(sl["kernel"])
    sl["bias"] = jnp.asarray(bias, jnp.float32)
    return variables


def _pair_with_stop(bias):
    jm, v, tm = ar_pair("text")
    v = _forced_stop(v, bias)
    load_into(tm, flatten(v))
    return jm, v, tm


def test_predict_stop_token():
    jm, v, tm = _pair_with_stop([0.0, 0.0, 10.0])
    ids, _, _ = _inputs(4)
    want, got = _predict_both(jm, v, tm, ids, 1, 10)
    assert got["mel_lengths"].tolist() == [1, 1]
    assert got["mel_lengths"].tolist() == np.asarray(
        want["mel_lengths"]).tolist()
    assert got["steps"] == int(want["steps"]) == 1


def test_predict_interior_stop_r2():
    """At r = 2 the stop class fires on the first frame of the group."""
    jm, v, tm = _pair_with_stop([0.0, 0.0, 10.0])
    ids, _, _ = _inputs(4)
    want, got = _predict_both(jm, v, tm, ids, 2, 6)
    assert got["mel_lengths"].tolist() == [1, 1] == np.asarray(
        want["mel_lengths"]).tolist()


def test_predict_frame_cap():
    """max_frames_per_token = 1 on 9 and 6 real tokens (r = 2): the cap
    ends each row at its own length."""
    jm, v, tm = _pair_with_stop([10.0, 0.0, -10.0])
    ids, _, _ = _inputs(5)
    want, got = _predict_both(jm, v, tm, ids, 2, 12,
                              max_frames_per_token=1.0)
    assert got["mel_lengths"].tolist() == [9, 6] == np.asarray(
        want["mel_lengths"]).tolist()
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=ATOL)


def test_predict_attn_stop_patience():
    """Two real tokens: focus >= n_real - 2 = 0 holds from step one, so
    patience 3 stops at 3 frames."""
    jm, v, tm = _pair_with_stop([10.0, 0.0, -10.0])
    ids = np.asarray([[5, 7]], np.int32)
    want, got = _predict_both(jm, v, tm, ids, 1, 10, attn_stop_patience=3)
    assert got["mel_lengths"].tolist() == [3] == np.asarray(
        want["mel_lengths"]).tolist()


def test_predict_dropout_uses_generator():
    jm, v, tm = ar_pair("text")
    ids = t(_inputs(6)[0]).long()
    a = tpredict(tm, ids, r=1, max_length=5, prenet_dropout=0.5,
                 stop_enabled=False, generator=torch.Generator().manual_seed(0))
    b = tpredict(tm, ids, r=1, max_length=5, prenet_dropout=0.5,
                 stop_enabled=False, generator=torch.Generator().manual_seed(0))
    c = tpredict(tm, ids, r=1, max_length=5, prenet_dropout=0.0,
                 stop_enabled=False)
    assert torch.equal(a["mel"], b["mel"])
    assert not torch.allclose(a["mel"], c["mel"])
