"""Streamed synthesis of the port (``etts_torch/streaming.py``) on the CPU at
a tiny size, mirroring tests/test_streaming.py: the chunked decode against
the port's ``autoregressive_predict`` (bit for bit) and ``stream_mel``
against etts' (1e-4, float32 reduction order); the chunked vocode against
``generate(batched=False)`` (1e-5) and its conditioning against etts'
``upsample_cond`` (1e-5 relative); the sample loop's draws across chunks
(bit for bit); ``TTSSynthesizer.stream`` end to end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.wavernn import WaveRNN as JW
from etts.streaming import stream_mel as jstream_mel
from etts_torch import streaming
from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
from etts_torch.convert import load_into
from etts_torch.models.autoregressive import (autoregressive_predict,
                                              make_chunk_decoder,
                                              streaming_decode_init)
from etts_torch.models.wavernn import _finalize, generate
from etts_torch.ops.kernels.wavernn_cell import wavernn_sample_loop
from torch_parity import ar_pair, flatten, small_workspace, t, voc_pair

IDS = np.asarray([[5, 11, 3, 27, 9, 14, 2]], np.int64)
MEL_ATOL = 1e-4         # float32 reduction order, as test_torch_autoregressive
WAV_ATOL = 1e-5


def _mol_vocoder():
    """voc_pair's MOL WaveRNN with its log-scales lowered by 3, so that the
    samples spread over (-1, 1) instead of sitting on the clip: the draws
    decide every sample."""
    jm, v, tm = voc_pair("MOL")
    with torch.no_grad():
        tm.fc3.bias[20:] -= 3.0
    return jm, v, tm


def _weights(tm, mode):
    return (tm.sample_weights(torch.bfloat16) if mode is None
            else tm.int8_sample_weights())


@pytest.mark.parametrize("mode", [None, "int8", "int8_mxu"],
                         ids=["bf16", "int8", "int8_mxu"])
def test_sample_loop_chunks_draw_as_one_run(mode):
    """MOL, whose samples follow the uniforms: 7 + 5 steps with carried
    state equal 12 steps in one call, samples and state bit for bit."""
    _, _, tm = _mol_vocoder()
    w = _weights(tm, mode)
    cond = t(np.random.default_rng(0).standard_normal((12, 3, 16)) * 0.5,
             np.float32)
    kw = dict(mode="MOL", n_classes=30, seed=11, weight_dtype=mode)
    full, st = wavernn_sample_loop(cond, w, **kw)
    a, st_a = wavernn_sample_loop(cond[:7], w, **kw)
    b, st_b = wavernn_sample_loop(cond[7:], w, state=st_a, **kw)
    assert float((full.abs() < 1).float().mean()) > 0.9
    assert torch.equal(torch.cat([a, b]), full)
    assert st_b["step"] == st["step"] == 12
    for k in ("h1", "h2", "x"):
        assert torch.equal(st_b[k], st[k])


@pytest.mark.parametrize("r", [1, 2])
def test_chunked_decode_is_predict(r):
    """Dropout 0.5 from the same seed, stop off: chunks of 5 steps (the
    last one past max_steps) equal ``autoregressive_predict`` bit for
    bit."""
    _, _, tm = ar_pair("text")
    ids = torch.from_numpy(IDS)
    max_length = 11 * r
    want = autoregressive_predict(
        tm, ids, r=r, max_length=max_length, prenet_dropout=0.5,
        stop_enabled=False, generator=torch.Generator().manual_seed(4))
    state = streaming_decode_init(tm, ids, r=r, max_length=max_length,
                                  generator=torch.Generator().manual_seed(4))
    dec = make_chunk_decoder(tm, chunk=5, r=r, prenet_dropout=0.5,
                             stop_enabled=False)
    chunks = []
    for _ in range(3):
        state, out = dec(state)
        chunks.append(out)
    got = torch.cat(chunks, 1)
    n = want["steps"] * r
    assert want["steps"] == 12 and state["i"] == 15
    assert torch.equal(got[:, :n], want["mel"])
    assert not got[:, n:].any()             # steps past max_steps
    assert torch.equal(state["lengths"], want["mel_lengths"])


def _stop_head(bias):
    """ar_pair("text") with a stop head of constant logits ``bias``."""
    jm, v, tm = ar_pair("text")
    sl = v["params"]["Postnet"]["stop_linear"]
    sl["kernel"] = jnp.zeros_like(sl["kernel"])
    sl["bias"] = jnp.asarray(bias, jnp.float32)
    load_into(tm, flatten(v))
    return jm, v, tm


def test_stream_mel_matches_etts():
    """A stop head that never fires: 16 steps at r = 2 in chunks of 4."""
    jm, v, tm = _stop_head([10.0, 0.0, -10.0])
    kw = dict(chunk=4, r=2, max_length=30, prenet_dropout=0.0)
    want = np.concatenate(list(jstream_mel(jm, v, jnp.asarray(IDS, jnp.int32),
                                           key=jax.random.PRNGKey(0), **kw)))
    got = np.concatenate(list(streaming.stream_mel(
        tm, torch.from_numpy(IDS), **kw)))
    assert got.shape == want.shape == (32, 12)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


@pytest.mark.parametrize("r", [1, 2])
def test_stop_trims_stream(r):
    """A stop head that always fires: on the first frame at r = 1, on the
    first frame of the group at r = 2; one frame in all."""
    _, _, tm = _stop_head([0.0, 0.0, 10.0])
    chunks = list(streaming.stream_mel(tm, torch.from_numpy(IDS), chunk=4,
                                       r=r, max_length=40,
                                       prenet_dropout=0.0))
    assert sum(c.shape[0] for c in chunks) == 1


@pytest.mark.parametrize("r, chunk, shift, lengths",
                         [(1, 4, -1.9, [4] * 6 + [3]), (2, 1, -1.7, [2, 1])],
                         ids=["r1", "r2"])
def test_stream_mel_stops_as_predict(r, chunk, shift, lengths):
    """The random stop head with its stop logit lowered by ``shift`` fires
    inside a later chunk: on frame 27 (the third of the seventh chunk) at
    r = 1, on the first frame of the second group at r = 2. The stream ends
    with that chunk, trimmed, and holds autoregressive_predict's frames bit
    for bit."""
    _, v, tm = ar_pair("text")
    sl = v["params"]["Postnet"]["stop_linear"]
    sl["bias"] = sl["bias"].at[tm.stop_prob_index].add(shift)
    load_into(tm, flatten(v))
    ids = torch.from_numpy(IDS)
    want = autoregressive_predict(tm, ids, r=r, max_length=40,
                                  prenet_dropout=0.0)
    chunks = list(streaming.stream_mel(tm, ids, chunk=chunk, r=r,
                                       max_length=40, prenet_dropout=0.0))
    assert [c.shape[0] for c in chunks] == lengths
    assert torch.equal(torch.from_numpy(np.concatenate(chunks)),
                       want["mel"][0, :want["mel_length"]])


@pytest.mark.parametrize("mode", [None, "int8"], ids=["bf16", "int8"])
def test_stream_vocode_is_generate(mode):
    """23 frames in pieces of 5, 9 and 9, chunks of 6: three chunks and a
    flushed tail of 5 frames. With generate's fade-out applied, the stream
    equals generate(batched=False) on the same seed."""
    _, _, tm = _mol_vocoder()
    w = _weights(tm, mode)
    mel = np.random.default_rng(1).uniform(0, 1, (23, 8)).astype(np.float32)
    want = generate(tm, torch.from_numpy(mel), batched=False, mu_law=False,
                    seed=3, weights=w, int8_weights=bool(mode))
    chunks = list(streaming.stream_vocode(
        tm, [mel[:5], mel[5:14], mel[14:]], chunk_frames=6, mu_law=False,
        seed=3, int8_weights=bool(mode), weights=w))
    assert [c.shape[0] for c in chunks] == [60, 60, 60, 50]
    got = torch.from_numpy(np.concatenate(chunks))
    assert float((got.abs() < 1).float().mean()) > 0.9
    got = _finalize(got[None], False, 0, False, tm, want.shape[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=WAV_ATOL)


def test_chunk_below_pad_raises():
    _, _, tm = voc_pair("MOL")
    with pytest.raises(ValueError, match="pad"):
        next(streaming.stream_vocode(tm, [np.zeros((4, 8), np.float32)],
                                     chunk_frames=tm.pad - 1))


def test_chunk_conditioning_matches_etts():
    """One interior chunk's context -> conditioning, against etts'
    upsample_cond on the same context."""
    jm, v, tm = voc_pair("MOL")
    mel = np.random.default_rng(2).uniform(0, 1, (20, 8)).astype(np.float32)
    ctx, n = list(streaming._chunk_contexts([mel], 6, tm.pad, 8, "cpu"))[1]
    up, aux = jm.apply(v, jnp.asarray(ctx.numpy())[None], False,
                       method=JW.upsample_cond)
    want = np.concatenate([np.asarray(up), np.asarray(aux)], -1)[0]
    with torch.no_grad():
        got = streaming._chunk_cond(tm, ctx)
    assert got.shape == (n * tm.hop_length, 1, want.shape[-1])
    np.testing.assert_allclose(got[:, 0].numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return small_workspace(tmp_path_factory.mktemp("cfg"))


def test_tts_stream_end_to_end(workspace, monkeypatch, tmp_path):
    """With a stop head that never fires, 11 steps at r = 2 in chunks of 3:
    audio chunks of mel_chunk * r frames and a shorter last one, the
    stream's frames those of stream_mels, finite and within [-1, 1]; "mxu"
    runs the "int8" loop and gives what True gives."""
    d = workspace["dir"]
    weights = dict(np.load(d / "autoregressive.npz"))
    weights["['Postnet']['stop_linear']['kernel']"][:] = 0.0
    weights["['Postnet']['stop_linear']['bias']"][:] = [10.0, 0.0, -10.0]
    np.savez(tmp_path / "no_stop.npz", **weights)
    tts = TTSSynthesizer(d, tmp_path / "no_stop.npz", "cpu")
    voc = VocoderSynthesizer(d, d / "wavernn.npz", "cpu")
    ref_mel = tts.mel_from_wav(workspace["wav"])
    kw = dict(mel_chunk=3, max_length=20, seed=1)
    frames = sum(m.shape[0] for m in tts.stream_mels(
        "Hello world.", ref_mel, workspace["spk"], **kw))
    assert tts.r == 2 and frames == 22
    hop, step = voc.model.hop_length, 3 * tts.r * voc.model.hop_length
    modes = []
    real = streaming.wavernn_sample_loop

    def spy(*args, **kwargs):
        modes.append(kwargs["weight_dtype"])
        return real(*args, **kwargs)
    monkeypatch.setattr(streaming, "wavernn_sample_loop", spy)
    wavs = {}
    for flag in (None, True, "mxu"):
        chunks = list(tts.stream("Hello world.", voc, ref_mel,
                                 workspace["spk"], int8_weights=flag, **kw))
        assert [c.shape[0] for c in chunks] == [step] * 3 + [4 * hop]
        wavs[flag] = np.concatenate(chunks)
        assert wavs[flag].shape[0] == frames * hop
        assert np.isfinite(wavs[flag]).all()
        assert np.abs(wavs[flag]).max() <= 1.0
    n = len(chunks)
    assert modes == [None] * n + ["int8"] * (2 * n)
    np.testing.assert_array_equal(wavs["mxu"], wavs[True])
