"""Batched multi-utterance serving in the port against etts, on the CPU at
tiny sizes: the int8 sample-loop modes' plain versions against the Pallas
kernel in interpret mode (weight_dtype "int8" and "int8_mxu", the inputs of
tests/test_pallas_wavernn.py::TestInt8Weights made from numpy seeds),
``generate_batch`` against etts' ``generate_batch``, ``predict_many``
against etts' ``autoregressive_predict`` on the same zero-padded ids, and
the ``int8_weights`` mapping of the API.

The peaky RAW cases compare argmax picks. Both int8 modes round (bf16 or an
int8 step) activations that the packages compute with float32 sums in
different orders, so where two classes' logits nearly tie the packages may
pick differently: ``_weights(15)`` on ``_cond(16, 8)`` does so in int8_mxu
for one of 96 samples (and ``_weights(7)`` on ``_cond(1, 8)`` did in int8
while its plain version summed in the old kernel's lane order); the seeds
here do not.

Tolerances: 1e-5 for sampled values on deterministic (peaky RAW) paths; 0.02
between the two packages' MOL samples whose scale is e^-8 (their noise
differs); mean |int8 - float32| < 0.1, the etts gate; 1e-4 for float32 mels
(the decode tolerance of tests/test_torch_api.py)."""
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.autoregressive import (AutoregressiveTransformer as JM,
                                        autoregressive_predict)
from etts.models.wavernn import generate_batch as jgenerate_batch
from etts.ops.pallas.wavernn_cell import wavernn_sample_loop as jloop
from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
from etts_torch.models.wavernn import _int8_dtype, generate, generate_batch
from etts_torch.ops.kernels.wavernn_cell import (Int8SampleLoopWeights,
                                                 SampleLoopWeights,
                                                 quantize_int8,
                                                 wavernn_sample_loop,
                                                 wavernn_sample_loop_plain)
from torch_parity import ROOT, small_workspace, t, voc_pair

D, FC, FEAT, ADIM, T = 16, 16, 8, 4, 12
MODES = ("int8", "int8_mxu")
PEAKY = 1e6          # fc3 scale that makes RAW sampling an argmax


def _weights(seed, n_out):
    """The shapes and scales of test_pallas_wavernn.py's ``_weights``."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(W_I=n(1 + FEAT + ADIM, D), b_I=n(D), wi1=n(D, 3 * D),
                wh1=n(D, 3 * D), bi1=n(3 * D), bh1=n(3 * D), w2x=n(D, 3 * D),
                w2a=n(ADIM, 3 * D), wh2=n(D, 3 * D), bi2=n(3 * D),
                bh2=n(3 * D), wf1x=n(D, FC), wf1a=n(ADIM, FC),
                bf1=np.zeros(FC, np.float32), wf2x=n(FC, FC),
                wf2a=n(ADIM, FC), bf2=np.zeros(FC, np.float32),
                wf3=n(FC, n_out), bf3=np.zeros(n_out, np.float32))


def _flax_args(w):
    """The arguments of ``*SampleLoopWeights.from_flax_layout``."""
    return (t(w["W_I"]), t(w["b_I"]), t(w["wi1"]), t(w["wh1"]), t(w["bi1"]),
            t(w["bh1"]), t(np.concatenate([w["w2x"], w["w2a"]])),
            t(w["wh2"]), t(w["bi2"]), t(w["bh2"]),
            t(np.concatenate([w["wf1x"], w["wf1a"]])), t(w["bf1"]),
            t(np.concatenate([w["wf2x"], w["wf2a"]])), t(w["bf2"]),
            t(w["wf3"]), t(w["bf3"]))


def _int8(w):
    return Int8SampleLoopWeights.from_flax_layout(*_flax_args(w), feat=FEAT)


def _jax_loop(cond, w, weight_dtype, state=None, **kw):
    j = {k: jnp.asarray(v) for k, v in w.items()}
    out = jloop(
        jnp.asarray(cond), j["W_I"], j["b_I"], j["wi1"], j["wh1"], j["bi1"],
        j["bh1"], j["w2x"], j["w2a"], j["wh2"], j["bi2"], j["bh2"],
        j["wf1x"], j["wf1a"], j["bf1"], j["wf2x"], j["wf2a"], j["bf2"],
        j["wf3"], j["bf3"], 3, feat=FEAT, adim=ADIM, chunk=4, interpret=True,
        weight_dtype=weight_dtype, state=state,
        return_state=state is not None or kw.pop("return_state", False),
        **kw)
    return out


def _cond(seed, B):
    return (np.random.default_rng(seed).standard_normal(
        (T, B, FEAT + 4 * ADIM)) * 0.1).astype(np.float32)


# --- the int8 plain versions against the Pallas kernel (interpret) ---

@pytest.mark.parametrize("weight_dtype", MODES)
@pytest.mark.parametrize("B", [8, 11])
def test_int8_peaky_raw_matches_etts_kernel(B, weight_dtype):
    """Near-delta categorical: sampling is an argmax, so the two packages
    agree whatever their random bits; B = 11 is a row count the TPU kernel
    padded."""
    w = _weights(B, 16)
    w["wf3"] = w["wf3"] * PEAKY
    cond = _cond(B + 1, B)
    want = np.asarray(_jax_loop(cond, w, weight_dtype, mode="RAW",
                                n_classes=16))
    got, _ = wavernn_sample_loop(t(cond), _int8(w), mode="RAW", n_classes=16,
                                 seed=5, weight_dtype=weight_dtype)
    assert got.shape == (T, B)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("weight_dtype", MODES)
def test_int8_mol_concentrated_means(weight_dtype):
    """All mixture means 0.7, log-scales -8: every sample lands on 0.7 in
    both packages, whatever the mixture pick."""
    w = _weights(2, 30)
    w["wf3"] = np.zeros_like(w["wf3"])
    w["bf3"][10:20], w["bf3"][20:30] = 0.7, -8.0
    cond = _cond(1, 8)
    want = np.asarray(_jax_loop(cond, w, weight_dtype, mode="MOL"))
    got, _ = wavernn_sample_loop(t(cond), _int8(w), mode="MOL", seed=5,
                                 weight_dtype=weight_dtype)
    assert np.abs(want - 0.7).max() < 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=0.02)


@pytest.mark.parametrize("weight_dtype", MODES)
def test_int8_chunked_state_carry(weight_dtype):
    """Peaky RAW in two chunks (7 + 5 steps) with carried state equals one
    call, and equals the Pallas kernel's own chunked run."""
    w = _weights(6, 16)
    w["wf3"] = w["wf3"] * PEAKY
    qw = _int8(w)
    cond = _cond(1, 8)
    kw = dict(mode="RAW", n_classes=16, weight_dtype=weight_dtype)
    full, _ = wavernn_sample_loop(t(cond), qw, **kw)
    a, st = wavernn_sample_loop(t(cond[:7]), qw, **kw)
    b, st2 = wavernn_sample_loop(t(cond[7:]), qw, state=st, **kw)
    assert st2["step"] == T
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                               atol=1e-5)
    ja, jst = _jax_loop(cond[:7], w, weight_dtype, mode="RAW", n_classes=16,
                        return_state=True)
    jb, _ = _jax_loop(cond[7:], w, weight_dtype, state=jst, mode="RAW",
                      n_classes=16)
    np.testing.assert_allclose(full.numpy(),
                               np.concatenate([ja, jb]), atol=1e-5)


@pytest.mark.parametrize("weight_dtype", MODES)
def test_int8_tracks_float32(weight_dtype):
    """The etts gate (test_pallas_wavernn.py:210, 259): with the fc3 scale
    of that test (x100, not an argmax) and the same uniforms on both sides,
    the int8 trajectory stays within a mean |d| of 0.1 of the float32
    one."""
    w = _weights(0, 16)
    w["wf3"] = w["wf3"] * 100.0
    cond = t(_cond(1, 8))
    u = torch.rand(T, 8, 16, generator=torch.Generator().manual_seed(0))
    kw = dict(mode="RAW", n_classes=16, noise=u)
    f32, _ = wavernn_sample_loop_plain(
        cond, SampleLoopWeights.from_flax_layout(*_flax_args(w), feat=FEAT,
                                                 dtype=torch.float32), **kw)
    i8, _ = wavernn_sample_loop_plain(cond, _int8(w),
                                      weight_dtype=weight_dtype, **kw)
    assert float((i8 - f32).abs().mean()) < 0.1
    assert float(i8.abs().max()) <= 1.0


@pytest.mark.parametrize("weight_dtype", MODES)
def test_int8_split_scales(weight_dtype):
    """w2a's input rows 100x larger than w2x's: a scale shared by the
    concatenation [x | a2] would flatten w2x to a few levels. Each split
    keeps its own scale row, as the TPU kernel quantizes it, and the loop
    still matches etts."""
    w = _weights(3, 16)
    w["w2a"] = w["w2a"] * 100.0
    w["wf3"] = w["wf3"] * PEAKY
    qw = _int8(w)
    q, s = quantize_int8(t(w["w2x"]))
    assert torch.equal(qw.w2x[:, :D], q) and torch.equal(qw.s_w2x, s)
    assert float(qw.s_w2a.min()) > 10 * float(qw.s_w2x.max())
    assert int(qw.w2x.abs().max()) == 127
    cond = _cond(4, 8)
    want = np.asarray(_jax_loop(cond, w, weight_dtype, mode="RAW",
                                n_classes=16))
    got, _ = wavernn_sample_loop(t(cond), qw, mode="RAW", n_classes=16,
                                 weight_dtype=weight_dtype)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_quantize_matches_numpy_rule():
    """s = max(max|w| over inputs / 127, 1e-12); q = round half to even of
    w / s, clipped to +-127; an all-zero column gets the floor scale."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((9, 5)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0
    w[0, 1] = 2.5 * np.abs(w[1:, 1]).max()
    s = np.maximum(np.abs(w).max(0) / np.float32(127.0), np.float32(1e-12))
    want = np.clip(np.round(w / s), -127, 127).astype(np.int8).T
    q, ts = quantize_int8(t(w))
    np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(ts.numpy(), s.astype(np.float32))
    assert ts[3] == np.float32(1e-12) and q.dtype == torch.int8


def test_int8_wrapper_checks_and_counts_nothing_on_cpu():
    w = _weights(1, 30)
    qw = _int8(w)
    assert qw.wic.shape == (D, FEAT + ADIM) and qw.w2a.shape == (3 * D, 4)
    before = (wavernn_sample_loop.launches_int8,
              wavernn_sample_loop.launches_int8_mxu)
    for mode in MODES:
        wavernn_sample_loop(t(_cond(0, 2)), qw, weight_dtype=mode)
    assert (wavernn_sample_loop.launches_int8,
            wavernn_sample_loop.launches_int8_mxu) == before
    bf = SampleLoopWeights.from_flax_layout(*_flax_args(w), feat=FEAT,
                                            dtype=torch.float32)
    with pytest.raises(TypeError):
        wavernn_sample_loop(t(_cond(0, 2)), bf, weight_dtype="int8")
    with pytest.raises(TypeError):
        wavernn_sample_loop(t(_cond(0, 2)), qw)
    with pytest.raises(ValueError):
        wavernn_sample_loop(t(_cond(0, 2)), qw, weight_dtype="int4")


# --- generate_batch ---

def _mels():
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, (n, 8)).astype(np.float32) for n in (12, 7, 19)]


def test_generate_batch_matches_etts():
    """Three utterances of different lengths in one sample loop against
    etts' generate_batch (bucketing, row padding and the scan loop) on a
    near-deterministic RAW vocoder."""
    jm, v, tm = voc_pair("RAW", peaky=1e5)
    mels = _mels()
    want = jgenerate_batch(jm, v, [jnp.asarray(m) for m in mels], target=30,
                           overlap=10, mu_law=True, key=jax.random.PRNGKey(0),
                           use_pallas=False)
    got = generate_batch(tm, [t(m) for m in mels], target=30, overlap=10,
                         mu_law=True)
    assert [g.shape for g in got] == [((m.shape[0] - 1) * 10,) for m in mels]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("int8_weights", [False, True, "mxu"])
def test_generate_batch_equals_generate(int8_weights):
    """Fold rows are independent: each utterance of a batch equals its own
    generate() in every weight mode. A batch row draws other uniforms than
    the same row in its own generate(), so only RAW weights at the fc3
    scale that makes sampling an argmax (PEAKY) make the comparison
    deterministic."""
    _, _, tm = voc_pair("RAW", peaky=PEAKY)
    mels = _mels()
    got = generate_batch(tm, [t(m) for m in mels], target=30, overlap=10,
                         int8_weights=int8_weights)
    for g, m in zip(got, mels):
        want = generate(tm, t(m), target=30, overlap=10,
                        int8_weights=int8_weights)
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-5)


# --- the API ---

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return small_workspace(tmp_path_factory.mktemp("cfg"))


TEXTS = ("Hello world, this is 42 tests.", "Short one.",
         "A third sentence, somewhat longer than the second.")


def test_predict_many_matches_etts(workspace):
    """Three texts of different lengths in one decode against etts'
    autoregressive_predict on the same zero-padded ids, dropout 0."""
    tts = TTSSynthesizer(workspace["dir"],
                         workspace["dir"] / "autoregressive.npz", "cpu")
    ref_mel = tts.mel_from_wav(workspace["wav"])
    got = tts.predict_many(TEXTS, ref_mel, workspace["spk"], max_length=20)
    cm, model, variables = workspace["autoregressive"]
    seqs = [np.asarray(cm.get_text_pipeline()(x), np.int32) for x in TEXTS]
    ids = np.zeros((3, max(len(q) for q in seqs)), np.int32)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = q
    ref = jnp.tile(JM.encode_ref(jnp.asarray(ref_mel), 2), (3, 1, 1))
    spk = jnp.tile(jnp.asarray(workspace["spk"]).reshape(1, 1, -1), (3, 1, 1))
    out = autoregressive_predict(model, variables, jnp.asarray(ids), ref,
                                 spk, r=2, max_length=20,
                                 key=jax.random.PRNGKey(0),
                                 prenet_dropout=0.0)
    lengths = np.asarray(out["mel_lengths"])
    assert [m.shape[0] for m in got] == lengths.tolist()
    for i, m in enumerate(got):
        np.testing.assert_allclose(
            m, np.asarray(out["mel"][i][:lengths[i]]), atol=1e-4)


def test_predict_many_of_one_is_predict(workspace):
    tts = TTSSynthesizer(workspace["dir"],
                         workspace["dir"] / "autoregressive.npz", "cpu")
    ref_mel = tts.mel_from_wav(workspace["wav"])
    [one] = tts.predict_many(TEXTS[:1], ref_mel, workspace["spk"],
                             max_length=20)
    want = tts.predict(TEXTS[0], ref_mel, workspace["spk"],
                       max_length=20)["mel"]
    np.testing.assert_array_equal(one, want)


@pytest.mark.parametrize("int8_weights", [None, True, "mxu"])
def test_generate_many_matches_generate(workspace, int8_weights):
    """generate_many equals generate per mel in each mode; the int8 weights
    are built once and kept."""
    voc = VocoderSynthesizer(workspace["dir"],
                             workspace["dir"] / "wavernn.npz", "cpu")
    rng = np.random.default_rng(5)
    mels = [rng.uniform(0, 1, (n, 80)).astype(np.float32) for n in (9, 5)]
    got = voc.generate_many(mels, int8_weights=int8_weights)
    kept = voc._int8_weights
    for g, m in zip(got, mels):
        assert g.shape == ((m.shape[0] - 1) * 200,)
        np.testing.assert_allclose(
            g, voc.generate(m, int8_weights=int8_weights), atol=1e-5)
    assert voc._int8_weights is kept
    assert (kept is None) == (int8_weights is None)


@pytest.mark.parametrize("config,override,want", [
    (None, None, False), (False, True, True), (True, None, True),
    ("mxu", None, "mxu"), (True, "mxu", "mxu"), ("mxu", False, False),
    (None, 0, False)])
def test_int8_mapping(config, override, want):
    """VocoderSynthesizer._int8 (`etts/api.py:348-353`): the override, else
    the config key voc_int8_weights; "mxu" passes, anything else is a
    bool. _int8_dtype maps it to the sample loop's weight_dtype."""
    cfg = {} if config is None else {"voc_int8_weights": config}
    got = VocoderSynthesizer._int8(SimpleNamespace(config=cfg), override)
    assert got == want and type(got) is type(want)
    assert _int8_dtype(got) == {False: None, True: "int8",
                                "mxu": "int8_mxu"}[want]


def test_synthesize_cli_int8(workspace, tmp_path):
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
         "--sentences", TEXTS[1], "--max_length", "20", "--device", "cpu",
         "--int8", "--out_dir", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mel = np.load(tmp_path / "out" / "0_mel.npy")
    assert (tmp_path / "out" / "0.wav").stat().st_size == 44 + 2 * (
        mel.shape[0] - 1) * 200
