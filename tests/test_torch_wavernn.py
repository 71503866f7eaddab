"""WaveRNN vocoder of the port against flax, and the plain sample loop
against etts' Pallas kernel in interpret mode with float32 weights, in the
modes of tests/test_pallas_wavernn.py. Tolerances: 1e-4 for float32 network
outputs, 1e-5 for sampled values on deterministic paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.wavernn import WaveRNN as JW, generate as jgenerate
from etts.ops.pallas.wavernn_cell import wavernn_sample_loop as jloop
from etts_torch.models.wavernn import (fold_with_overlap, generate,
                                       xfade_and_unfold)
from etts_torch.ops.kernels.wavernn_cell import (SampleLoopWeights, n_draw,
                                                 wavernn_sample_loop,
                                                 wavernn_sample_loop_plain)
from torch_parity import t, voc_pair

ATOL = 1e-4


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_upsample_network(mode):
    jm, v, tm = voc_pair(mode)
    mels = np.random.default_rng(0).standard_normal((2, 9, 8)).astype(
        np.float32)
    up, aux = jm.apply(v, jnp.asarray(mels), False, method=JW.upsample_cond)
    with torch.no_grad():
        tup, taux = tm.upsample(t(mels))
    np.testing.assert_allclose(tup.numpy(), np.asarray(up), atol=ATOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(aux), atol=ATOL)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_teacher_forced_forward(mode):
    jm, v, tm = voc_pair(mode)
    rng = np.random.default_rng(1)
    mels = rng.standard_normal((2, 9, 8)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 50)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mels), False)
    np.testing.assert_allclose(tm(t(x), t(mels)).numpy(), np.asarray(want),
                               atol=ATOL)


def test_fold_shape_and_content():
    x = torch.arange(10, dtype=torch.float32)[None, :, None]
    folded = fold_with_overlap(x, target=2, overlap=1)
    assert folded.shape == (3, 4, 1)
    np.testing.assert_allclose(folded[:, :, 0].numpy(),
                               [[0, 1, 2, 3], [3, 4, 5, 6], [6, 7, 8, 9]])


def test_xfade_matches_numpy_golden():
    """The numpy re-derivation of tests/test_wavernn.py (fade + overlap-add,
    fatchord_version.py:353-383)."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((3, 60))
    overlap = 10
    g = y.copy()
    sil, fl = overlap // 2, overlap - overlap // 2
    tt = np.linspace(-1, 1, fl)
    g[:, :overlap] *= np.concatenate([np.zeros(sil), np.sqrt(0.5 * (1 + tt))])
    g[:, -overlap:] *= np.concatenate([np.sqrt(0.5 * (1 - tt)), np.zeros(sil)])
    want = np.zeros(3 * 50 + overlap)
    for i in range(3):
        want[i * 50:i * 50 + 60] += g[i]
    got = xfade_and_unfold(torch.from_numpy(y.astype(np.float32)), overlap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# --- plain sample loop against the Pallas kernel (interpret, float32) ---

D, FC, FEAT, ADIM, T = 16, 16, 8, 4, 12


def _loop_weights(seed, n_out):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(W_I=n(1 + FEAT + ADIM, D), b_I=n(D), wi1=n(D, 3 * D),
                wh1=n(D, 3 * D), bi1=n(3 * D), bh1=n(3 * D), w2x=n(D, 3 * D),
                w2a=n(ADIM, 3 * D), wh2=n(D, 3 * D), bi2=n(3 * D),
                bh2=n(3 * D), wf1x=n(D, FC), wf1a=n(ADIM, FC),
                bf1=np.zeros(FC, np.float32), wf2x=n(FC, FC),
                wf2a=n(ADIM, FC), bf2=np.zeros(FC, np.float32),
                wf3=n(FC, n_out), bf3=np.zeros(n_out, np.float32))


def _port_weights(w):
    return SampleLoopWeights.from_flax_layout(
        t(w["W_I"]), t(w["b_I"]), t(w["wi1"]), t(w["wh1"]), t(w["bi1"]),
        t(w["bh1"]), t(np.concatenate([w["w2x"], w["w2a"]])), t(w["wh2"]),
        t(w["bi2"]), t(w["bh2"]), t(np.concatenate([w["wf1x"], w["wf1a"]])),
        t(w["bf1"]), t(np.concatenate([w["wf2x"], w["wf2a"]])), t(w["bf2"]),
        t(w["wf3"]), t(w["bf3"]), feat=FEAT, dtype=torch.float32)


def _jax_loop(cond, w, **kw):
    j = {k: jnp.asarray(v) for k, v in w.items()}
    return np.asarray(jloop(
        jnp.asarray(cond), j["W_I"], j["b_I"], j["wi1"], j["wh1"], j["bi1"],
        j["bh1"], j["w2x"], j["w2a"], j["wh2"], j["bi2"], j["bh2"],
        j["wf1x"], j["wf1a"], j["bf1"], j["wf2x"], j["wf2a"], j["bf2"],
        j["wf3"], j["bf3"], kw.pop("seed", 3), feat=FEAT, adim=ADIM, chunk=4,
        interpret=True, weight_dtype=jnp.float32, **kw))


def _cond(seed, B):
    return (np.random.default_rng(seed).standard_normal(
        (T, B, FEAT + 4 * ADIM)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("B", [8, 11])
def test_loop_peaky_raw_matches_etts_kernel(B):
    """Near-delta categorical: sampling is argmax, so the paths agree
    exactly whatever the random bits; B = 11 is a row count the TPU kernel
    padded."""
    w = _loop_weights(B, 16)
    w["wf3"] = w["wf3"] * 1e6
    cond = _cond(B + 1, B)
    want = _jax_loop(cond, w, mode="RAW", n_classes=16)
    got, _ = wavernn_sample_loop(t(cond), _port_weights(w), mode="RAW",
                                 n_classes=16, seed=5)
    assert got.shape == (T, B)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_loop_mol_concentrated_means():
    """All mixture means 0.5, tiny scales: every sample lands on 0.5 in both
    implementations, whatever the mixture pick."""
    w = _loop_weights(4, 30)
    w["wf3"] = np.zeros_like(w["wf3"])
    w["bf3"][10:20], w["bf3"][20:30] = 0.5, -8.0
    cond = _cond(5, 8)
    want = _jax_loop(cond, w, mode="MOL")
    got, _ = wavernn_sample_loop(t(cond), _port_weights(w), mode="MOL")
    np.testing.assert_allclose(want, 0.5, atol=0.02)
    np.testing.assert_allclose(got.numpy(), want, atol=0.02)


def test_loop_mol_bounded():
    w = _loop_weights(2, 30)
    got, _ = wavernn_sample_loop(t(_cond(3, 8)), _port_weights(w), seed=5)
    assert torch.isfinite(got).all() and float(got.abs().max()) <= 1.0


def test_loop_chunked_state_carry():
    """Peaky RAW in two chunks (7 + 5 steps) with carried state equals one
    call, and equals the Pallas kernel's own chunked run."""
    w = _loop_weights(7, 16)
    w["wf3"] = w["wf3"] * 1e6
    pw = _port_weights(w)
    cond = t(_cond(1, 8))
    full, _ = wavernn_sample_loop(cond, pw, mode="RAW", n_classes=16)
    a, st = wavernn_sample_loop(cond[:7], pw, mode="RAW", n_classes=16)
    b, st2 = wavernn_sample_loop(cond[7:], pw, mode="RAW", n_classes=16,
                                 state=st)
    assert st2["step"] == T
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(full.numpy(),
                               _jax_loop(_cond(1, 8), w, mode="RAW",
                                         n_classes=16), atol=1e-5)


@pytest.mark.parametrize("mode,n", [("MOL", 30), ("RAW", 16)])
def test_loop_noise_and_teacher(mode, n):
    """Given uniforms make the loop deterministic, and feeding back its own
    samples as the teacher reproduces it exactly."""
    pw = _port_weights(_loop_weights(9, n))
    cond = t(_cond(2, 3))
    u = torch.rand(T, 3, n_draw(mode, n, pw.n_out),
                   generator=torch.Generator().manual_seed(0))
    a, _ = wavernn_sample_loop_plain(cond, pw, mode=mode, n_classes=n, noise=u)
    b, _ = wavernn_sample_loop_plain(cond, pw, mode=mode, n_classes=n, noise=u,
                                     teacher=a)
    assert torch.equal(a, b)


def test_wrapper_runs_plain_on_cpu_without_counting():
    pw = _port_weights(_loop_weights(1, 30))
    before = wavernn_sample_loop.launches
    wavernn_sample_loop(t(_cond(0, 2)), pw)
    assert wavernn_sample_loop.launches == before


@pytest.mark.parametrize("batched", [True, False])
def test_generate_peaky_raw_matches_etts(batched):
    """Whole generate (clamp, upsample, fold, loop, unfold, mu-law, fade)
    against etts' scan path on a near-deterministic RAW vocoder."""
    jm, v, tm = voc_pair("RAW", peaky=1e5)
    mel = np.random.default_rng(3).uniform(0, 1, (12, 8)).astype(np.float32)
    want = np.asarray(jgenerate(jm, v, jnp.asarray(mel), batched=batched,
                                target=30, overlap=10, mu_law=True,
                                key=jax.random.PRNGKey(0), use_pallas=False))
    got = generate(tm, t(mel), batched=batched, target=30, overlap=10,
                   mu_law=True).numpy()
    assert got.shape == want.shape == ((12 - 1) * 10,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_generate_mol_shape_and_range():
    _, _, tm = voc_pair("MOL")
    mel = torch.rand(12, 8, generator=torch.Generator().manual_seed(0)) * 3
    wav = generate(tm, mel, target=30, overlap=10)
    assert wav.shape == (110,) and torch.isfinite(wav).all()
    assert float(wav.abs().max()) <= 1.0


def test_committed_export_matches_etts():
    """The committed 26k vocoder export at flagship width, init BatchNorm
    statistics on both sides (the export has none). The upsample network
    agrees to float32 rounding (rtol 1e-5; aux also atol 1e-5 of its
    largest value, summed through ten residual blocks). Without its
    statistics the MelResNet's aux features run far out of range and every
    sample clips at +1 in both packages, so the waveforms are the fade-out
    ramp alone, deterministic, and agree to 1e-6."""
    from pathlib import Path
    from etts_torch.api import VocoderSynthesizer
    root = Path(__file__).resolve().parents[1]
    voc = VocoderSynthesizer(root / "configs/default",
                             root / "artifacts/soak/voc_gta26k_params_fp16.npz",
                             "cpu")
    tm = voc.model
    jm = JW(rnn_dims=tm.rnn_dims, fc_dims=tm.fc_dims, bits=tm.bits,
            pad=tm.pad, upsample_factors=tm.upsample.scales,
            feat_dims=tm.feat_dims, compute_dims=128, res_out_dims=128,
            res_blocks=tm.upsample.resnet.n_res, hop_length=tm.hop_length,
            mode=tm.mode)
    v = dict(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 800)),
                     jnp.zeros((1, 8, tm.feat_dims)), False))
    with np.load(root / "artifacts/soak/voc_gta26k_params_fp16.npz") as z:
        v["params"] = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(z[jax.tree_util.keystr(p)], jnp.float32),
            v["params"])
    mel = np.random.default_rng(0).uniform(0.3, 1.0, (6, 80)).astype(
        np.float32)
    padded = np.pad(mel, ((tm.pad, tm.pad), (0, 0)))[None]
    up, aux = jm.apply(v, jnp.asarray(padded), False, method=JW.upsample_cond)
    with torch.no_grad():
        tup, taux = tm.upsample(t(padded))
    np.testing.assert_allclose(tup.numpy(), np.asarray(up), rtol=1e-5,
                               atol=1e-6)
    aux = np.asarray(aux)
    np.testing.assert_allclose(taux.numpy(), aux, rtol=1e-5,
                               atol=1e-5 * np.abs(aux).max())
    want = np.asarray(jgenerate(jm, v, jnp.asarray(mel), batched=False,
                                mu_law=True, key=jax.random.PRNGKey(0),
                                use_pallas=False))
    got = voc.generate(mel, batched=False)
    assert got.shape == want.shape == (5 * 200,)
    np.testing.assert_allclose(got, want, atol=1e-6)
    n_fade = 20 * 200          # every sample +1, times the 20-hop fade-out
    ramp = np.clip(1 - (n_fade - 1000 + np.arange(1000)) / (n_fade - 1), 0, 1)
    np.testing.assert_allclose(want, ramp, atol=1e-6)
