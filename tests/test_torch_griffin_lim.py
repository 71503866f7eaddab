"""Griffin-Lim synthesis of the port (``etts_torch/ops/griffin_lim.py``,
``istft``, ``denormalize``, ``AudioProcessor.reconstruct_waveform``) against
etts on the CPU, and ``python -m etts_torch.synthesize`` without a vocoder.

Tolerances, relative to the largest value: 1e-5 for istft and
denormalize; 1e-4 for nnls and mel_to_linear, whose float32
pseudo-inverse (each package's own LAPACK) leaves about 1e-5; 5e-3 for
reconstruct_waveform at 0 iterations, where the zero-phase overlap-add of
1025 bins cancels to a waveform about 1e-3 of their scale, so the same
gaps reach about 1e-3 of it; 1e-4 for griffin_lim at a small size.

At the configs' size (n_fft 2048) etts' float32 STFT pair sets the phase
of bins at its noise floor from rounding, and every iteration feeds that
back: a one-ulp change of etts' input moves etts' own output by 0.0056
(relative l2 of the STFT magnitudes) after one iteration and by 0.057
after 32. The port's float64 pair moves by 7e-5 after one. So the two
packages are compared after N_FEW iterations, where rounding has not yet
grown: on each package's own magnitudes (their 5e-6 apart from the
pseudo-inverse, which etts' pair then amplifies) within 0.05, and
Griffin-Lim alone on etts' magnitude within GL_BAR, above etts' one-ulp
control (0.0067 at 2 iterations) and under the smallest fault measured
(0.045, the magnitude perturbed by 1e-4 noise; a window sum left out
0.105, one iteration more or fewer 0.17). After 32 iterations they are
held by their spectral convergence against the target (within 1e-3)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from etts.ops.audio import AudioProcessor as JAudio
from etts.ops.normalizers import get_normalizer as jnormalizer
from etts_torch.ops import griffin_lim as tgl
from etts_torch.ops import stft as tst
from etts_torch.ops.audio import AudioProcessor as TAudio
from etts_torch.ops.normalizers import get_normalizer as tnormalizer
from etts_torch.synthesize import main as synthesize
from torch_parity import ROOT, small_workspace

jst = importlib.import_module("etts.ops.stft")
jgl = importlib.import_module("etts.ops.griffin_lim")
CONFIG = yaml.safe_load(open(ROOT / "configs/default/data_config.yaml"))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("center", [True, False])
def test_istft(center):
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((33, 20))
            + 1j * rng.standard_normal((33, 20))).astype(np.complex64)
    want = jst.istft(jnp.asarray(spec), 64, 16, 48, center=center,
                     length=250)
    got = tst.istft(torch.from_numpy(spec), 64, 16, 48, center=center,
                    length=250)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["MelGAN", "WaveRNN"])
def test_denormalize(name):
    S = np.random.default_rng(1).uniform(-4, 4, (80, 30)).astype(np.float32)
    want = jnormalizer(name).denormalize(jnp.asarray(S))
    got = tnormalizer(name).denormalize(torch.from_numpy(S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_nnls_and_mel_to_linear():
    rng = np.random.default_rng(2)
    B = rng.uniform(0, 1, (20, 15)).astype(np.float32)
    A = jst.mel_filterbank(16000, 256, 20)
    want = jgl.nnls(jnp.asarray(A), jnp.asarray(B))
    got = tgl.nnls(torch.from_numpy(A), torch.from_numpy(B))
    _close(got, want, 1e-4)
    assert float(got.min()) >= 0.0
    want = jgl.mel_to_linear(jnp.asarray(B), 16000, 256, 20)
    _close(tgl.mel_to_linear(torch.from_numpy(B), 16000, 256, 20), want,
           1e-4)


def test_griffin_lim_zero_phase():
    mag = np.abs(np.random.default_rng(3).standard_normal((33, 25))).astype(
        np.float32)
    want = jgl.griffin_lim(jnp.asarray(mag), 64, 16, 48, n_iter=32)
    got = tgl.griffin_lim(torch.from_numpy(mag), 64, 16, 48, n_iter=32)
    _close(got, want, 1e-4)
    again = tgl.griffin_lim(torch.from_numpy(mag), 64, 16, 48, n_iter=32)
    assert torch.equal(got, again)


def test_griffin_lim_random_phase_from_generator():
    mag = torch.rand(33, 25, generator=torch.Generator().manual_seed(0))
    run = lambda s: tgl.griffin_lim(
        mag, 64, 16, 48, n_iter=4, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def _tone_mel(seconds):
    """etts' normalized mel of two tones and a little noise."""
    t = np.arange(int(16000 * seconds)) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 200 * t) + 0.1 * np.sin(2 * np.pi * 630 * t)
           + 0.01 * np.random.default_rng(4).standard_normal(t.shape))
    return np.array(JAudio(CONFIG).mel_spectrogram(wav.astype(np.float32)))


N_FEW = 2
GL_BAR = 0.02


@pytest.mark.parametrize("frames", [41, 5])
def test_reconstruct_waveform(frames):
    """41 frames, and 5, fewer than n_fft // hop + 2 = 12, which are padded
    with near silence and trimmed to hop * 5 samples."""
    mel = _tone_mel(0.5)[:, :frames]
    ja, ta = JAudio(CONFIG), TAudio(CONFIG)
    _close(ta.reconstruct_waveform(mel, n_iter=0),
           ja.reconstruct_waveform(jnp.asarray(mel), n_iter=0), 5e-3)

    def spec(y):        # zero-padded past the reflect pad's n_fft // 2
        y = np.pad(np.asarray(y), (0, max(0, 2048 - y.shape[0])))
        return tst.stft(torch.from_numpy(y), 2048, 200, 800).abs()

    def dist(got, want):
        s_got, s_want = spec(got), spec(want)
        return float((s_got - s_want).norm() / s_want.norm())

    assert dist(ta.reconstruct_waveform(mel, n_iter=N_FEW).numpy(),
                ja.reconstruct_waveform(jnp.asarray(mel),
                                        n_iter=N_FEW)) < 0.05
    padded = mel
    if frames < 12:
        pad_val = float(ja.normalizer.normalize(jnp.asarray(1e-5)))
        padded = np.pad(mel, ((0, 0), (0, 12 - frames)),
                        constant_values=pad_val)
    jmag = jgl.mel_to_linear(ja.normalizer.denormalize(jnp.asarray(padded)),
                             16000, 2048, 80)
    assert dist(tgl.griffin_lim(torch.from_numpy(np.array(jmag)), 2048,
                                200, 800, n_iter=N_FEW).numpy(),
                jgl.griffin_lim(jmag, 2048, 200, 800,
                                n_iter=N_FEW)) < GL_BAR

    want = np.asarray(ja.reconstruct_waveform(jnp.asarray(mel), n_iter=32))
    got = ta.reconstruct_waveform(mel, n_iter=32).numpy()
    assert got.shape == want.shape
    assert got.shape[0] == 200 * (frames - 1 if frames >= 12 else frames)
    assert np.isfinite(got).all()
    if frames >= 12:        # the output covers the mel's frames
        mag = tgl.mel_to_linear(
            ta.normalizer.denormalize(torch.from_numpy(mel)), 16000, 2048, 80)
        k = mag.shape[1]
        conv = lambda s: float((s[:, :k] - mag).norm() / mag.norm())
        assert abs(conv(spec(got)) - conv(spec(want))) < 1e-3


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return small_workspace(tmp_path_factory.mktemp("cfg"))


def test_synthesize_cli_without_vocoder(workspace, tmp_path):
    """No vocoder arguments: the wav comes from Griffin-Lim; one of the two
    alone is an error."""
    import wave
    from etts_torch.synthesize import write_wav
    ref = tmp_path / "ref.wav"
    write_wav(ref, workspace["wav"], 16000)
    np.save(tmp_path / "spk.npy", workspace["spk"])
    d = workspace["dir"]
    args = ["--tts_config", str(d), "--tts_weights",
            str(d / "autoregressive.npz"), "--ref_wav", str(ref),
            "--spk_embed", str(tmp_path / "spk.npy"), "--sentences",
            "Hello world.", "--max_length", "20", "--device", "cpu",
            "--out_dir", str(tmp_path / "out")]
    synthesize(args)
    mel = np.load(tmp_path / "out" / "0_mel.npy")
    with wave.open(str(tmp_path / "out" / "0.wav"), "rb") as f:
        n = f.getnframes()
    t_min = CONFIG["n_fft"] // CONFIG["hop_length"] + 2
    t = mel.shape[0]
    assert n == CONFIG["hop_length"] * (t if t < t_min else t - 1)
    for extra in (["--voc_config", str(d)],
                  ["--voc_weights", str(d / "wavernn.npz")]):
        with pytest.raises(SystemExit) as e:
            synthesize(args + extra)
        assert e.value.code == 2
