"""The port's evaluation entry points against etts' scripts: the synthetic
corpus and the combo file byte for byte, ``objective_measure``'s tables,
the GST embeddings of a tiny AR model and of a tiny Tacotron, the
first-token probe's weights, one fresh MINE and one fresh CLUB critic
update, the expressive-control measures; then each CLI once on a tiny
seeded model under ``--device cpu``."""
import csv
import importlib.util
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from etts.models import mine as jmine
from etts.train import TrainState as JState
from etts.train import make_mine_update as j_mine_update
from etts_torch import (create_dataset, eval_disentanglement,
                        eval_expressive_control, export_gst_embeddings,
                        make_combo_file, make_synth_corpus,
                        objective_measure, synthesize_speaker)
from etts_torch.convert import load_into, seeded_flat
from etts_torch.train import steps as tsteps
from torch_parity import (AR_TINY, SPK_DIM, TTS_SMALL, assert_grads_close,
                          capture_state, capture_tx, flatten,
                          seeded_variables, t, taco_pair, torch_grads)
from test_torch_train_mine import etts_draws

ROOT = Path(__file__).resolve().parents[1]


def etts_script(monkeypatch, path):
    """Import one of etts' scripts as a module, its ``_bootstrap`` (a
    sys.path and compile-cache set-up) replaced by an empty module and
    ``scripts/`` on the path for its sibling imports."""
    monkeypatch.setitem(sys.modules, "_bootstrap",
                        types.ModuleType("_bootstrap"))
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location(
        "etts_script_" + Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_etts_main(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *map(str, argv)])
    mod.main()


def assert_same_tree(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("extra", [[], ["--entangle_style",
                                        "--prosody_range", "wide"]])
def test_make_synth_corpus_writes_the_scripts_bytes(tmp_path, monkeypatch,
                                                    extra):
    """The same directory written by each: wavs, metadata.csv, d-vectors,
    test sentences and configs byte-equal."""
    mod = etts_script(monkeypatch, "scripts/make_synth_corpus.py")
    out = tmp_path / "corpus"
    args = ["--out", out, "--n_utts", 6, "--seed", 3, *extra]
    run_etts_main(monkeypatch, mod, args)
    out.rename(tmp_path / "etts")
    make_synth_corpus.main(list(map(str, args)))
    assert len(list((out / "wavs").glob("*.wav"))) == 6
    assert_same_tree(tmp_path / "etts", out)


def test_make_combo_file_matches_the_script(tmp_path, monkeypatch):
    meta = tmp_path / "meta.txt"
    meta.write_text("".join(f"id{i}|text {i}.|ph\n" for i in range(7)))
    mod = etts_script(monkeypatch, "scripts/make_combo_file.py")
    run_etts_main(monkeypatch, mod, ["--metafile", meta, "--out",
                                     tmp_path / "a/c.txt", "--n", 5])
    make_combo_file.main(["--metafile", str(meta), "--out",
                          str(tmp_path / "b/c.txt"), "--n", "5"])
    assert (tmp_path / "a/c.txt").read_bytes() == \
        (tmp_path / "b/c.txt").read_bytes()


def _tone(rng, f0, seconds):
    sr = 16000
    tt = np.arange(int(sr * seconds)) / sr
    wav = sum(a * np.sin(2 * np.pi * (k + 1) * f0 * tt)
              for k, a in enumerate((1.0, 0.3, 0.1)))
    wav = wav * np.hanning(len(tt)) + 0.01 * rng.standard_normal(len(tt))
    return (0.3 * wav).astype(np.float32)


def test_objective_measure_matches_the_root_script(tmp_path):
    """The same pairs (a plain name and a text__style__spk name), two model
    dirs whose leaf names collide: all_score.log and each score CSV
    byte-equal."""
    from etts_torch.data.audio_io import save_wav
    rng = np.random.default_rng(0)
    ref = tmp_path / "ref"
    ref.mkdir()
    for i, name in enumerate(("a", "b")):
        save_wav(_tone(rng, 180 + 40 * i, 0.8), ref / f"{name}.wav", 16000)
    dirs = [tmp_path / m / "syn" for m in ("m1", "m2")]
    for j, d in enumerate(dirs):
        d.mkdir(parents=True)
        save_wav(_tone(rng, 190 + 10 * j, 0.7), d / "a__b__b.wav", 16000)
        save_wav(_tone(rng, 230 + 10 * j, 0.9), d / "b.wav", 16000)
    common = ["--ref_dir", str(ref), "--syn_dirs", *map(str, dirs),
              "--workers", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "objective_measure.py"),
                          *common, "--out", str(tmp_path / "e/all_score.log")],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    objective_measure.main(common + ["--out",
                                     str(tmp_path / "p/all_score.log"),
                                     "--device", "cpu"])
    assert_same_tree(tmp_path / "e", tmp_path / "p")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "all_score.log", "score_m1_syn.csv", "score_m2_syn.csv"]


def test_gst_embeddings_of_an_ar_model_match_etts():
    """AR_TINY on seeded port weights carried to flax (no flax init)."""
    from etts.models.autoregressive import AutoregressiveTransformer as JM
    from etts_torch.models.autoregressive import (
        AutoregressiveTransformer as TM)
    tm = TM(system_type="speaker_style_text", speaker_embed_dim=SPK_DIM,
            **AR_TINY)
    variables = seeded_variables(tm, 0)
    jm = JM(system_type="speaker_style_text", **AR_TINY)
    mel = np.random.default_rng(1).normal(size=(2, 15, 12)).astype(
        np.float32)
    k = jax.random.PRNGKey(0)
    want = jm.apply(variables, jnp.asarray(mel), False, 0,
                    method=JM.encode_style,
                    rngs={"dropout": k, "prenet": k})[0][:, 0]
    with torch.no_grad():
        got = export_gst_embeddings.style_embedder(tm)(t(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gst_embeddings_of_a_tacotron_match_etts():
    jm, variables, tm = taco_pair()
    mel = np.random.default_rng(2).uniform(size=(2, 12, 10)).astype(
        np.float32)

    def fn(mdl, m):
        ref = mdl.ref_encoder(m, False)
        tokens = jnp.tanh(jnp.tile(mdl.gst_tokens_p[None],
                                   (m.shape[0], 1, 1)))
        return mdl.style_attention(ref[:, None, :], tokens)[:, 0]
    want = jm.apply(variables, jnp.asarray(mel), method=fn,
                    rngs={"prenet": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = export_gst_embeddings.style_embedder(tm.eval())(t(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _cached(seed=0, b=8, n=5, d=6):
    rng = np.random.default_rng(seed)
    cached = [(rng.normal(size=(b, n, d)).astype(np.float32),
               rng.normal(size=(b, 1, d)).astype(np.float32),
               rng.normal(size=(b, 1, d)).astype(np.float32))
              for _ in range(3)]
    labels = [rng.integers(3, 7, b) for _ in range(3)]
    return cached, labels


def test_first_token_probe_matches_etts(monkeypatch):
    """The probe's weights after etts' 400 full-batch steps within 1e-5,
    and the accuracy and chance rate equal."""
    mod = etts_script(monkeypatch, "scripts/eval_disentanglement.py")
    cached, labels = _cached()
    outs, jit = [], jax.jit

    def recording_jit(f, *a, **k):
        g = jit(f, *a, **k)

        def run(*args):
            outs.append(g(*args))
            return outs[-1]
        return run
    monkeypatch.setattr(jax, "jit", recording_jit)
    want = mod._probe_text_leakage(cached, labels, seed=1)
    monkeypatch.setattr(jax, "jit", jit)
    assert len(outs) == 400
    got = eval_disentanglement.probe_text_leakage(cached, labels, seed=1)
    assert got == want
    gst = np.concatenate([c[1][:, 0] for c in cached])
    classes, y = np.unique(np.concatenate(labels), return_inverse=True)
    tr = np.random.default_rng(1).permutation(len(y))[:int(0.75 * len(y))]
    x = (gst - gst[tr].mean(0)) / (gst[tr].std(0) + 1e-6)
    W, b = eval_disentanglement.fit_probe(x[tr], y[tr], len(classes))
    np.testing.assert_allclose(W.numpy(), np.asarray(outs[-1][0]), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(outs[-1][1]), atol=1e-5)


@pytest.mark.parametrize("kind", ["MINE", "CLUB"])
def test_fresh_critic_update_matches_etts(monkeypatch, kind):
    """The script's fresh critic (its architecture: etts' parameters load
    into it by name and shape) and one update from the same init and
    draws: gradients within 1e-5 relative (1e-6 absolute for those zero in
    exact arithmetic), the bound within 1e-5."""
    cached, _ = _cached(4)
    text, gst, spk = cached[1]
    net, _, mi_state = eval_disentanglement.fresh_critic(
        cached, "style_text", kind, 0, "cpu")
    jnet = (jmine.CLUB(pair_type="style_text", out_dim=text.shape[-1])
            if kind == "CLUB" else
            jmine.MINE(pair_type="style_text", divergence_type="KL"))
    jstate = jmine.MIState.create(1)
    key = jax.random.PRNGKey(9)
    args = (jnp.asarray(text), jnp.asarray(gst), jnp.asarray(spk))
    v = jnet.init(key, *args, jstate, key)
    _, want_mi, want_terms = j_mine_update(jnet, capture_tx(), kind=kind)(
        JState.create(v, capture_tx()), *args, jstate, key)
    new = j_mine_update(jnet, capture_tx(), kind=kind)(
        JState.create(v, capture_tx()), *args, jstate, key)[0]
    state = capture_state(load_into(net, flatten(v)))
    monkeypatch.setattr(tsteps, "pair_draws", lambda b, n, g:
                        etts_draws(key, b, n))
    mi, terms = tsteps.make_mine_update(net, kind)(
        state, t(text), t(gst), t(spk), mi_state, 0)
    assert float(mi) == pytest.approx(float(want_mi), rel=1e-5)
    np.testing.assert_allclose(terms.numpy(), np.asarray(want_terms),
                               rtol=1e-5)
    assert_grads_close(torch_grads(new.opt_state), state.grads, 1e-5, 1e-6)


def test_expressive_control_measures_match_etts(monkeypatch):
    mod = etts_script(monkeypatch, "scripts/eval_expressive_control.py")
    for spk, pros in (("spk0", (0.9, 1.15, 0.0, 5.0)),
                      ("spk2", (1.12, 0.85, 0.02, 5.0))):
        wav = make_synth_corpus.render(mod.CARRIER, spk,
                                       np.random.default_rng(0),
                                       prosody=pros)
        assert eval_expressive_control.mean_voiced_f0(wav, 16000) == \
            mod.mean_voiced_f0(wav, 16000)
        np.testing.assert_array_equal(
            eval_expressive_control.harmonic_profile(wav, 16000),
            mod.harmonic_profile(wav, 16000))


# ---------------------------------------------------------------------------
# the CLIs on a tiny seeded model (no etts); each pins the checked float32
# precision (TF32 off), as every entry point of the port does
# ---------------------------------------------------------------------------

@pytest.fixture
def tf32_on():
    """Both TF32 flags True before the call; read False after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    pinned = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before
    assert pinned == (False, False)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A 9-utterance corpus (3 held out) built by the port's
    make_synth_corpus and create_dataset, its AR config shrunk to
    TTS_SMALL, a seeded export of that model, and a 6-row combo file."""
    from etts_torch.text import default_tokenizer
    from etts_torch.utils.config import build_tts, load_config
    d = tmp_path_factory.mktemp("eval") / "corpus"
    make_synth_corpus.main(["--out", str(d), "--n_utts", "9"])
    for name, over in (("data_config.yaml", dict(n_test=3)),
                       ("autoregressive_config.yaml", TTS_SMALL)):
        cfg = yaml.safe_load((d / name).read_text())
        cfg.update(over)
        (d / name).write_text(yaml.safe_dump(cfg))
    create_dataset.main(["--config", str(d), "--phonemizer_backend",
                         "grapheme", "--device", "cpu", "--njobs", "2"])
    model = build_tts(load_config(d, "autoregressive"),
                      default_tokenizer(True).vocab_size)
    np.savez(d / "ar.npz", **seeded_flat(model, 0, std_1d=0.1))
    make_combo_file.main(["--metafile", str(d / "test_metafile.txt"),
                          "--out", str(d / "combos.txt"), "--n", "6"])
    return d


def test_synthesize_speaker_cli(workspace, tf32_on, tmp_path):
    d = workspace
    synthesize_speaker.main([
        "--tts_config", str(d), "--tts_weights", str(d / "ar.npz"),
        "--test_sentences", str(d / "test_metafile.txt"),
        "--combo_file", str(d / "combos.txt"), "--ref_audio_dir",
        str(d / "wavs"), "--spk_embed_dir", str(d / "spk_embeds"),
        "--regimes", "syn_norm", "rand", "--out_dir", str(tmp_path),
        "--max_length", "24", "--device", "cpu"])
    from etts_torch.data.audio_io import load_wav
    combos = [line.split("|") for line in
              (d / "combos.txt").read_text().split()]
    names = {"syn_norm": {f"{c[0]}__{c[0]}__{c[0]}.wav" for c in combos},
             "rand": {"__".join(c) + ".wav" for c in combos}}
    for regime, want in names.items():
        got = {p.name for p in (tmp_path / regime).glob("*.wav")}
        assert got == want
        for p in (tmp_path / regime).glob("*.wav"):
            wav, sr = load_wav(str(p))
            assert sr == 16000 and len(wav) > 0 and np.isfinite(wav).all()


def test_eval_expressive_control_cli(workspace, tf32_on, tmp_path, capsys):
    eval_expressive_control.main([
        "--config", str(workspace), "--weights",
        str(workspace / "ar.npz"), "--out_dir", str(tmp_path),
        "--n_utts", "1", "--max_length", "24", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("PITCH_TRACKING", "TEMPO_TRACKING", "SPEAKER_TRACKING"):
        assert f"{name}: PASS" in out or f"{name}: FAIL" in out
    with open(tmp_path / "expressive_control.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["kind"] for r in rows] == ["style"] * 3 + ["speaker"] * 3
    assert len(list((tmp_path / "syn").glob("*.wav"))) == 6


def test_export_gst_embeddings_cli(workspace, tf32_on, tmp_path):
    d = workspace
    export_gst_embeddings.main(["--config", str(d), "--weights",
                                str(d / "ar.npz"), "--out_dir", str(tmp_path),
                                "--device", "cpu"])
    ids = [line.split("|")[0] for line in
           (d / "train_metafile.txt").read_text().splitlines()]
    assert sorted(p.stem for p in tmp_path.glob("*.npy")) == sorted(ids)
    embed = export_gst_embeddings.style_embedder(export_gst_embeddings.
                                                 load_model(d, "autoregressive",
                                                            d / "ar.npz",
                                                            "cpu"))
    mel = np.load(d / "mels" / f"{ids[0]}.npy")
    with torch.no_grad():
        want = embed(t(mel[None]))[0].numpy()
    np.testing.assert_array_equal(np.load(tmp_path / f"{ids[0]}.npy"), want)


def test_eval_disentanglement_cli(workspace, tf32_on, tmp_path, capsys):
    eval_disentanglement.main([
        "--config", str(workspace), "--weights", str(workspace / "ar.npz"),
        "--probe_first_token", "--club", "--seeds", "1", "--critic_steps",
        "6", "--batch_size", "3", "--max_batches", "2", "--out",
        str(tmp_path / "mi.csv"), "--device", "cpu"])
    with open(tmp_path / "mi.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["pair"] for r in rows] == ["probe_first_token", "style_text",
                                         "style_text:CLUB_upper"]
    assert all(np.isfinite(float(r["mi_mean"])) for r in rows)
    assert "MINE lower bound" in capsys.readouterr().out


def test_train_ctc_asr_cli(workspace, tf32_on, tmp_path, capsys):
    from etts_torch import train_ctc_asr
    from etts_torch.evalsuite.ctc_asr import CTCTranscriber
    train_ctc_asr.main([
        "--metadata", str(workspace / "metadata.csv"), "--wav_dir",
        str(workspace / "wavs"), "--out", str(tmp_path / "ctc.npz"),
        "--steps", "2", "--n_mels", "16", "--hidden", "8", "--max_utts",
        "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training char-CTC on 4 utterances at 16000 Hz" in out
    assert "train-set WER (first 4)" in out
    tr = CTCTranscriber(str(tmp_path / "ctc.npz"), "cpu")
    assert (tr.sr, tr.n_mels, tr.model.hidden) == (16000, 16, 8)


def test_objective_measure_wer_through_a_ctc_checkpoint(workspace, tf32_on,
                                                        tmp_path,
                                                        monkeypatch):
    """WER_syn and WER_ori from the char-CTC checkpoint given by
    --ctc_asr, each the WER of its transcript."""
    from etts_torch.evalsuite import ctc_asr
    from etts_torch.evalsuite.wer import _W2V2, wer
    monkeypatch.setitem(_W2V2, "found", None)
    d = workspace
    model = ctc_asr.CTCAsrModel(n_mels=16, hidden=8).reset_parameters(
        torch.Generator().manual_seed(0))
    ctc_asr.save_ckpt(str(tmp_path / "ctc.npz"), model, 16000)
    syn = tmp_path / "syn_norm"
    syn.mkdir()
    rows = [line.split("|") for line in
            (d / "test_metafile.txt").read_text().splitlines()]
    for uid, _, _ in rows:
        shutil.copy(d / "wavs" / f"{uid}.wav", syn / f"{uid}__{uid}__{uid}.wav")
    try:
        objective_measure.main([
            "--ref_dir", str(d / "wavs"), "--syn_dirs", str(syn), "--texts",
            str(d / "test_metafile.txt"), "--ctc_asr",
            str(tmp_path / "ctc.npz"), "--workers", "1", "--out",
            str(tmp_path / "out/all_score.log"), "--device", "cpu"])
        tr = ctc_asr.default_transcriber()
    finally:
        ctc_asr.set_default_model(None)
    from etts_torch.data.audio_io import load_wav
    with open(tmp_path / "out/score_syn_norm.csv") as f:
        scored = list(csv.DictReader(f))
    assert len(scored) == len(rows)
    for r, (uid, text, _) in zip(scored, rows):
        want = wer(text, tr.transcribe_wav(*load_wav(str(d / "wavs" /
                                                          f"{uid}.wav"))))
        assert float(r["WER_syn"]) == float(r["WER_ori"]) == want
        assert float(r["MCD"]) == 0.0
