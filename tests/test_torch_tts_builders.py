"""The TTS models' stores of the port against etts' on the same seeded
wavs, on the CPU:

  - ``build_tts_dataset`` (the AR and forward models' store) with the
    rule and the espeak backends: ``phonemes.npy``, the seeded split and
    both metafiles equal, byte for byte; every mel within MEL_TOL; the
    phoneme cache reused and recomputed; ``python -m
    etts_torch.create_dataset``, which writes the backend it was given
    into ``data_config.yaml`` and raises without one;
  - the espeak backend through a fake ``espeak-ng`` that replays
    ``tests/fixtures/espeak_en_us_ipa.tsv`` (``test_espeak_contract``'s):
    each recorded chunk, with and without stress, and the pipeline's ids,
    against etts';
  - ``build_tacotron_dataset`` in the LJSpeech layout and the Blizzard
    one (a wav cut to its ``.lab`` labels' speech, rows under the
    confidence bar skipped, an utterance over ``max_out_frames`` dropped
    and its index left out of the file names): ``train.txt`` equal, every
    spectrogram within TACO_TOL."""
import numpy as np
import pytest
import torch
import yaml

from etts.data.builders import build_tts_dataset as j_build_tts
from etts.data.taco_builders import build_tacotron_dataset as j_build_taco
from etts.text import Pipeline as JPipeline
from etts.text.tokenizer import EspeakBackend as JEspeak
from etts_torch import create_dataset
from etts_torch.data.audio_io import save_wav
from etts_torch.data.builders import build_tts_dataset
from etts_torch.data.taco_builders import build_tacotron_dataset
from etts_torch.text import Pipeline
from etts_torch.text.tokenizer import EspeakBackend
from test_espeak_contract import fake_espeak  # noqa: F401  (a fixture)
from torch_parity import VOC_AUDIO, voc_wav

MEL_TOL = 1e-5          # tests/test_torch_vocoder_data.py's
TACO_TOL = 2e-5         # tests/test_torch_tacotron_frontend.py's
# sentences whose every chunk the fake espeak has recorded
TEXTS = ("hello world, the quick brown fox.", "good morning!",
         "what time is it? short.", "one two three, four five six.",
         "thank you very much.", "the cat sat on the mat.",
         "keep calm and carry on.")
AUDIO = dict(VOC_AUDIO, normalizer="MelGAN", phoneme_language="en",
             n_test=2)


def _corpus(d, n=len(TEXTS), seed=0, lengths=None):
    """n seeded wavs (of ``lengths``, else of 200-600 samples) under
    d/wavs and their
    ``metadata.csv`` (ids with and without a ``.wav`` suffix, three
    columns), with AUDIO's data_config.yaml writing the store to
    d/store."""
    rng = np.random.default_rng(seed)
    (d / "wavs").mkdir(parents=True)
    lines = []
    for i in range(n):
        size = (int(rng.integers(200, 601)) if lengths is None
                else lengths[i % len(lengths)])
        save_wav(voc_wav(rng, size),
                 d / "wavs" / f"u{i}.wav", 16000)
        name = f"u{i}.wav" if i % 2 else f"u{i}"
        lines.append(f"{name}|{TEXTS[i % len(TEXTS)].upper()}|"
                     f"{TEXTS[i % len(TEXTS)]}\n")
    (d / "metadata.csv").write_text("".join(lines), encoding="utf-8")
    config = dict(AUDIO, data_directory=str(d),
                  train_data_directory=str(d / "store"))
    (d / "data_config.yaml").write_text(yaml.safe_dump(config))
    return config


def _compare_tts_stores(got, want, n):
    for name in ("train_metafile.txt", "test_metafile.txt"):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    np.testing.assert_array_equal(np.load(got / "phonemes.npy"),
                                  np.load(want / "phonemes.npy"))
    mels = sorted(p.name for p in (want / "mels").glob("*.npy"))
    assert sorted(p.name for p in (got / "mels").glob("*.npy")) == mels
    assert len(mels) == n
    for name in mels:
        m, w = np.load(got / "mels" / name), np.load(want / "mels" / name)
        assert m.dtype == w.dtype == np.float32 and m.shape == w.shape
        assert m.shape[1] == AUDIO["mel_channels"]
        np.testing.assert_allclose(m, w, atol=MEL_TOL, err_msg=name)


def _build_both(tmp_path, backend):
    config = _corpus(tmp_path)
    want = tmp_path / "etts_store"
    j_build_tts(dict(config, train_data_directory=str(want)), njobs=2,
                phonemizer_backend=backend, progress=False)
    build_tts_dataset(config, njobs=2, phonemizer_backend=backend,
                      device="cpu")
    return config, tmp_path / "store", want


def test_build_tts_dataset_matches_etts(tmp_path):
    """The rule backend. The split: 2 test rows, the other 5 but the last
    shuffled row for training (etts drops it); every mel written."""
    config, got, want = _build_both(tmp_path, "rule")
    _compare_tts_stores(got, want, len(TEXTS))
    train = (got / "train_metafile.txt").read_text().splitlines()
    test = (got / "test_metafile.txt").read_text().splitlines()
    assert len(test) == 2 and len(train) == len(TEXTS) - 3
    rows = np.load(got / "phonemes.npy")
    perm = rows.copy()
    np.random.RandomState(42).shuffle(perm)
    assert [ln.split("|")[0] for ln in test + train] == list(perm[:-1, 0])
    assert {r.split("|")[0] for r in train + test} <= {f"u{i}" for i in
                                                      range(len(TEXTS))}
    # the cache: read back while the metadata is gone; then recomputed
    meta = tmp_path / "metadata.csv"
    text = meta.read_text()
    meta.unlink()
    build_tts_dataset(config, njobs=1, phonemizer_backend="rule",
                      device="cpu")
    _compare_tts_stores(got, want, len(TEXTS))
    meta.write_text(text.replace("hello world", "hello there"))
    build_tts_dataset(config, njobs=1, phonemizer_backend="rule",
                      recompute_phonemes=True, device="cpu")
    assert "hello there" in " ".join(np.load(got / "phonemes.npy")[:, 1])


def test_build_tts_dataset_espeak_matches_etts(tmp_path, fake_espeak):
    _, got, want = _build_both(tmp_path, "espeak")
    _compare_tts_stores(got, want, len(TEXTS))
    assert "ð" in " ".join(np.load(got / "phonemes.npy")[:, 2])


def test_espeak_backend_matches_etts(fake_espeak):
    """Every 15th recorded chunk (each a process of the fake binary),
    with and without stress; the pipeline's ids with stress (the store's
    test runs every sentence of TEXTS through both without)."""
    for stress in (True, False):
        port, ref = EspeakBackend("en", stress), JEspeak("en", stress)
        for chunk, _ in fake_espeak[stress::15]:
            assert port(chunk) == ref(chunk), chunk
    port = Pipeline.default_pipeline("en", add_start_end=True,
                                     with_stress=True, backend="espeak")
    ref = JPipeline.default_pipeline("en", add_start_end=True,
                                     with_stress=True, backend="espeak")
    assert port(TEXTS[2]) == ref(TEXTS[2])


def test_create_dataset_cli(tmp_path):
    """Without a backend it raises (the port's phonemizer has no silent
    fallback); with one it writes the store ``build_tts_dataset`` writes
    and records the backend in data_config.yaml; it pins float32 and
    refuses the card's device without a card, as both builders do by
    default."""
    config = _corpus(tmp_path)
    argv = ["--config", str(tmp_path), "--njobs", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="phonemizer backend"):
        create_dataset.main(argv)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    create_dataset.main(argv + ["--phonemizer_backend", "grapheme"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    written = yaml.safe_load((tmp_path / "data_config.yaml").read_text())
    assert written == dict(config, phonemizer_backend="grapheme")
    want = tmp_path / "direct"
    build_tts_dataset(dict(config, train_data_directory=str(want)),
                      njobs=1, phonemizer_backend="grapheme",
                      device="cpu")
    _compare_tts_stores(tmp_path / "store", want, len(TEXTS))
    # the backend recorded in the config is enough now
    create_dataset.main(argv + ["--recompute_phon"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_dataset.main(argv[:-2] + ["--device", "cuda"])
        # both builders default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_tts_dataset(config, njobs=1, phonemizer_backend="rule")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_tacotron_dataset(config, njobs=1)


def _compare_taco_stores(got, want):
    lines = (want / "train.txt").read_text(encoding="utf-8")
    assert (got / "train.txt").read_text(encoding="utf-8") == lines
    files = sorted(p.name for p in want.glob("taco-*.npy"))
    assert sorted(p.name for p in got.glob("taco-*.npy")) == files
    for name in files:
        g, w = np.load(got / name), np.load(want / name)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TACO_TOL, err_msg=name)
    return [ln.split("|") for ln in lines.splitlines()]


def test_build_tacotron_dataset_ljspeech_matches_etts(tmp_path):
    config = _corpus(tmp_path, n=4, lengths=(720,))
    got = build_tacotron_dataset(config, njobs=2, device="cpu")
    want = j_build_taco(config, out_dir=tmp_path / "etts_taco", njobs=2,
                        progress=False)
    assert got == str(tmp_path / "taco_training")
    rows = _compare_taco_stores(tmp_path / "taco_training",
                                tmp_path / "etts_taco")
    assert [r[3] for r in rows] == list(TEXTS[:4])
    for lin_f, mel_f, frames, _ in rows:
        lin = np.load(tmp_path / "taco_training" / lin_f)
        mel = np.load(tmp_path / "taco_training" / mel_f)
        assert lin.shape == (int(frames), AUDIO["n_fft"] // 2 + 1)
        assert mel.shape == (int(frames), AUDIO["mel_channels"])


def _blizzard(d):
    """One book (the second is missing, and skipped): 5 index rows, one
    under the confidence bar, one a comment; .lab files cutting 0.005 s
    at the start and ending 0.05 s after the label before a trailing
    "sil", one row without a .lab (kept whole); wavs of 800 samples (720
    where there is no .lab: one length to compile on etts' side) but one
    of 1600, over max_out_frames 100 at hop 10."""
    book = d / "ATrampAbroad"
    for sub in ("wav", "lab"):
        (book / sub).mkdir(parents=True)
    rng = np.random.default_rng(7)
    rows = ["# a comment\tx\tx\tx\tx\tx\tx\tx"]
    for i, conf in enumerate((99.0, 95.0, 80.0, 97.0, 93.0)):
        name = f"chapter_{i}"
        save_wav(voc_wav(rng, {3: 1600, 4: 720}.get(i, 800)),
                 book / "wav" / f"{name}.wav", 16000)
        rows.append("\t".join([name, "0", "1", str(conf), "x", TEXTS[i],
                               "x", "x"]))
        if i != 4:
            (book / "lab" / f"{name}.lab").write_text(
                "#\n0.005 125 sil\n0.02 125 hh\n0.03 125 ah\n"
                "0.045 125 sil\n")
    (book / "sentence_index.txt").write_text("\n".join(rows) + "\n",
                                             encoding="utf-8")
    return dict(AUDIO, data_directory=str(d))


def test_build_tacotron_dataset_blizzard_matches_etts(tmp_path):
    config = _blizzard(tmp_path)
    kw = dict(dataset_format="blizzard", max_out_frames=100, njobs=2)
    build_tacotron_dataset(config, out_dir=tmp_path / "got", device="cpu",
                           **kw)
    j_build_taco(config, out_dir=tmp_path / "want", progress=False, **kw)
    rows = _compare_taco_stores(tmp_path / "got", tmp_path / "want")
    # rows 0, 1 and 4 of the index kept (2 is under the bar); the wav of
    # row 3 is over 100 hops and its index 2 is left out of the names
    assert [r[3] for r in rows] == [TEXTS[0], TEXTS[1], TEXTS[4]]
    assert [r[1] for r in rows] == [f"taco-mel-{i:05d}.npy"
                                    for i in (0, 1, 3)]
    # cut to 0.005-0.08 s: samples 80 to 800 of 800, 1 + 720 // 10
    # frames; the row without a .lab whole, 720 samples
    assert [int(r[2]) for r in rows] == [73, 73, 73]
