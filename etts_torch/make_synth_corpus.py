"""Write the learnable synthetic speech-like corpus (own copy of
``scripts/make_synth_corpus.py``, numpy only; the wavs written with the
port's ``data/audio_io.save_wav``).

    python -m etts_torch.make_synth_corpus --out DIR [--n_utts 300] \\
        [--seed 0] [--n_test_sentences 8] [--entangle_style] \\
        [--prosody_range default|wide]

Tone words with a fixed word -> f0 mapping (the text predicts the audio),
a harmonic timbre per "speaker" (so the d-vectors carry information) and a
prosody contour per utterance (pitch, tempo, vibrato: style for the GST
encoder). Writes ``wavs/``, ``metadata.csv`` (id|text), ``spk_embeds/``
(one fixed 256-d vector per speaker, standing in for GE2E d-vectors),
``ref_audio/test_sentence``, and ``data_config.yaml``,
``autoregressive_config.yaml`` (the soak schedules) and
``wavernn_config.yaml`` from ``configs/default``. Then ``python -m
etts_torch.create_dataset --config DIR --phonemizer_backend grapheme``.
The same seed writes the same bytes as the script.
"""
import argparse
from pathlib import Path

import numpy as np
import yaml

SR = 16000
# word -> fundamental (Hz); text is fully predictive of the waveform
WORDS = {"ba": 180.0, "do": 220.0, "gi": 262.0, "ku": 311.0, "me": 370.0,
         "na": 415.0, "po": 466.0, "ri": 523.0, "su": 587.0, "te": 659.0}
# per-speaker harmonic amplitude profile (timbre)
SPEAKERS = {
    "spk0": (1.0, 0.30, 0.10, 0.02),
    "spk1": (0.6, 0.60, 0.25, 0.10),
    "spk2": (1.0, 0.05, 0.40, 0.20),
}


DEFAULT_RANGES = dict(pitch=(0.9, 1.12), tempo=(0.85, 1.15),
                      vib_depth=(0.0, 0.02), vib_rate=(3.0, 7.0))
# ROADMAP r5 #2: at the default ±10% pitch / ±15% tempo the prosody
# dimensions barely move the training loss, so the decoder learns to ignore
# the GST (round-4 PITCH/TEMPO_TRACKING FAIL). The wide ranges make prosody
# a first-order factor of the corpus variance.
WIDE_RANGES = dict(pitch=(0.75, 1.35), tempo=(0.65, 1.45),
                   vib_depth=(0.0, 0.03), vib_rate=(3.0, 7.0))


def render(text: str, speaker: str, style_rng: np.random.Generator,
           entangle_style: bool = False, prosody=None, ranges=None):
    """Render one utterance: tone words with speaker timbre and a smooth
    per-utterance prosody contour (pitch scale, energy envelope, tempo).

    ``entangle_style=True`` makes the prosody a (noisy) deterministic
    function of the FIRST word, so MI(style, text) is positive by
    construction — the corpus variant for measuring whether MINE training
    actually disentangles (``etts_torch.eval_disentanglement``); the default
    keeps style independent of text (and the original rng draw order, so
    existing corpora regenerate bit-identically).

    ``prosody=(pitch_scale, tempo, vib_depth, vib_rate)`` pins the contour
    explicitly — used by ``etts_torch.eval_expressive_control`` to build
    controlled style references (the corpus analogue of the reference's
    sarcasm/commanding/question reference audio).
    """
    harm = SPEAKERS[speaker]
    r = ranges or DEFAULT_RANGES
    if prosody is not None:
        pitch_scale, tempo, vib_depth, vib_rate = prosody
    elif entangle_style:
        frac = list(WORDS).index(text.split()[0]) / (len(WORDS) - 1)
        pitch_scale = 0.9 + 0.2 * frac + style_rng.uniform(-0.01, 0.01)
        tempo = 1.12 - 0.25 * frac + style_rng.uniform(-0.02, 0.02)
        vib_depth = 0.02 * frac
        vib_rate = 3.0 + 4.0 * frac
    else:
        pitch_scale = style_rng.uniform(*r["pitch"])
        tempo = style_rng.uniform(*r["tempo"])
        vib_depth = style_rng.uniform(*r["vib_depth"])
        vib_rate = style_rng.uniform(*r["vib_rate"])
    segs = []
    for w in text.split():
        dur = 0.26 * tempo
        t = np.arange(int(SR * dur)) / SR
        f0 = WORDS[w] * pitch_scale * (
            1.0 + vib_depth * np.sin(2 * np.pi * vib_rate * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        tone = sum(a * np.sin((i + 1) * phase) for i, a in enumerate(harm))
        env = np.hanning(len(t)) ** 0.5
        segs.append(0.45 * tone * env)
        segs.append(np.zeros(int(SR * 0.06 * tempo)))
    wav = np.concatenate(segs)
    wav = wav + 0.002 * style_rng.standard_normal(len(wav))
    return np.clip(wav, -1.0, 1.0).astype(np.float32)


SOAK_OVERRIDES = dict(
    max_steps=20000,
    reduction_factor_schedule=[[0, 10], [3000, 5], [8000, 2]],
    decoder_prenet_dropout_schedule=[[0, 0.0], [8000, 0.0], [12000, 0.5]],
    head_drop_schedule=[[0, 0]],
    weights_save_frequency=2000,
    keep_n_weights=4,
    prediction_frequency=5000,
    prediction_start_step=4000,
    audio_start_step=10 ** 9,           # GL audio logging off (soak speed)
    train_images_plotting_frequency=5000,
    n_steps_avg_losses=[100, 1000],
)


CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "default"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--n_utts", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_test_sentences", type=int, default=8)
    parser.add_argument("--entangle_style", action="store_true",
                        help="prosody correlates with the first word "
                        "(positive MI(style, text) by construction)")
    parser.add_argument("--prosody_range", choices=["default", "wide"],
                        default="default",
                        help="'wide' makes pitch/tempo first-order factors "
                        "of the corpus variance (ROADMAP r5 #2)")
    args = parser.parse_args(argv)

    out = Path(args.out)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    (out / "spk_embeds").mkdir(exist_ok=True)
    rng = np.random.default_rng(args.seed)
    words = list(WORDS)
    speakers = list(SPEAKERS)
    # fixed per-speaker "d-vector"
    spk_vecs = {s: rng.standard_normal(256).astype(np.float32) * 0.3
                for s in speakers}

    from .data.audio_io import save_wav
    lines = []
    ranges = WIDE_RANGES if args.prosody_range == "wide" else DEFAULT_RANGES
    for i in range(args.n_utts):
        text = " ".join(rng.choice(words, size=rng.integers(4, 10)))
        speaker = speakers[i % len(speakers)]
        wav = render(text, speaker, rng,
                     entangle_style=args.entangle_style, ranges=ranges)
        uid = f"{speaker}_utt{i:04d}"
        save_wav(wav, str(out / "wavs" / f"{uid}.wav"), SR)
        np.save(out / "spk_embeds" / f"{uid}.npy", spk_vecs[speaker])
        lines.append(f"{uid}|{text}\n")
    (out / "metadata.csv").write_text("".join(lines))

    # held-out synthesis prompts (synthesize_sentences.py input format)
    test_dir = out / "ref_audio"
    test_dir.mkdir(exist_ok=True)
    test_lines = [" ".join(rng.choice(words, size=rng.integers(4, 9)))
                  for _ in range(args.n_test_sentences)]
    (test_dir / "test_sentence").write_text(
        "".join(f"{t}\n" for t in test_lines))

    # full default data_config (mel sentinels, n_samples caps, ...) with the
    # corpus-specific fields overridden
    data_cfg = yaml.safe_load(open(CONFIGS / "data_config.yaml"))
    data_cfg.update(dict(
        data_directory=str(out), phoneme_language="en",
        sampling_rate=SR, n_fft=2048, hop_length=200, win_length=800,
        mel_channels=80, f_min=40, f_max=None, normalizer="WaveRNN",
        n_test=20, text_path=str(test_dir / "test_sentence"),
        log_directory=str(out / "checkpoints")))
    yaml.safe_dump(data_cfg, open(out / "data_config.yaml", "w"))

    base = yaml.safe_load(open(CONFIGS / "autoregressive_config.yaml"))
    base.update(SOAK_OVERRIDES)
    yaml.safe_dump(base, open(out / "autoregressive_config.yaml", "w"))
    # wavernn config for the vocoder soak phase
    wv = yaml.safe_load(open(CONFIGS / "wavernn_config.yaml"))
    wv["voc_total_steps"] = wv.get("voc_total_steps", 0) or 0
    yaml.safe_dump(wv, open(out / "wavernn_config.yaml", "w"))
    print(f"synthetic corpus: {args.n_utts} utts, {len(speakers)} speakers "
          f"-> {out}")


if __name__ == "__main__":
    main()
