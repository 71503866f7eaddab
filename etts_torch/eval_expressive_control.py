"""Measure the expressive control of a trained GST + speaker AR model (port
of ``scripts/eval_expressive_control.py``).

    python -m etts_torch.eval_expressive_control --config DIR \\
        --weights ar.npz --step 14000 --out_dir OUT [--n_utts 6] \\
        [--max_length 600] [--styles default|wide] \\
        [--phonemizer_backend grapheme] [--device cuda|cpu]

On the synthetic corpus (``make_synth_corpus``), whose prosody (pitch
scale, tempo) stands in for the reference's styles:

  1. style transfer: each held-out sentence under three CONTROLLED
     reference prosodies (low/slow, neutral, high/fast carrier audio with
     pinned prosody); the output's mean voiced F0 must rank with the
     reference pitch, its length with the reference tempo;
  2. speaker transfer: the same sentence with the neutral style under each
     speaker's d-vector; the output, classified by its harmonic profile,
     must follow the CONDITIONED speaker.

Two sanity checks come first: the carriers' own F0 must rank, and the
classifier must name the ground-truth speakers of the corpus (> 0.9);
where either fails the evaluation is void and this raises. The wavs come
from Griffin-Lim (32 iterations). Writes ``expressive_control.csv`` and
the wavs under ``--out_dir`` and prints PITCH_TRACKING, TEMPO_TRACKING and
SPEAKER_TRACKING as PASS or FAIL. The corpus is the config's
``data_directory`` (its ``wavs/``, ``test_metafile.txt``,
``spk_embeds/``). A flat npz export and its step replace etts' session.
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from .make_synth_corpus import SPEAKERS, SR as CORPUS_SR, render

# (pitch_scale, tempo, vib_depth, vib_rate) — corpus analogue of the
# reference's commanding / neutral / question reference audio
STYLES = {
    "low_slow": (0.90, 1.15, 0.00, 5.0),
    "neutral": (1.00, 1.00, 0.01, 5.0),
    "high_fast": (1.12, 0.85, 0.02, 5.0),
}
# carriers spanning the wide corpus range (make_synth_corpus.WIDE_RANGES),
# for models trained with --prosody_range wide
STYLES_WIDE = {
    "low_slow": (0.78, 1.35, 0.00, 5.0),
    "neutral": (1.00, 1.00, 0.01, 5.0),
    "high_fast": (1.30, 0.70, 0.02, 5.0),
}
CARRIER = "do me ku ri na su"  # fixed mid-register carrier sentence


def mean_voiced_f0(wav, sr):
    from .evalsuite.metrics import f0_autocorr
    f0 = f0_autocorr(wav, sr, fmin=100.0, fmax=800.0)
    voiced = f0[f0 > 0]
    return float(voiced.mean()) if voiced.size else 0.0


def harmonic_profile(wav, sr, n_harm=4):
    """Pitch-invariant timbre: mean normalized amplitudes of harmonics
    1..n_harm relative to the frame's F0, the quantity the corpus's
    per-speaker timbre sets (``make_synth_corpus.SPEAKERS``), so the
    nearest profile is the corpus's own speaker ID."""
    from .evalsuite.metrics import f0_autocorr
    wav = np.asarray(wav)
    f0s = f0_autocorr(wav, sr, fmin=100.0, fmax=800.0)
    frame = int(sr * 0.040)
    hop = int(sr * 0.010)
    win = np.hanning(frame)
    freqs = np.fft.rfftfreq(frame, 1 / sr)
    profs = []
    for t, f0 in enumerate(f0s):
        if f0 <= 0:
            continue
        seg = wav[t * hop:t * hop + frame]
        if len(seg) < frame:
            break
        sp = np.abs(np.fft.rfft(seg * win))
        amps = []
        for k in range(1, n_harm + 1):
            idx = int(np.argmin(np.abs(freqs - k * f0)))
            amps.append(sp[max(0, idx - 2):idx + 3].max())
        amps = np.asarray(amps)
        if amps[0] > 1e-6:
            profs.append(amps / (np.linalg.norm(amps) + 1e-12))
    return (np.mean(profs, axis=0) if profs else np.zeros(n_harm))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--weights", required=True, help="flat npz export")
    p.add_argument("--step", type=int, default=0,
                   help="training step of the export (sets r and the "
                        "prenet dropout)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_utts", type=int, default=6)
    p.add_argument("--max_length", type=int, default=600)
    p.add_argument("--styles", choices=["default", "wide"], default="default",
                   help="'wide' probes carriers spanning the wide-prosody "
                        "corpus range (for --prosody_range wide models)")
    p.add_argument("--phonemizer_backend", default=None,
                   choices=["espeak", "grapheme", "rule"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    styles = STYLES_WIDE if a.styles == "wide" else STYLES

    import torch

    from .api import TTSSynthesizer
    from .data.audio_io import load_wav, save_wav

    out_dir = Path(a.out_dir)
    (out_dir / "syn").mkdir(parents=True, exist_ok=True)
    tts = TTSSynthesizer(a.config, a.weights, a.device, step=a.step,
                         phonemizer_backend=a.phonemizer_backend)
    sr = tts.config["sampling_rate"]
    if sr != CORPUS_SR:
        raise ValueError(f"the model's rate {sr} Hz is not the corpus' "
                         f"{CORPUS_SR} Hz")
    cfg_dir = Path(tts.config.get("data_directory") or a.config)
    print(f"the export of step {a.step}")

    def synth(text, ref_mel, spk, seed):
        mel = tts.predict(text, ref_mel=ref_mel, spk_embed=spk,
                          max_length=a.max_length, seed=seed)
        wav = tts.audio.reconstruct_waveform(
            torch.from_numpy(mel["mel"].T).to(tts.device), n_iter=32)
        return mel, wav.cpu().numpy()

    # ---- controlled style references ------------------------------------
    # per-speaker carriers: training refs are always matched-speaker, so a
    # cross-timbre carrier would be out of distribution for the GST encoder
    ref_wavs = {(s, spk): render(CARRIER, spk, np.random.default_rng(0),
                                 prosody=pros)
                for s, pros in styles.items() for spk in SPEAKERS}
    ref_mels = {k: tts.mel_from_wav(w) for k, w in ref_wavs.items()}
    ref_f0 = {s: mean_voiced_f0(ref_wavs[(s, "spk0")], sr) for s in styles}
    print("carrier reference mean F0:",
          {s: round(v, 1) for s, v in ref_f0.items()})
    if not ref_f0["high_fast"] > ref_f0["neutral"] > ref_f0["low_slow"]:
        raise RuntimeError("F0 measure cannot resolve the corpus's own pitch "
                           "contrast (void)")

    # ---- speaker classifier (analytic harmonic profiles) + sanity --------
    refp = {s: np.asarray(v) / np.linalg.norm(v)
            for s, v in SPEAKERS.items()}
    spk_names = sorted(refp)

    def classify(wav):
        prof = harmonic_profile(wav, sr)
        sims = {s: float(np.dot(prof, r)) for s, r in refp.items()}
        return max(sims, key=sims.get)

    gt_files = sorted((cfg_dir / "wavs").glob("*.wav"))[:30]
    gt_acc = np.mean([classify(load_wav(str(f), sr)[0])
                      == f.name.split("_")[0] for f in gt_files])
    print(f"GT speaker-classifier sanity accuracy: {gt_acc:.2f}")
    if not gt_acc > 0.9:
        raise RuntimeError("timbre classifier cannot separate GT speakers "
                           "(void)")

    # held-out sentences + their own d-vectors
    rows = []
    with open(cfg_dir / "test_metafile.txt", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 2:
                rows.append((parts[0], parts[1]))
    rows = rows[:a.n_utts]
    dvecs = {s: np.load(sorted((cfg_dir / "spk_embeds").glob(f"{s}_*.npy"))[0])
             for s in spk_names}

    records = []
    # ---- 1. style transfer: same sentence under 3 reference prosodies ----
    for i, (uid, text) in enumerate(rows):
        own_spk = uid.split("_")[0]
        gst_by_style = {}
        for style in styles:
            out, wav = synth(text, ref_mels[(style, own_spk)], dvecs[own_spk],
                             i)
            if out.get("gst_attention") is not None:
                gst_by_style[style] = np.asarray(
                    out["gst_attention"]["gst_attention"]).ravel()
            save_wav(wav, str(out_dir / "syn" / f"{uid}_{style}.wav"), sr)
            records.append(dict(
                kind="style", uid=uid, text=text, style=style,
                cond_spk=own_spk, frames=out["mel"].shape[0],
                out_f0=round(mean_voiced_f0(wav, sr), 2),
                ref_f0=round(ref_f0[style], 2)))
            print(f"{uid} [{style}]: {out['mel'].shape[0]}f "
                  f"F0 {records[-1]['out_f0']:.0f}Hz")
        if len(gst_by_style) == len(styles):
            # do the three references even give distinct GST attention? If
            # not, the style bottleneck is saturated and nothing can track
            lo, ne, hi = (gst_by_style[s] for s in
                          ("low_slow", "neutral", "high_fast"))
            d = np.linalg.norm(lo - hi) / (np.linalg.norm(ne) + 1e-9)
            print(f"  gst(low vs high) relative distance: {d:.4f}")

    # ---- 2. speaker transfer: neutral style, swapped d-vectors -----------
    for i, (uid, text) in enumerate(rows):
        for spk in spk_names:
            out, wav = synth(text, ref_mels[("neutral", spk)], dvecs[spk],
                             100 + i)
            save_wav(wav, str(out_dir / "syn" / f"{uid}_as_{spk}.wav"), sr)
            pred_spk = classify(wav)
            records.append(dict(kind="speaker", uid=uid, text=text,
                                style="neutral", cond_spk=spk,
                                frames=out["mel"].shape[0], pred_spk=pred_spk))
            print(f"{uid} [spk={spk}]: classified {pred_spk} "
                  f"{'OK' if pred_spk == spk else 'MISS'}")

    # ---- verdicts ---------------------------------------------------------
    sty = [r for r in records if r["kind"] == "style"]
    by_style = {s: [r for r in sty if r["style"] == s] for s in styles}
    mean_f0 = {s: float(np.mean([r["out_f0"] for r in by_style[s]
                                 if r["out_f0"]])) for s in styles}
    mean_frames = {s: float(np.mean([r["frames"] for r in by_style[s]]))
                   for s in styles}
    pitch_pass = (mean_f0["high_fast"] > mean_f0["neutral"] * 1.02
                  and mean_f0["neutral"] > mean_f0["low_slow"] * 1.02)
    tempo_pass = mean_frames["low_slow"] > mean_frames["high_fast"] * 1.05
    spkr = [r for r in records if r["kind"] == "speaker"]
    spk_acc = np.mean([r["pred_spk"] == r["cond_spk"] for r in spkr])
    spk_pass = spk_acc >= 2 / 3

    with open(out_dir / "expressive_control.csv", "w", newline="") as f:
        cols = ["kind", "uid", "text", "style", "cond_spk", "frames",
                "out_f0", "ref_f0", "pred_spk"]
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in records:
            w.writerow({c: r.get(c, "") for c in cols})

    print("\n=== expressive control verdict ===")
    print(f"mean output F0 by style: "
          f"{ {s: round(v, 1) for s, v in mean_f0.items()} } "
          f"(ref: { {s: round(ref_f0[s], 1) for s in styles} })")
    print(f"mean output frames by style: "
          f"{ {s: round(v, 1) for s, v in mean_frames.items()} }")
    print(f"speaker-swap classification accuracy: {spk_acc:.2f} "
          f"(chance {1 / len(spk_names):.2f})")
    print(f"PITCH_TRACKING: {'PASS' if pitch_pass else 'FAIL'}")
    print(f"TEMPO_TRACKING: {'PASS' if tempo_pass else 'FAIL'}")
    print(f"SPEAKER_TRACKING: {'PASS' if spk_pass else 'FAIL'}")


if __name__ == "__main__":
    main()
