"""GST-Tacotron synthesis CLI (counterpart of ``scripts/eval_tacotron.py``):
text (+ a reference wav's style) -> wav through the linear-spectrogram
Griffin-Lim head, trimmed at the first long silence, with an alignment
plot where matplotlib imports.

    python -m etts_torch.eval_tacotron --config configs/default \\
        --weights taco.npz [--reference_audio ref.wav] \\
        [--sentences "..." | --sentences_file id_text.txt] [--device cuda]

``--weights`` is a flat npz export (``scripts/export_params_npz.py
--model_kind tacotron``); the config dir holds ``tacotron_config.yaml`` and
``data_config.yaml``. Writes ``<out_dir>/<id>.wav`` (16-bit PCM, divided
by its peak where that exceeds 1, as etts' ``save_wav``) and
``<id>_align.png``. The reference wav must be 16-bit PCM at the config's
rate (etts resamples; the port reads it as ``synthesize.read_wav`` does).
Every sentence decodes with seed 0, as etts' default key.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SENTENCES = [
    "Scientists at the CERN laboratory say they have discovered a new particle.",
    "There's a way to measure the acute emotional intelligence that has never gone out of style.",
    "President Trump met with other leaders at the Group of Twenty conference.",
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--weights", required=True, help="flat npz export")
    p.add_argument("--sentences", nargs="*", default=None)
    p.add_argument("--sentences_file", default=None,
                   help="id|text metafile: synthesize each row and name "
                   "the output <id>.wav")
    p.add_argument("--reference_audio", default=None)
    p.add_argument("--out_dir", default="taco_out")
    p.add_argument("--n_utts", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    import torch

    from .api import TacotronSynthesizer
    from .data.taco_audio import find_endpoint, taco_linear_and_mel
    from .synthesize import read_wav, write_wav
    from .utils.precision import pin_float32
    pin_float32()
    synth = TacotronSynthesizer(a.config, a.weights, a.device)
    sr = synth.config["sampling_rate"]
    out_dir = Path(a.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    ref_mel = None
    if a.reference_audio:
        y = torch.from_numpy(read_wav(a.reference_audio, sr))
        _, ref_mel = taco_linear_and_mel(y.to(synth.device), synth.config)

    rows = [(f"eval_{i}", t) for i, t in enumerate(a.sentences or SENTENCES)]
    if a.sentences_file:
        with open(a.sentences_file, encoding="utf-8") as f:
            rows = [(parts[0], parts[1]) for parts in
                    (line.strip().split("|") for line in f)
                    if len(parts) >= 2][:a.n_utts]
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None

    for uid, text in rows:
        print(f"[{uid}] {text!r}")
        wav, alignment = synth.synthesize(text, reference_mel=ref_mel)
        wav = wav[:find_endpoint(wav, sr)]
        write_wav(out_dir / f"{uid}.wav",
                  wav / max(1.0, float(np.abs(wav).max(initial=0.0))), sr)
        if plt is not None:
            plt.figure(figsize=(8, 4))
            plt.imshow(alignment.T, aspect="auto", origin="lower")
            plt.xlabel("decoder step")
            plt.ylabel("encoder step")
            plt.savefig(out_dir / f"{uid}_align.png", dpi=120)
            plt.close()
    print(f"Wrote outputs to {out_dir}")


if __name__ == "__main__":
    main()
