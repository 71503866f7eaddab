"""Vocode with a trained WaveRNN session (port of the root
``gen_wavernn.py``).

    python -m etts_torch.gen_wavernn --config DIR [--session_name NAME] \\
        (--file MEL.npy | --data STORE [--samples 5]) \\
        [--batched | --unbatched] [--target N] [--overlap N] \\
        [--out_dir voc_out] [--device cuda|cpu]

The weights are the latest checkpoint of the ``train_wavernn`` session
(``VocoderSynthesizer(DIR, session_name=...)``). ``--file`` vocodes one
mel (``.npy``, (n_mels, t) as the store keeps it, or (t, n_mels)), in the
vocoder's [0, 1] convention; ``--data`` the last ``--samples`` utterances
of ``STORE/dataset.pkl`` from ``STORE/mel/``. Each goes through the sample
loop (B1 on the card), folded unless ``--unbatched``, to
``{out_dir}/{name}_{batched|unbatched}.wav``.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from .api import VocoderSynthesizer
from .data.audio_io import save_wav
from .utils.precision import pin_float32


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--file", default=None,
                        help="one mel .npy ((n_mels, t) or (t, n_mels))")
    parser.add_argument("--data", default=None,
                        help="vocoder store for test-set generation")
    parser.add_argument("--samples", type=int, default=5)
    parser.add_argument("--batched", dest="batched", action="store_true")
    parser.add_argument("--unbatched", dest="batched", action="store_false")
    parser.set_defaults(batched=True)
    parser.add_argument("--target", type=int, default=None)
    parser.add_argument("--overlap", type=int, default=None)
    parser.add_argument("--out_dir", default="voc_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not (args.file or args.data):
        parser.error("need --file or --data")
    pin_float32()
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to vocode on "
                           "the CPU")
    voc = VocoderSynthesizer(args.config, device=args.device,
                             session_name=args.session_name)
    sr = voc.config["sampling_rate"]
    n_mels = voc.model.feat_dims
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kind = "batched" if args.batched else "unbatched"

    def vocode(mel, name):
        mel = np.asarray(mel, np.float32)
        if mel.shape[0] == n_mels and mel.shape[1] != n_mels:
            mel = mel.T         # the store's (n_mels, t)
        elif mel.shape[1] != n_mels and mel.shape[0] < mel.shape[1]:
            mel = mel.T         # etts' guess: time is the longer axis
        wav = voc.generate(mel, batched=args.batched, target=args.target,
                           overlap=args.overlap)
        save_wav(wav, out_dir / f"{name}_{kind}.wav", sr)
        print(f"wrote {name}_{kind}.wav ({len(wav) / sr:.2f} s)", flush=True)

    if args.file:
        vocode(np.load(args.file), Path(args.file).stem)
    else:
        with open(Path(args.data) / "dataset.pkl", "rb") as f:
            ids = [x[0] for x in pickle.load(f)][-args.samples:]
        for item_id in ids:
            vocode(np.load(Path(args.data) / "mel" / f"{item_id}.npy"),
                   item_id)


if __name__ == "__main__":
    main()
