"""Train the tiny offline char-CTC transcriber, WER backend (3) (port of
``scripts/train_ctc_asr.py``).

    python -m etts_torch.train_ctc_asr --metadata metadata.csv \\
        --wav_dir wavs --out ctc.npz [--steps 600] [--lr 3e-3] \\
        [--n_mels 40] [--hidden 96] [--max_utts 0] [--log_every 50] \\
        [--device cuda|cpu]

Reads an ``id|text`` metadata file and its wav directory (the corpus layout
``create_dataset`` reads), trains ``evalsuite.ctc_asr.CTCAsrModel``
full-batch on ``--device`` and writes etts' flat npz checkpoint, which
``objective_measure`` and ``wer.transcribe`` pick up through
``ETTS_CTC_ASR=<ckpt>`` (or ``--ctc_asr``). Prints the final loss and the
greedy WER of the first 10 training utterances.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def read_pairs(metadata, wav_dir, max_utts: int = 0):
    """[(wav, text), ...] of the metadata lines whose wav exists, and the
    sample rate."""
    from .data.audio_io import load_wav
    pairs, sr = [], None
    with open(metadata, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            wav_path = Path(wav_dir) / f"{parts[0]}.wav"
            if not wav_path.exists():
                continue
            wav, sr = load_wav(str(wav_path))
            pairs.append((np.asarray(wav), parts[1]))
            if max_utts and len(pairs) >= max_utts:
                break
    return pairs, sr


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--metadata", required=True,
                        help="metadata.csv with id|text lines")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out", required=True,
                        help="output checkpoint (.npz)")
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--n_mels", type=int, default=40)
    parser.add_argument("--hidden", type=int, default=96)
    parser.add_argument("--max_utts", type=int, default=0,
                        help="cap the corpus size (0 = all)")
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .evalsuite.ctc_asr import CTCTranscriber, save_ckpt, train_ctc_asr
    from .evalsuite.wer import wer
    from .utils.precision import pin_float32
    pin_float32()
    pairs, sr = read_pairs(args.metadata, args.wav_dir, args.max_utts)
    if not pairs:
        raise SystemExit("no (wav, text) pairs found")
    print(f"training char-CTC on {len(pairs)} utterances at {sr} Hz")
    model, loss = train_ctc_asr(
        pairs, sr, steps=args.steps, lr=args.lr, n_mels=args.n_mels,
        hidden=args.hidden, log_every=args.log_every, device=args.device)
    save_ckpt(args.out, model, sr)
    print(f"final ctc loss {loss:.4f}; checkpoint -> {args.out}")

    tr = CTCTranscriber(args.out, args.device)
    ws = [wer(text, tr.transcribe_wav(wav, sr)) for wav, text in pairs[:10]]
    print(f"train-set WER (first {len(ws)}): {np.mean(ws):.3f}")


if __name__ == "__main__":
    main()
