"""Build the vocoder's training store from a directory of wavs (port of
``scripts/preprocess_wavernn.py``).

    python -m etts_torch.preprocess_wavernn --config DIR --wav_dir WAVS \\
        --out_dir STORE [--extension .wav] [--njobs 16] [--device cuda|cpu]

``DIR`` holds ``data_config.yaml`` (the audio settings) and, where
present, ``wavernn_config.yaml`` (``voc_mode``, ``bits``, ``mu_law``,
``peak_norm``); the two are merged, the second winning. ``STORE`` gets
``mel/``, ``quant/`` and ``dataset.pkl`` (``data.builders``), which
``python -m etts_torch.train_wavernn --data STORE`` reads. The mels are
computed on ``--device``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
import yaml

from .data.builders import build_vocoder_dataset
from .utils.precision import pin_float32


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="dir with data_config.yaml (+ "
                        "wavernn_config.yaml)")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--extension", default=".wav")
    parser.add_argument("--njobs", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    pin_float32()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to build the "
                           "store on the CPU")
    cfg = {}
    for name in ("data_config.yaml", "wavernn_config.yaml"):
        p = Path(args.config) / name
        if p.exists():
            cfg.update(yaml.safe_load(p.read_text()) or {})
    out = build_vocoder_dataset(
        args.wav_dir, args.out_dir, cfg, mode=cfg.get("voc_mode", "MOL"),
        bits=int(cfg.get("bits", 9)), mu_law=bool(cfg.get("mu_law", True)),
        peak_norm=bool(cfg.get("peak_norm", False)),
        extension=args.extension, njobs=args.njobs, device=device)
    print(f"vocoder dataset written to {out}")


if __name__ == "__main__":
    main()
