"""Build the TTS models' training store from a corpus (port of
``scripts/create_dataset.py``).

    python -m etts_torch.create_dataset --config DIR \\
        [--phonemizer_backend espeak|grapheme|rule] [--njobs 16] \\
        [--col_sep "|"] [--dont_cache_phonemes] [--recompute_phon] \\
        [--device cuda|cpu]

``DIR`` holds ``data_config.yaml``; the corpus is its
``data_directory`` (``metadata.csv`` and ``wavs/``), the store goes to
its ``train_data_directory`` (else the corpus' directory):
``train_metafile.txt``, ``test_metafile.txt``, ``phonemes.npy`` and
``mels/`` (``data.builders.build_tts_dataset``), which ``python -m
etts_torch.train_autoregressive`` reads. The mels are computed on
``--device``. The backend comes from ``--phonemizer_backend`` or the
config's ``phonemizer_backend``; with neither, this raises. A backend
given here is written back into ``data_config.yaml``, so that training
and serving phonemize with the vocabulary the store was built with.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
import yaml

from .data.builders import build_tts_dataset
from .utils.precision import pin_float32


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", dest="CONFIG", required=True)
    parser.add_argument("--dont_cache_phonemes", dest="CACHE_PHON",
                        action="store_false")
    parser.add_argument("--njobs", dest="NJOBS", type=int, default=16)
    parser.add_argument("--col_sep", dest="COLUMN_SEP", default="|")
    parser.add_argument("--recompute_phon", dest="RECOMPUTE_PHON",
                        action="store_true")
    parser.add_argument("--phonemizer_backend", default=None,
                        choices=[None, "espeak", "grapheme", "rule"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    pin_float32()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to build the "
                           "store on the CPU")
    cfg_path = Path(args.CONFIG) / "data_config.yaml"
    config = yaml.safe_load(cfg_path.read_text())
    out = build_tts_dataset(config, cache_phonemes=args.CACHE_PHON,
                            recompute_phonemes=args.RECOMPUTE_PHON,
                            column_sep=args.COLUMN_SEP, njobs=args.NJOBS,
                            phonemizer_backend=args.phonemizer_backend,
                            device=device)
    if args.phonemizer_backend and (config.get("phonemizer_backend")
                                    != args.phonemizer_backend):
        config["phonemizer_backend"] = args.phonemizer_backend
        cfg_path.write_text(yaml.safe_dump(config))
    print(f"\nDone. Dataset written to {out}")


if __name__ == "__main__":
    main()
