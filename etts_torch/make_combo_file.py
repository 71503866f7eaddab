"""Write a ``text_id|style_id|speaker_id`` combo file for the random regimes
of ``etts_torch.synthesize_speaker`` (port of ``scripts/make_combo_file.py``):
each row draws its three ids independently from the held-out metafile's
utterance ids, so the "rand" regime decorrelates text, style and speaker.

    python -m etts_torch.make_combo_file --metafile test_metafile.txt \\
        --out combos.txt [--n 12] [--seed 0]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--metafile", required=True, help="id|text[|phonemes]")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    ids = [line.split("|")[0] for line in
           Path(a.metafile).read_text(encoding="utf-8").splitlines()
           if "|" in line]
    rng = np.random.default_rng(a.seed)
    rows = ["|".join(rng.choice(ids, 3)) for _ in range(a.n)]
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(rows) + "\n", encoding="utf-8")
    print(f"wrote {a.n} combos to {a.out}")


if __name__ == "__main__":
    main()
