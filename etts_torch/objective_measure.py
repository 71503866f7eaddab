"""Objective evaluation of synthesized speech against the original
recordings (port of the root ``objective_measure.py``).

    python -m etts_torch.objective_measure --ref_dir wavs \\
        --syn_dirs out/syn_norm out/rand [--texts test_metafile.txt] \\
        [--ctc_asr ctc.npz] [--sr 16000] [--workers 8] \\
        [--out all_score.log] [--device cuda|cpu]

The same pairing (a synthesized ``name.wav`` or ``text__style__spk.wav``
with the reference ``name.wav`` or ``text.wav``), per-file CSVs
``score_<model>.csv`` beside ``--out``, and the tab-separated mean table
``--out`` with etts' columns and model-name disambiguation. The
DTW-aligned metrics (``evalsuite.compute_all_metrics``, numpy) run in a
pool of ``spawn``ed worker processes; the WER transcription
(``evalsuite.wer.transcribe``, its backend printed; the char-CTC
checkpoint of ``--ctc_asr`` or ``ETTS_CTC_ASR``, or a cached wav2vec2, runs
on ``--device``) in this process. Unlike etts, a
pair that fails to load or score raises rather than scoring zeros, and an
empty transcript scores its WER where etts leaves the column empty.
"""
from __future__ import annotations

import argparse
import csv
import multiprocessing
import os
from functools import partial
from pathlib import Path

import numpy as np

from .data.audio_io import load_wav
from .evalsuite.metrics import compute_all_metrics

METRIC_KEYS = ["MCD", "FD", "RMSE_F0", "STOI", "PESQ", "PESQ_proxy",
               "WER_syn", "WER_ori"]


def score_pair(pair, sr):
    """A worker's metrics of one (reference, synthesized, text) pair."""
    ref_path, syn_path, _ = pair
    ref, _ = load_wav(ref_path, sr)
    syn, _ = load_wav(syn_path, sr)
    metrics = compute_all_metrics(ref, syn, sr)
    metrics["file"] = Path(syn_path).name
    return metrics


def find_pairs(ref_dir, syn_dir, texts):
    pairs = []
    for syn in sorted(Path(syn_dir).glob("*.wav")):
        ref = Path(ref_dir) / syn.name
        if not ref.exists():
            ref = Path(ref_dir) / f"{syn.stem.split('__')[0]}.wav"
        if ref.exists():
            # regime outputs are named text__style__spk.wav; the WER text is
            # keyed by the text id
            text = texts.get(syn.stem) or texts.get(syn.stem.split("__")[0])
            pairs.append((str(ref), str(syn), text))
    return pairs


def model_names(dirs):
    """Disambiguate generic leaf names (".../curve_14000/syn") so two
    models' per-file CSVs don't overwrite each other: colliding names
    absorb parent path levels until unique, with an index suffix as the
    last resort for identical paths."""
    parts = [[x for x in Path(d).parts if x != os.sep] for d in dirs]
    names = [p[-1] if p else "syn" for p in parts]
    depth = 1
    while len(set(names)) < len(names) and \
            depth < max(len(p) for p in parts):
        depth += 1
        dup = {n for n in names if names.count(n) > 1}
        names = ["_".join(p[-min(depth, len(p)):]) if n in dup else n
                 for p, n in zip(parts, names)]
    seen, out = {}, []
    for n in names:
        k = seen.get(n, 0)
        out.append(n if k == 0 else f"{n}_{k}")
        seen[n] = k + 1
    return out


def add_wer(results, pairs):
    """WER_syn and WER_ori of the pairs that have a text, transcribed here
    (each file once); None where no ASR backend is available."""
    from .evalsuite.wer import transcribe, wer
    heard = {}
    for r, (ref_path, syn_path, text) in zip(results, pairs):
        if text:
            for key, path in (("WER_syn", syn_path), ("WER_ori", ref_path)):
                if path not in heard:
                    heard[path] = transcribe(path)
                r[key] = (None if heard[path] is None
                          else wer(text, heard[path]))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ref_dir", required=True,
                        help="original recordings")
    parser.add_argument("--syn_dirs", nargs="+", required=True,
                        help="one dir of synthesized wavs per model/regime")
    parser.add_argument("--texts", default=None,
                        help="metafile id|text for WER")
    parser.add_argument("--ctc_asr", default=None,
                        help="char-CTC checkpoint for the WER columns "
                             "(else ETTS_CTC_ASR)")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--workers", type=int,
                        default=min(30, os.cpu_count()))
    parser.add_argument("--out", default="all_score.log")
    parser.add_argument("--device", default="cuda",
                        help="where the WER's transcriber runs")
    args = parser.parse_args(argv)

    from .evalsuite.ctc_asr import set_default_model
    from .utils.precision import pin_float32
    pin_float32()
    set_default_model(args.ctc_asr or os.environ.get("ETTS_CTC_ASR"),
                      device=args.device)
    texts = {}
    if args.texts:
        with open(args.texts, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) >= 2:
                    texts[parts[0]] = parts[1]
    if texts:
        from .evalsuite.wer import backend
        print(f"WER backend: {backend()}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    names = dict(zip(args.syn_dirs, model_names(args.syn_dirs)))
    rows = []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        for syn_dir in args.syn_dirs:
            pairs = find_pairs(args.ref_dir, syn_dir, texts)
            if not pairs:
                print(f"! no ref/syn pairs found for {syn_dir}")
                continue
            print(f"{syn_dir}: scoring {len(pairs)} pairs with "
                  f"{args.workers} workers")
            results = pool.map(partial(score_pair, sr=args.sr), pairs)
            add_wer(results, pairs)
            model_name = names[syn_dir]
            csv_path = Path(args.out).parent / f"score_{model_name}.csv"
            with open(csv_path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=["file"] + METRIC_KEYS)
                writer.writeheader()
                for r in results:
                    writer.writerow({k: r.get(k)
                                     for k in ["file"] + METRIC_KEYS})
            means = {}
            for k in METRIC_KEYS:
                vals = [r[k] for r in results
                        if r.get(k) is not None and np.isfinite(r[k])]
                means[k] = float(np.mean(vals)) if vals else float("nan")
            rows.append((model_name, means))
            print("  " + "  ".join(f"{k}={v:.4f}" for k, v in means.items()))

    with open(args.out, "w") as f:
        f.write("model\t" + "\t".join(METRIC_KEYS) + "\n")
        for name, means in rows:
            f.write(name + "\t"
                    + "\t".join(f"{means[k]:.6f}" for k in METRIC_KEYS) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
