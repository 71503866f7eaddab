"""Per-phoneme durations from a trained AR model's cross-attention, the
forward model's training data (port of ``scripts/extract_durations.py``).

    python -m etts_torch.extract_durations --config DIR \\
        [--session_name NAME] [--best] [--binary] [--fix_jumps] \\
        [--fill_mode_max] [--use_GT] [--batch_size 16] [--device cuda|cpu]

``DIR`` is the AR model's config dir: the session's latest checkpoint
(``ckpt-N.pt`` of ``train_autoregressive``) must be at reduction factor 1.
Each utterance of ``train_metafile.txt`` and ``test_metafile.txt`` goes
through the teacher-forced validation step at r = 1 (prenet dropout 0.5,
as etts fixes it, its uniforms drawn on the CPU so that the durations are
the same on every device); the cross-attention of the block that sorts
last by name (etts' string sort: with conv blocks not the last block)
becomes integer durations (``etts_torch.align``: the heads' weighted
average unless ``--best``, rounded normalised sums unless ``--binary``,
zeros filled from the next long phoneme or, with ``--fill_mode_max``, the
longest). The triples (mel, phonemes, durations), the mel being the
model's teacher-forced prediction (the ground truth with ``--use_GT``),
go to ``forward_data/{train,val}/{split}_{i}.npy`` under the corpus, as
pickled object arrays. Durations sum to the mel's frames.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .align import get_durations_from_alignment
from .data.dataset import DataPrepper, Dataset, load_files
from .text import default_tokenizer
from .train.steps import make_autoregressive_val_step
from .train_autoregressive import to_device
from .utils.config import ConfigManager
from .utils.precision import pin_float32

SPLITS = (("train", "train_metafile.txt"), ("val", "test_metafile.txt"))


def extract_batch(val_step, host, device, *, weighted=True, binary=False,
                  fix_jumps=False, fill_mode="next", use_gt=False):
    """One host batch (mel, phonemes, stop, spk) -> (the cross-attention
    (b, heads, t_mel, t_phon) of the decoder block whose name sorts last
    (`scripts/extract_durations.py:74`), [(mel, phonemes, durations)] one
    a row): the padding is read from the ground-truth mel and the ids."""
    out = val_step(to_device(host, device), 0, r=1)
    att = out["decoder_attention"]
    attention = att[sorted(att)[-1]].cpu().numpy()
    mel, phonemes = host[0], host[1]
    durations, unpad_mels, unpad_phon, _ = get_durations_from_alignment(
        attention, mel, phonemes, weighted=weighted, binary=binary,
        fix_jumps=fix_jumps, fill_gaps=True, fill_mode=fill_mode)
    predicted = out["final_output"].float().cpu().numpy()
    triples = []
    for i, dur in enumerate(durations):
        # final_output[f] predicts mel[1 + f]
        store = (unpad_mels[i] if use_gt
                 else predicted[i, :unpad_mels[i].shape[0]])
        triples.append((store, unpad_phon[i], dur))
    return attention, triples


def save_triple(path, triple):
    """(mel, phonemes, durations) as a pickled object array of three, as
    etts writes it (``ForwardDataPrepper`` reads it)."""
    sample = np.empty(3, dtype=object)
    for i, x in enumerate(triple):
        sample[i] = x
    np.save(path, sample, allow_pickle=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="the AR model's config dir")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--best", action="store_true",
                        help="the best attention head, not the weighted "
                        "average of the heads")
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--fix_jumps", action="store_true")
    parser.add_argument("--fill_mode_max", action="store_true")
    parser.add_argument("--use_GT", action="store_true",
                        help="store the ground-truth mels, not the "
                        "predicted ones")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.fix_jumps and not args.binary:
        parser.error("--fix_jumps needs --binary")
    pin_float32()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to extract on "
                           "the CPU")

    cm = ConfigManager(args.config, "autoregressive", args.session_name)
    config = cm.config
    model, step, sched = cm.load_model(device=device)
    if sched["reduction_factor"] != 1:
        raise ValueError(
            "duration extraction needs a model trained to reduction factor "
            f"1; the checkpoint at step {step} has r = "
            f"{sched['reduction_factor']}")
    prepper = DataPrepper(config, default_tokenizer(add_start_end=True))
    val_step = make_autoregressive_val_step(
        model, stop_scaling=config.get("stop_loss_scaling", 1.0))
    spk_dir = cm.train_datadir / "spk_embeds" if model.has_speaker else None
    flags = dict(weighted=not args.best, binary=args.binary,
                 fix_jumps=args.fix_jumps,
                 fill_mode="max" if args.fill_mode_max else "next",
                 use_gt=args.use_GT)
    for split, metafile in SPLITS:
        out_dir = cm.train_datadir / "forward_data" / split
        out_dir.mkdir(parents=True, exist_ok=True)
        samples, _ = load_files(cm.train_datadir / metafile,
                                cm.train_datadir / "mels", spk_dir,
                                config.get("n_samples"))
        dataset = Dataset(samples, prepper, args.batch_size, shuffle=False,
                          drop_remainder=False,
                          mel_channels=config["mel_channels"])
        idx = 0
        t0 = time.perf_counter()
        for host in dataset.all_batches():
            for triple in extract_batch(val_step, host, device, **flags)[1]:
                save_triple(out_dir / f"{split}_{idx}.npy", triple)
                idx += 1
        seconds = time.perf_counter() - t0
        print(f"{split}: wrote {idx} triples to {out_dir} in {seconds:.3f} "
              f"s ({seconds / max(idx, 1) * 1e3:.2f} ms an utterance)",
              flush=True)


if __name__ == "__main__":
    main()
