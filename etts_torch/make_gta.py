"""Ground-truth-aligned (GTA) mels of a trained AR model, for vocoder
training on the mels the TTS model makes (port of ``scripts/make_gta.py``).

    python -m etts_torch.make_gta --config DIR [--session_name NAME] \\
        [--voc_data STORE] [--tts_out DIR] [--batch_size 16] \\
        [--checkpoint N] [--device cuda|cpu]

``DIR`` is the AR model's config dir; its session's checkpoint
``ckpt-N.pt`` (the latest without ``--checkpoint``; the best free-running
one is the better choice, SOAK_NOTES.md) is loaded at the reduction factor
of its step (``ConfigManager.load_model``). Every utterance of
``train_metafile.txt`` and ``test_metafile.txt`` goes through the
teacher-forced validation step (prenet dropout 0.5, as etts fixes it, its
uniforms drawn on the CPU so that every device writes the same mels; the
speaker embeddings of ``spk_embeds/`` for a speaker system). Its
prediction, cut to the utterance's frames (the nonzero rows of the padded
target less the start and end frames), goes to ``STORE/gta/{id}.npy`` as
the vocoder store keeps mels, (n_mels, t) in [0, 1], which ``python -m
etts_torch.train_wavernn --gta`` reads, and to ``--tts_out``'s
``{id}.npy`` as the TTS model's (t, n_mels) in [-4, 4].
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .data.dataset import DataPrepper, Dataset, load_files
from .ops.normalizers import vocoder_mel
from .text import default_tokenizer
from .train.steps import make_autoregressive_val_step
from .train_autoregressive import to_device
from .utils.config import ConfigManager
from .utils.precision import pin_float32

SPLITS = ("train_metafile.txt", "test_metafile.txt")


def gta_batch(val_step, host, device, r: int) -> list:
    """One host batch (mel, phonemes, stop, spk) -> the teacher-forced
    prediction of each row, (t, n_mels) in [-4, 4] (float32, holding a
    bf16 model's bf16 values), t its target's frames (the nonzero rows
    less the start and end frames)."""
    pred = val_step(to_device(host, device), 0, r=r)["final_output"]
    lens = (np.abs(host[0]).sum(-1) != 0).sum(-1) - 2
    pred = pred.float().cpu().numpy()
    return [pred[b, :int(n)] for b, n in enumerate(lens)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="the AR model's config dir")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--voc_data", default=None,
                        help="vocoder store (gta/ is made inside)")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--checkpoint", type=int, default=None,
                        help="the checkpoint's step (default: the latest)")
    parser.add_argument("--tts_out", default=None,
                        help="also write the TTS layout ((t, n_mels) in "
                        "[-4, 4]) here")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.voc_data and not args.tts_out:
        parser.error("nothing to write: pass --voc_data and/or --tts_out")
    pin_float32()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")

    cm = ConfigManager(args.config, "autoregressive", args.session_name)
    config = cm.config
    model, step, sched = cm.load_model(args.checkpoint, device)
    r = sched["reduction_factor"]
    val_step = make_autoregressive_val_step(model)
    prepper = DataPrepper(config, default_tokenizer(add_start_end=True))
    gta_dir = Path(args.voc_data) / "gta" if args.voc_data else None
    tts_dir = Path(args.tts_out) if args.tts_out else None
    out_dirs = [d for d in (gta_dir, tts_dir) if d is not None]
    for d in out_dirs:
        d.mkdir(parents=True, exist_ok=True)
    spk_dir = cm.train_datadir / "spk_embeds" if model.has_speaker else None
    if spk_dir is not None and not spk_dir.exists():
        raise FileNotFoundError(
            f"system_type={config['system_type']!r} needs speaker embeddings "
            f"in {spk_dir}; none found")
    n = 0
    for metafile in SPLITS:
        samples, _ = load_files(cm.train_datadir / metafile,
                                cm.train_datadir / "mels", spk_dir)
        ids = iter(Path(s[2]).stem for s in samples)
        dataset = Dataset(samples, prepper, args.batch_size, shuffle=False,
                          drop_remainder=False,
                          mel_channels=config["mel_channels"])
        for host in dataset.all_batches():
            for raw in gta_batch(val_step, host, device, r):
                item_id = next(ids)
                if gta_dir is not None:
                    np.save(gta_dir / f"{item_id}.npy",
                            vocoder_mel(torch.from_numpy(raw.T.copy()),
                                        model.dtype).numpy())
                if tts_dir is not None:
                    np.save(tts_dir / f"{item_id}.npy", raw)
                n += 1
    print(f"wrote {n} GTA mels (step {step}, r = {r}) to "
          + " and ".join(str(d) for d in out_dirs))


if __name__ == "__main__":
    main()
