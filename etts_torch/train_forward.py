"""Forward (duration) model training driver (port of
``scripts/train_forward.py``).

    python -m etts_torch.train_forward --config DIR [--session_name NAME] \\
        [--max_steps N] [--force] [--device cuda|cpu] \\
        [--multihost [--coordinator_address HOST:PORT --num_processes N \\
         --process_id R] [--dist_backend nccl|gloo]]

``DIR`` holds ``data_config.yaml`` and ``forward_config.yaml``; the data
are the triples ``extract_durations`` writes under the corpus,
``forward_data/{train,val}/*.npy``. Triples longer than ``max_frames`` are
dropped once, before the first batch (``filter_overlong``, frame counts
kept in a ``.frame_counts.json`` beside them), and every batch's mel is
padded to ``max_frames``. The model starts from etts' initialisers
(``init_flax``, seed 42) and trains with Adam on
``learning_rate_tts_schedule``; checkpoints go to the session's
``forward_weights``, and a rerun resumes from the latest (``restored
weights at step N``), the data stream continued. Every
``prediction_frequency`` steps a validation batch's loss and predicted
durations are logged. Scalars go to ``forward_logs/scalars.jsonl``
(``train/loss``, ``train/mel_loss``, ``train/duration_loss``,
``val/loss``, ``time/step_ms``, ``meta/target_frames``, on the card
``meta/max_memory_allocated``), the durations to
``val_durations_{step}.npy``. Dropout is drawn from ``fold_in(42, step)``:
a resumed run draws what an uninterrupted one does.

``--multihost``: data-parallel training, one process a rank, each on its
rows of every global batch (``etts_torch.parallel``; as
``train_autoregressive``); rank 0 alone prints, logs and validates and writes
checkpoints.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .data.dataset import Dataset, ForwardDataPrepper, Prefetcher
from .models.init import init_flax
from .parallel import (add_multihost_args, barrier, is_primary,
                       local_device, local_shard, maybe_init_multihost,
                       replicate)
from .text import default_tokenizer
from .train.state import TrainState
from .train.steps import (fold_in, make_forward_train_step,
                          make_forward_val_step)
from .train_autoregressive import SEED, _guard
from .utils.checkpoints import CheckpointManager
from .utils.config import ConfigManager, build_forward
from .utils.logging import ScalarLog, ValueWindow
from .utils.precision import pin_float32

VAL_STREAM = 0x76616C   # etts folds the validation key with this


def filter_overlong(files, max_frames: int) -> list:
    """The triples whose mel has at most ``max_frames`` frames. Their frame
    counts are kept in ``.frame_counts.json`` beside them, each with the
    file's mtime, so that only a new or changed triple is read again (the
    triples are pickled object arrays, whose headers cannot be peeked)."""
    if not files:
        return files
    cache_path = Path(files[0]).parent / ".frame_counts.json"
    try:
        cache = json.loads(cache_path.read_text())
    except (OSError, ValueError):     # absent or torn: rebuilt
        cache = {}
    keep, changed = [], False
    for f in files:
        name, mtime = Path(f).name, os.stat(f).st_mtime_ns
        entry = cache.get(name)
        if entry is None or entry[0] != mtime:
            entry = cache[name] = [mtime, int(np.load(
                str(f), allow_pickle=True)[0].shape[0])]
            changed = True
        if entry[1] <= max_frames:
            keep.append(f)
    if changed:
        try:
            cache_path.write_text(json.dumps(cache))
        except OSError:
            pass
    return keep


def to_device(batch, device):
    """A host batch (mel, phonemes, durations) as tensors."""
    mel, phon, dur = batch
    return (torch.from_numpy(mel).to(device),
            torch.from_numpy(phon).long().to(device),
            torch.from_numpy(dur).to(device))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="dir with data_config.yaml + forward_config.yaml")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", default="cuda")
    add_multihost_args(parser)
    args = parser.parse_args(argv)
    maybe_init_multihost(args)      # before any device use
    pin_float32()
    device = local_device(args.device)
    primary = is_primary()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))

    cm = ConfigManager(args.config, "forward", args.session_name)
    config = cm.config
    if primary:
        cm.create_remove_dirs(force=args.force)
        cm.dump_config()
        print(f"session {cm.session_name} in {cm.base_dir}")
    barrier()
    model = build_forward(config, default_tokenizer(False).vocab_size)
    init_flax(model, torch.Generator().manual_seed(SEED)).to(device)
    max_frames = int(config.get("max_frames", 1280))

    data = cm.train_datadir / "forward_data"
    train_files = filter_overlong(sorted((data / "train").glob("*.npy")),
                                  max_frames)
    val_files = filter_overlong(sorted((data / "val").glob("*.npy")),
                                max_frames)
    prepper = ForwardDataPrepper(max_frames=None)
    batch_size = config.get("tts_batch_size", 16)
    dataset = Dataset(train_files, prepper, batch_size,
                      mel_channels=config["mel_channels"],
                      pad_mel_multiple=max_frames)
    if dataset.batches_per_epoch() == 0:
        raise ValueError(f"{len(train_files)} training triples of at most "
                         f"{max_frames} frames in {data / 'train'}: fewer "
                         f"than one batch of {batch_size}")
    # a val split shorter than a batch gives one short batch (etts' drops
    # it, and its stream then never yields)
    val_dataset = (Dataset(val_files, prepper, batch_size, shuffle=False,
                           drop_remainder=False,
                           mel_channels=config["mel_channels"],
                           pad_mel_multiple=max_frames)
                   if val_files else None)

    state = TrainState(model, config["learning_rate_tts_schedule"])
    ckpt = CheckpointManager(cm.weights_dir,
                             max_to_keep=config.get("keep_n_weights"))
    tree, rstep = ckpt.restore(map_location=device)
    if rstep is not None:
        state.load_state_dict(tree)
        if primary:
            print(f"restored weights at step {rstep}")
        dataset.seek(state.step)        # continue the stream, no replay
    replicate(state)
    train_step = make_forward_train_step(model, max_frames)
    val_step = make_forward_val_step(model, max_frames)

    log = ScalarLog(cm.log_dir)
    avg_windows = {n: ValueWindow(n)
                   for n in config.get("n_steps_avg_losses", [100])}
    max_steps = args.max_steps or config["max_steps"]
    sync_every = int(config.get("metrics_sync_frequency", 10))
    loader = Prefetcher(dataset)
    try:
        for step in range(state.step, max_steps):
            host_batch = loader.next_batch()
            batch = to_device(local_shard(host_batch), device)
            sync()
            t0 = time.perf_counter()
            metrics = train_step(state, batch, fold_in(SEED, step))
            sync()
            log.add_scalar("time/step_ms", (time.perf_counter() - t0) * 1e3,
                           step)
            log.add_scalar("meta/target_frames",
                           int((np.abs(host_batch[0]).max(-1) > 0).sum()),
                           step)
            if step % sync_every == 0 or step + 1 == max_steps:
                loss_val = float(metrics["loss"])
                _guard(loss_val, step)
                for w in avg_windows.values():
                    w.append(loss_val)
                if primary:
                    print(f"step {step}: loss {loss_val:.5f} " + " ".join(
                        f"avg{n} {w.average:.4f}"
                        for n, w in avg_windows.items()), flush=True)
                for k, v in metrics.items():
                    log.add_scalar(f"train/{k}", float(v), step)
            if ((step + 1) % config["weights_save_frequency"] == 0
                    or step + 1 == max_steps):
                _guard(float(metrics["loss"]), step, " (before saving)")
                ckpt.save(step + 1, state.state_dict())
            if (primary and val_dataset is not None
                    and (step + 1) % config["prediction_frequency"] == 0):
                vm, out = val_step(
                    to_device(val_dataset.next_batch(), device),
                    fold_in(fold_in(SEED, VAL_STREAM), step))
                log.add_scalar("val/loss", float(vm["loss"]), step)
                log.add_histogram("val/durations",
                                  out["duration"].cpu().numpy(), step)
        if device.type == "cuda":
            log.add_scalar("meta/max_memory_allocated",
                           torch.cuda.max_memory_allocated(device),
                           max_steps - 1)
    finally:
        loader.stop()
    if primary:
        print("Done.")


if __name__ == "__main__":
    main()
