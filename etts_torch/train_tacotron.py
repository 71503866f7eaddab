"""GST-Tacotron training driver (port of ``scripts/train_tacotron.py``).

    python -m etts_torch.train_tacotron --config DIR [--session_name NAME] \\
        [--max_steps N] [--force] [--device cuda|cpu] \\
        [--multihost [--coordinator_address HOST:PORT --num_processes N \\
         --process_id R] [--dist_backend nccl|gloo]]

``DIR`` holds ``data_config.yaml`` and ``tacotron_config.yaml``; the store
is its ``train_data_directory`` (else ``data_directory``), as
``data.taco_builders.build_tacotron_dataset`` writes it: ``train.txt``
(``linear file|mel file|frames|text``) and the spectrograms beside it.
The model starts from etts' initialisers (``init_flax``, seed 0).

Each step takes ``batch_size`` (8) utterances in the order of one
``np.random.default_rng(42)`` stream of permutations, an epoch each, cut
into whole batches: keithito ids under the config's ``cleaners``, the
mel and linear targets zero-padded to the longest, rounded up to a
multiple of ``outputs_per_step``; then ``make_tacotron_train_step``: the
gradients clipped to a global norm of 1.0, and Adam (``adam_beta1``,
``adam_beta2``, eps 1e-8) at Noam's rate from ``initial_learning_rate``
(``decay_learning_rate``, the default) or at that rate alone. The
step's uniforms come from ``fold_in(42, step)``.

Every ``metrics_sync_frequency`` steps and at the last, the losses go to
``tacotron_logs/scalars.jsonl`` (``train/loss``, ``train/mel_loss``,
``train/linear_loss``, ``train/ref_enc_loss``), and a loss above 100 or
not a number raises; ``time/step_ms`` (the device synchronised around
the step) and ``meta/target_frames`` (the batch's unpadded frames) every
step, on the card ``meta/max_memory_allocated`` at the end. Every
``checkpoint_interval`` (1000) steps and at the last, the model, its
BatchNorm statistics, Adam's state and the step go to
``tacotron_weights/ckpt-N.pt`` (the newest 5 kept), and the batch's
first alignment to ``tacotron_logs/train_alignment_{step}.npy``. A rerun
resumes from the latest checkpoint (``restored weights at step N``) and
replays the permutation stream to the batch it stopped at
(``fast_forward_permutation``).

``--multihost``: data-parallel training, one process a rank, each on its
rows of every global batch (``etts_torch.parallel``; as
``train_autoregressive``); rank 0 alone prints, logs and writes
checkpoints.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .data.dataset import fast_forward_permutation
from .models.init import init_flax
from .models.tacotron import noam_learning_rate
from .parallel import (add_multihost_args, barrier, is_primary,
                       local_device, local_shard, maybe_init_multihost,
                       replicate)
from .text import text_to_sequence
from .train.state import TrainState
from .train.steps import fold_in, make_tacotron_train_step
from .utils.checkpoints import CheckpointManager
from .utils.config import ConfigManager, build_tacotron
from .utils.logging import ScalarLog
from .utils.precision import pin_float32

SEED = 42               # etts' PRNGKey(42) and default_rng(42)
INIT_SEED = 0           # etts' _init_variables draws from PRNGKey(0)
CLIP_NORM = 1.0
LOSS_LIMIT = 100.0      # `gst_tacotron/train.py:100-102`
MAX_TO_KEEP = 5


def load_taco_metadata(data_dir) -> list:
    """The rows of ``data_dir/train.txt`` of four or more ``|`` fields:
    [linear file, mel file, frames, text, ...]."""
    rows = []
    with open(Path(data_dir) / "train.txt", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 4:
                rows.append(parts)
    return rows


def taco_batches(rows, data_dir, batch_size: int, r: int, cleaners, rng,
                 skip_batches: int = 0):
    """Endless (numpy batch (ids int32 (b, n), lengths int32 (b,), mels
    (b, t, n_mels), linears (b, t, n_freq)), the indices of its rows):
    each epoch a permutation of ``rows`` from ``rng`` cut into whole
    batches, the first epoch starting ``skip_batches`` batches in; t the
    longest mel rounded up to a multiple of ``r``, zero padding."""
    data_dir = Path(data_dir)
    while True:
        order = rng.permutation(len(rows))
        start, skip_batches = skip_batches * batch_size, 0
        for i in range(start, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            group = [rows[j] for j in idx]
            texts = [np.asarray(text_to_sequence(g[3], cleaners), np.int32)
                     for g in group]
            mels = [np.load(data_dir / g[1]) for g in group]
            linears = [np.load(data_dir / g[0]) for g in group]
            tlen = max(len(t) for t in texts)
            mlen = -(-max(m.shape[0] for m in mels) // r) * r
            inputs = np.zeros((batch_size, tlen), np.int32)
            lengths = np.zeros(batch_size, np.int32)
            mel_t = np.zeros((batch_size, mlen, mels[0].shape[1]),
                             np.float32)
            lin_t = np.zeros((batch_size, mlen, linears[0].shape[1]),
                             np.float32)
            for k, (t_, m_, l_) in enumerate(zip(texts, mels, linears)):
                inputs[k, :len(t_)] = t_
                lengths[k] = len(t_)
                mel_t[k, :m_.shape[0]] = m_
                lin_t[k, :l_.shape[0]] = l_
            yield (inputs, lengths, mel_t, lin_t), idx


def to_device(batch, device):
    """A numpy batch as tensors on ``device``, ids and lengths int64."""
    return tuple(torch.from_numpy(a).to(device, torch.int64)
                 if a.dtype == np.int32 else torch.from_numpy(a).to(device)
                 for a in batch)


def train_state(model, config: dict) -> TrainState:
    """``model``'s train state as etts' driver makes its optimizer
    (`scripts/train_tacotron.py:87-97`): clipping at a global norm of 1.0,
    Adam (``adam_beta1``, ``adam_beta2``, eps 1e-8) at Noam's rate from
    ``initial_learning_rate`` (2e-3) where ``decay_learning_rate`` (the
    default), else at that rate."""
    lr0 = config.get("initial_learning_rate", 2e-3)
    lr = ((lambda step: noam_learning_rate(lr0, step))
          if config.get("decay_learning_rate", True) else [[0, lr0]])
    return TrainState(model, lr, betas=(config.get("adam_beta1", 0.9),
                                        config.get("adam_beta2", 0.999)),
                      eps=1e-8, clip_norm=CLIP_NORM)


def _guard(loss: float, step: int):
    if loss > LOSS_LIMIT or np.isnan(loss):
        raise RuntimeError(f"Loss exploded to {loss} at step {step}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="dir with data_config.yaml + tacotron_config.yaml")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--max_steps", type=int, default=100_000)
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

    cm = ConfigManager(args.config, "tacotron", args.session_name)
    config = cm.config
    if primary:
        cm.create_remove_dirs(force=args.force)
        cm.dump_config()
        print(f"session {cm.session_name} in {cm.base_dir}")
    barrier()
    model = build_tacotron(config)
    init_flax(model, torch.Generator().manual_seed(INIT_SEED)).to(device)
    rows = load_taco_metadata(cm.train_datadir)
    batch_size = config.get("batch_size", 8)

    state = train_state(model, config)
    ckpt = CheckpointManager(cm.weights_dir, max_to_keep=MAX_TO_KEEP)
    tree, rstep = ckpt.restore(map_location=device)
    if rstep is not None:
        state.load_state_dict(tree)
        if primary:
            print(f"restored weights at step {rstep}")
    replicate(state)
    step_fn = make_tacotron_train_step(model)

    rng = np.random.default_rng(SEED)
    skip = fast_forward_permutation(rng, len(rows), batch_size, state.step)
    batches = taco_batches(rows, cm.train_datadir, batch_size, model.r,
                           [config.get("cleaners", "english_cleaners")], rng,
                           skip)
    log = ScalarLog(cm.log_dir)
    sync_every = int(config.get("metrics_sync_frequency", 10))
    ckpt_every = config.get("checkpoint_interval", 1000)
    for step in range(state.step, args.max_steps):
        host, idx = next(batches)
        batch = to_device(local_shard(host), device)
        sync()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, fold_in(SEED, step))
        sync()
        log.add_scalar("time/step_ms", (time.perf_counter() - t0) * 1e3,
                       step)
        log.add_scalar("meta/target_frames",
                       sum(int(rows[j][2]) for j in idx), step)
        if step % sync_every == 0 or step + 1 == args.max_steps:
            loss = float(metrics["loss"])
            _guard(loss, step)
            if primary:
                print(f"step {step}: loss {loss:.5f}", flush=True)
            log.add_scalar("train/loss", loss, step)
            for k in ("mel_loss", "linear_loss", "ref_enc_loss"):
                log.add_scalar(f"train/{k}", float(metrics[k]), step)
        if (step + 1) % ckpt_every == 0 or step + 1 == args.max_steps:
            ckpt.save(step + 1, state.state_dict())
            log.add_image("train/alignment",
                          metrics["alignments"][0].cpu().numpy(), step)
    if device.type == "cuda":
        log.add_scalar("meta/max_memory_allocated",
                       torch.cuda.max_memory_allocated(device),
                       args.max_steps - 1)
    if primary:
        print("Done.")


if __name__ == "__main__":
    main()
