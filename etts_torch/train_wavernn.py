"""WaveRNN vocoder training driver (port of ``scripts/train_wavernn.py``).

    python -m etts_torch.train_wavernn --config DIR --data STORE \\
        [--session_name NAME] [--lr LR] [--batch_size N] [--gta] \\
        [--max_steps N] [--force] [--device cuda|cpu] \\
        [--multihost [--coordinator_address HOST:PORT --num_processes N \\
         --process_id R] [--dist_backend nccl|gloo]]

``DIR`` holds ``data_config.yaml`` and ``wavernn_config.yaml``; ``STORE``
is what ``python -m etts_torch.preprocess_wavernn`` writes (``mel/``,
``quant/``, ``dataset.pkl``), with ``gta/`` (``python -m
etts_torch.make_gta``) for ``--gta``, which trains on the GTA mels of the
ids that have one. Utterances too short for a training window are dropped;
the rest are shuffled by ``Random(1234)`` and the last
``voc_test_samples`` held out. A step takes ``voc_batch_size`` (or
``--batch_size``) random crops of ``voc_seq_len_hops`` hops
(``collate_vocoder``), the MoL loss (MOL) or the cross-entropy (RAW), and
one Adam update at ``--lr`` (else the first value of
``learning_rate_tts_schedule``). The model starts from etts' initialisers
(``init_flax``, seed 0). Every ``voc_checkpoint_every`` steps and at the
end the model, its BatchNorm statistics, the optimizer and the step go to
the session's ``wavernn_weights/ckpt-N.pt``, and the first
``voc_gen_at_checkpoint`` test utterances are vocoded through the sample
loop (B1 on the card) into ``wavernn_logs/gen_{step}_{k}.wav``. Scalars
go to ``wavernn_logs/scalars.jsonl``: ``train/loss`` every
``metrics_sync_frequency`` steps and at the end, ``time/step_ms`` and
``meta/target_samples`` every step (the device synchronised around the
step), on the card ``meta/max_memory_allocated`` at the end.

The batches come from two generators, as etts draws them: the epochs'
permutations from ``default_rng(1234)`` and the crop offsets from
``default_rng(4321)``. A rerun resumes from the latest checkpoint
(``restored vocoder weights at step N``) and replays the permutation
stream to the batch it stopped at (``fast_forward_permutation``); the crop
stream restarts from its seed, by etts' design, so a resumed run takes the
same utterances as an uninterrupted one, cropped elsewhere. A loss that is
not finite, or above 1e4, raises.

``--multihost``: data-parallel training, one process a rank, each on its
rows of every global batch (``etts_torch.parallel``; as
``train_autoregressive``); rank 0 alone prints, logs, vocodes and writes
checkpoints.
"""
from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path
from random import Random

import numpy as np
import torch

from .data.audio_io import save_wav
from .data.dataset import (VocoderDataset, collate_vocoder,
                           fast_forward_permutation)
from .models.init import init_flax
from .models.wavernn import generate
from .parallel import (add_multihost_args, barrier, is_primary,
                       local_device, local_shard, maybe_init_multihost,
                       replicate)
from .train.state import TrainState
from .train.steps import fold_in, make_wavernn_train_step
from .train_autoregressive import _guard
from .utils.checkpoints import CheckpointManager
from .utils.config import ConfigManager, build_vocoder
from .utils.logging import ScalarLog
from .utils.precision import pin_float32

INIT_SEED = 0           # etts' _init_variables draws from PRNGKey(0)
SPLIT_SEED = 1234       # random.seed(1234); random.shuffle(ids)
PERM_SEED = 1234
CROP_SEED = 4321
GEN_STREAM = 0x67656E   # etts folds the generation key with this


def vocoder_ids(data, config: dict, gta: bool) -> list:
    """The ids of ``data/dataset.pkl`` long enough for a training window
    (more than ``voc_seq_len_hops + 4 * voc_pad + 3`` mel frames), with
    ``gta`` only those that have ``gta/{id}.npy``."""
    with open(Path(data) / "dataset.pkl", "rb") as f:
        index = pickle.load(f)
    min_mel = (config.get("voc_seq_len_hops", 5)
               + 4 * config.get("voc_pad", 2) + 3)
    ids = [x[0] for x in index if x[1] > min_mel]
    if gta:
        have = {p.stem for p in (Path(data) / "gta").glob("*.npy")}
        missing = [i for i in ids if i not in have]
        if missing:
            print(f"gta: skipping {len(missing)} ids without GTA mels "
                  f"(e.g. {missing[0]})")
        ids = [i for i in ids if i in have]
    return ids


def split_ids(ids, n_test: int):
    """(test ids, train ids): ``ids`` shuffled by ``Random(1234)``, the
    last ``n_test`` held out."""
    ids = list(ids)
    Random(SPLIT_SEED).shuffle(ids)
    return ids[-n_test:], ids[:-n_test]


def vocoder_batches(train_set, batch_size: int, seq_len: int,
                    hop_length: int, pad: int, mode: str, bits: int,
                    perm_rng, crop_rng, skip_batches: int = 0):
    """Endless ``collate_vocoder`` batches: each epoch a permutation of
    ``train_set`` from ``perm_rng`` cut into whole batches, each batch's
    crops from ``crop_rng``; the first epoch starts ``skip_batches``
    batches in."""
    if len(train_set) < batch_size:
        raise ValueError(f"{len(train_set)} training utterances: fewer "
                         f"than one batch of {batch_size}")
    while True:
        order = perm_rng.permutation(len(train_set))
        start, skip_batches = skip_batches * batch_size, 0
        for i in range(start, len(order) - batch_size + 1, batch_size):
            yield collate_vocoder([train_set[j]
                                   for j in order[i:i + batch_size]],
                                  seq_len, hop_length, pad, mode=mode,
                                  bits=bits, rng=crop_rng)


def to_device(batch, device):
    """A host batch (x, y, mels) as tensors: y float32 (MOL) or int64
    labels (RAW)."""
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="dir with data_config.yaml + wavernn_config.yaml")
    parser.add_argument("--data", required=True,
                        help="dir with mel/ quant/ dataset.pkl")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--gta", action="store_true",
                        help="train on the GTA mels (gta/)")
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

    cm = ConfigManager(args.config, "wavernn", args.session_name)
    config = cm.config
    if primary:
        cm.create_remove_dirs(force=args.force)
        cm.dump_config()
        print(f"session {cm.session_name} in {cm.base_dir}")
    barrier()
    model = build_vocoder(config)
    init_flax(model, torch.Generator().manual_seed(INIT_SEED)).to(device)

    test_ids, train_ids = split_ids(vocoder_ids(args.data, config, args.gta),
                                    config.get("voc_test_samples", 50))
    train_set = VocoderDataset(train_ids, args.data, args.gta)
    test_set = VocoderDataset(test_ids, args.data, args.gta)
    batch_size = args.batch_size or config.get("voc_batch_size", 64)
    hop = config["hop_length"]
    seq_len = config.get("voc_seq_len_hops", 5) * hop

    lr = args.lr or float(config["learning_rate_tts_schedule"][0][1])
    state = TrainState(model, [[0, lr]])
    ckpt = CheckpointManager(cm.weights_dir)
    tree, rstep = ckpt.restore(map_location=device)
    if rstep is not None:
        state.load_state_dict(tree)
        if primary:
            print(f"restored vocoder weights at step {rstep}")
    replicate(state)
    step_fn = make_wavernn_train_step(model)

    perm_rng = np.random.default_rng(PERM_SEED)
    crop_rng = np.random.default_rng(CROP_SEED)
    skip = fast_forward_permutation(perm_rng, len(train_set), batch_size,
                                    state.step)
    batches = vocoder_batches(train_set, batch_size, seq_len, hop,
                              config.get("voc_pad", 2), model.mode,
                              config.get("bits", 9), perm_rng, crop_rng, skip)
    log = ScalarLog(cm.log_dir)
    max_steps = args.max_steps or config.get("voc_total_steps", 2_000_000)
    gen_every = config.get("voc_checkpoint_every", 25000)
    sync_every = int(config.get("metrics_sync_frequency", 10))
    weight_dtype = (torch.bfloat16 if device.type == "cuda"
                    else torch.float32)
    for step in range(state.step, max_steps):
        global_batch = next(batches)
        batch = to_device(local_shard(global_batch), device)
        sync()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch)
        sync()
        log.add_scalar("time/step_ms", (time.perf_counter() - t0) * 1e3,
                       step)
        log.add_scalar("meta/target_samples", global_batch[1].size, step)
        if step % sync_every == 0 or step + 1 == max_steps:
            loss_val = float(metrics["loss"])
            _guard(loss_val, step)
            if primary:
                print(f"step {step}: loss {loss_val:.5f}", flush=True)
            log.add_scalar("train/loss", loss_val, step)
        if (step + 1) % gen_every == 0 or step + 1 == max_steps:
            _guard(float(metrics["loss"]), step, " (before saving)")
            ckpt.save(step + 1, state.state_dict())
            weights = model.sample_weights(weight_dtype)
            n_gen = min(config.get("voc_gen_at_checkpoint", 5),
                        len(test_set)) if primary else 0
            for k in range(n_gen):
                mel, _ = test_set[k]
                wav = generate(
                    model, torch.from_numpy(mel.T).to(device),
                    batched=config.get("voc_gen_batched", True),
                    target=config.get("voc_target", 11000),
                    overlap=config.get("voc_overlap", 550),
                    mu_law=config.get("mu_law", True),
                    seed=fold_in(GEN_STREAM, k), weights=weights)
                save_wav(wav.cpu().numpy(),
                         cm.log_dir / f"gen_{step + 1}_{k}.wav",
                         config["sampling_rate"])
    if device.type == "cuda":
        log.add_scalar("meta/max_memory_allocated",
                       torch.cuda.max_memory_allocated(device),
                       max_steps - 1)
    if primary:
        print("Done.")


if __name__ == "__main__":
    main()
