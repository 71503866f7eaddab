"""Joint AR-TTS + MINE training driver (port of
``scripts/train_autoregressive.py``).

    python -m etts_torch.train_autoregressive --config DIR \\
        [--session_name NAME] [--reset_dir --force] [--max_steps N] \\
        [--gta_mel_dir DIR] [--profile_dir DIR] [--device cuda|cpu] \\
        [--multihost [--coordinator_address HOST:PORT --num_processes N \\
         --process_id R] [--dist_backend nccl|gloo]]

``DIR`` holds ``data_config.yaml`` and ``autoregressive_config.yaml``; the
corpus under ``train_data_directory`` (else ``data_directory``) is what
``scripts/create_dataset.py`` writes: ``train_metafile.txt``
(``id|text|phonemes``), ``mels/{id}.npy`` (t, n_mels) and, for a speaker
system, ``spk_embeds/{id}.npy``. The model and the MINE/CLUB zoo start from
etts' initialisers (``init_flax``, seed 42); each step applies the
schedules of r, head drop, prenet dropout and scheduled sampling; the zoo
climbs its MI estimates on the step's embeddings (or, with
``mine_sep_call``, on a batch of its own); checkpoints of the model, the
optimizer, the step and the MI state go to the session's
``autoregressive_weights``, each net's to ``mine_weights_{i}``, and a rerun
resumes from the latest (``restored TTS weights at step N``), the data
stream continued. Scalars go to ``autoregressive_logs/scalars.jsonl``
(``etts_torch.utils.logging``), with the step's and the zoo's times: the
driver synchronises the device around each to time it. At
``prediction_frequency`` the driver decodes the batch's first text and
keeps its mel there (``prediction_mel_{step}.npy``), and, from
``audio_start_step`` at ``audio_prediction_frequency``, its Griffin-Lim
audio (``prediction_audio_{step}.wav``, ``ops.audio``).
``--profile_dir`` writes a ``torch.profiler`` trace of steps start + 10 to
start + 30 there (``utils.logging.StepTrace``). The config's ``precision``
sets the model's compute dtype (``utils.config.build_tts``); the weights,
the optimizer and the checkpoints stay float32.

Every random draw of a step comes from generators seeded from
``fold_in(42, step)``: a resumed run draws what an uninterrupted one does.
On the card the run never moves to the CPU; a loss that is not finite, or
above 1e4, raises.

Data parallelism (``--multihost``, ``etts_torch.parallel``): one process a
rank, started by torchrun or given the coordinator's address, its size and
its rank; each runs the whole data stream and trains on its rows of each
global batch of ``tts_batch_size``, the step being the global batch's
(the same BatchNorm statistics, noise and losses, the gradients averaged
over the ranks), and the MINE zoo updates on the global batch on every
rank (with ``mine_sep_call``, on its own whole batch). Rank 0 alone
prints, logs, predicts and writes checkpoints, which every rank then
restores from. ``sequence_parallel: N`` with N ranks or more (their count
a multiple of N) runs on a ("data", "seq") mesh: each group of N
neighbouring ranks shares rows of the global batch and splits their
teacher-forcing frames N ways (``train.steps``); with fewer ranks the run
is data-parallel, as etts falls back. The driver prints which ran.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .data.dataset import (DataPrepper, Dataset, GTADataPrepper, Prefetcher,
                           load_files)
from .models.autoregressive import autoregressive_predict
from .models.init import init_flax
from .models.mine import CLUB, MINE, MIState
from .ops.audio import AudioProcessor
from .parallel import (add_multihost_args, barrier, is_primary,
                       local_device, local_shard, make_mesh,
                       maybe_init_multihost, rank_world, replicate)
from .text import default_tokenizer
from .train.state import FROZEN_PRETRAINED, TrainState
from .train.steps import (fold_in, frozen_batch_stats, generator,
                          make_autoregressive_train_step,
                          make_mine_zoo_update)
from .utils.checkpoints import CheckpointManager
from .utils.config import (ConfigManager, build_tts,
                           piecewise_linear_schedule, step_schedule)
from .utils.logging import ScalarLog, StepTrace, ValueWindow
from .utils.precision import pin_float32

SEED = 42               # etts' PRNGKey(42)
LOSS_LIMIT = 1e4        # etts' explosion guard


def build_mine_zoo(config: dict, text_dim: int, style_dim: int,
                   spk_dim: int) -> list:
    """[(kind, net)]: a MINE and/or a CLUB per pair type, as ``mine_type``
    says (`scripts/train_autoregressive.py:34-56`). CLUB predicts the
    pair's target embedding, so its ``out_dim`` is that embedding's width:
    the text encoding's for style_text, the speaker's otherwise."""
    nets = []
    mine_type = config.get("mine_type", "MINE")
    dims = dict(text_dim=text_dim, style_dim=style_dim, spk_dim=spk_dim)
    hidden = tuple(config["mine_dense_hidden_units"])
    for pair in config["mine_pair_types"]:
        if mine_type in ("MINE", "MINE_CLUB"):
            nets.append(("MINE", MINE(
                pair, **dims, divergence_type=config["divergence_type"],
                beta_values=tuple(config["mine_beta_values"]),
                dense_hidden_units=hidden,
                conv_filters=tuple(config["mine_conv_filters"]),
                conv_kernel=config["mine_conv_kernel"])))
        if mine_type in ("CLUB", "MINE_CLUB"):
            nets.append(("CLUB", CLUB(
                pair, **dims, dense_hidden_units=hidden,
                out_dim=text_dim if pair == "style_text" else spk_dim)))
    return nets


def to_device(batch, device):
    """A host batch (mel, phonemes, stop, spk[, gta mel]) as tensors."""
    mel, phon, stop, spk, *gta = batch
    out = (torch.from_numpy(mel).to(device),
           torch.from_numpy(phon).long().to(device),
           torch.from_numpy(stop).long().to(device),
           torch.from_numpy(spk).to(device))
    return out + tuple(torch.from_numpy(g).to(device) for g in gta)


def _guard(loss: float, step: int, where: str = ""):
    if not np.isfinite(loss) or loss > LOSS_LIMIT:
        raise RuntimeError(f"Loss exploded to {loss} at step {step}{where}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="dir with data_config.yaml + "
                        "autoregressive_config.yaml")
    parser.add_argument("--session_name", default=None)
    parser.add_argument("--reset_dir", action="store_true")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--force", action="store_true",
                        help="skip the prompt of --reset_dir")
    parser.add_argument("--gta_mel_dir", default=None,
                        help="dir of a frozen checkpoint's teacher-forced "
                        "mels: the decoder reads these, the targets and the "
                        "style reference stay ground truth")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of steps "
                        "start + 10 to start + 30 here")
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

    cm = ConfigManager(args.config, "autoregressive", args.session_name)
    config = cm.config
    # context parallelism over a 'seq' axis (sequence_parallel: N, the
    # teacher-forcing mel's frames split N ways) where N ranks or more
    # take part; with fewer the run is data-parallel, as etts falls back
    seq_n, world = int(config.get("sequence_parallel", 1)), rank_world()[1]
    mesh = None
    if seq_n > 1 and world >= seq_n:
        nccl = (torch.distributed.is_initialized()
                and torch.distributed.get_backend() == "nccl")
        mesh = make_mesh(("data", "seq"), (-1, seq_n),
                         device_type="cuda" if nccl else "cpu")
        layout = (f"sequence parallelism: data {world // seq_n} x seq "
                  f"{seq_n}")
    elif world > 1:
        layout = f"data parallelism over {world} ranks"
    else:
        layout = "one process"
    if seq_n > 1 and world < seq_n:
        layout += (f" (sequence_parallel: {seq_n} needs {seq_n} ranks; "
                   f"{world} here)")
    if primary:
        cm.create_remove_dirs(clear_dir=args.reset_dir, force=args.force)
        cm.dump_config()
        print(f"session {cm.session_name} in {cm.base_dir}, {layout}")
    barrier()
    tokenizer = default_tokenizer(add_start_end=True)
    model = build_tts(config, tokenizer.vocab_size)
    init_flax(model, torch.Generator().manual_seed(SEED)).to(device)

    # datasets ---------------------------------------------------------------
    spk_dir = cm.train_datadir / "spk_embeds" if model.has_speaker else None
    if spk_dir is not None and not spk_dir.exists():
        raise FileNotFoundError(
            f"system_type={config['system_type']!r} needs precomputed speaker "
            f"embeddings in {spk_dir}; none found")
    samples, _ = load_files(cm.train_datadir / "train_metafile.txt",
                            cm.train_datadir / "mels", spk_dir,
                            config.get("n_samples"))
    prepper = (GTADataPrepper(config, tokenizer, args.gta_mel_dir)
               if args.gta_mel_dir else DataPrepper(config, tokenizer))
    dataset = Dataset(samples, prepper, config.get("tts_batch_size", 8),
                      mel_channels=config["mel_channels"])
    mine_bs_schedule = config.get("mine_batch_size_schedule", [[0, 256]])
    mine_dataset = None     # the MINE batch of its own (mine_sep_call)
    if config.get("use_mine") and config.get("mine_sep_call"):
        mine_dataset = Dataset(samples, prepper,
                               step_schedule(0, mine_bs_schedule),
                               mel_channels=config["mel_channels"], seed=43)

    # model and optimizer state ----------------------------------------------
    frozen = FROZEN_PRETRAINED if config.get("use_pretrained") else ()
    state = TrainState(model, config["learning_rate_tts_schedule"],
                       frozen=frozen)
    mi_state = MIState.create(
        n_beta=len(config.get("mine_beta_values", [0])),
        smoothing_factor=config.get("mine_smoothing_factor", 1.0),
        weight_factor=config.get("mine_weight_factor", 0.1), device=device)
    ckpt = CheckpointManager(cm.weights_dir,
                             max_to_keep=config.get("keep_n_weights"))
    tree, rstep = ckpt.restore(map_location=device)
    if rstep is not None:
        state.load_state_dict(tree)
        mi_state.load_state_dict(tree["mi_state"])
        if primary:
            print(f"restored TTS weights at step {rstep}")
    replicate(state)

    # the MINE zoo -----------------------------------------------------------
    mine_nets, mine_states, mine_ckpts = [], [], []
    if config.get("use_mine"):
        spk_dim = (int(np.load(samples[0][3]).shape[-1])
                   if model.has_speaker else 1)
        mine_nets = build_mine_zoo(config, config["encoder_model_dimension"],
                                   config["gst_style_embed_dim"], spk_dim)
        for i, (_, net) in enumerate(mine_nets):
            init_flax(net, torch.Generator().manual_seed(
                fold_in(SEED, 100 + i))).to(device)
            st = TrainState(net, config["learning_rate_mine_schedule"])
            mngr = CheckpointManager(cm.mine_weights_dir[i])
            net_tree, _ = mngr.restore(map_location=device)
            if net_tree is not None:
                st.load_state_dict(net_tree)
            mine_states.append(replicate(st))
            mine_ckpts.append(mngr)
    # an empty zoo (no pairs for the system type) trains without MI
    mine_zoo_step = make_mine_zoo_update(mine_nets) if mine_nets else None

    # the train step -----------------------------------------------------------
    adversarial = bool(config.get("mine_adversarial")) and bool(mine_nets)
    ss_schedule = config.get("scheduled_sampling_schedule", [[0, 0.0]])
    ss_enabled = any(float(v) > 0 for _, v in ss_schedule)
    train_step = make_autoregressive_train_step(
        model, stop_scaling=config.get("stop_loss_scaling", 1.0),
        use_style_loss=config.get("use_style_loss", False),
        mi_weight_factor=config.get("mine_weight_factor", 0.1),
        train_text_encoder=config.get("train_text_encoder", True),
        train_style_encoder=config.get("train_style_encoder", True),
        train_decoder=config.get("train_decoder", True),
        adversarial_mine=mine_nets if adversarial else None,
        scheduled_sampling=ss_enabled, gta_inputs=bool(args.gta_mel_dir),
        mesh=mesh)

    log = ScalarLog(cm.log_dir)
    avg_windows = {n: ValueWindow(n)
                   for n in config.get("n_steps_avg_losses", [100])}
    max_steps = args.max_steps or config["max_steps"]
    start_step = state.step
    if start_step:
        # continue the data stream (Dataset.seek)
        dataset.seek(start_step)
        if mine_dataset is not None:
            # change_batches restarts the stream, so the MINE stream is
            # continued approximately: the current size first, then the seek
            cur_bs = step_schedule(start_step, mine_bs_schedule)
            if cur_bs != mine_dataset.batch_size:
                mine_dataset.change_batches(cur_bs)
            mine_dataset.seek(start_step)
    loader = Prefetcher(dataset)
    sync_every = int(config.get("metrics_sync_frequency", 10))
    trace = (StepTrace(args.profile_dir, start_step + 10, start_step + 30,
                       device) if args.profile_dir and primary else None)
    audio = None            # the Griffin-Lim of the prediction audio
    try:
        for step in range(start_step, max_steps):
            global_batch = loader.next_batch()
            host_batch = local_shard(global_batch, mesh)
            batch = to_device(host_batch, device)
            rng = fold_in(SEED, step)
            r = step_schedule(step, config["reduction_factor_schedule"])
            drop_n = step_schedule(step, config["head_drop_schedule"])
            prenet_dropout = piecewise_linear_schedule(
                step, config["decoder_prenet_dropout_schedule"])
            ss_rate = (piecewise_linear_schedule(step, ss_schedule)
                       if ss_enabled else 0.0)
            sync()
            t0 = time.perf_counter()
            with (trace.span(step) if trace else contextlib.nullcontext()):
                metrics, aux = train_step(
                    state, batch,
                    mi_state if adversarial else mi_state.mi_loss, rng, r=r,
                    prenet_dropout=prenet_dropout, drop_n_heads=drop_n,
                    ss_rate=ss_rate)
                sync()
            t1 = time.perf_counter()
            log.add_scalar("time/step_ms", (t1 - t0) * 1e3, step)
            mel = global_batch[0]
            log.add_scalar("meta/target_frames",
                           int((np.abs(mel[:, 1:]).max(-1) > 0).sum()), step)

            if mine_zoo_step is not None:
                if mine_dataset is not None:
                    mel_m, phon_m, _, spk_m = to_device(
                        mine_dataset.next_batch(), device)[:4]
                    spk_for_mine = (spk_m[:, None] if model.has_speaker
                                    else None)
                    with torch.no_grad(), frozen_batch_stats(model):
                        enc = model.encode(
                            phon_m, mel_m[:, :-1][:, 0::r], spk_for_mine,
                            True, True, drop_n,
                            generator(fold_in(rng, 5), device))
                    text_out, gst_out = enc[6], enc[5]
                else:
                    # the global batch's embeddings and speakers
                    text_out, gst_out = aux["text_enc_output"], aux[
                        "gst_output"]
                    spk_for_mine = (
                        torch.from_numpy(global_batch[3]).to(device)[:, None]
                        if model.has_speaker
                        else batch[0].new_zeros(len(global_batch[0]), 1, 1))
                rngs = [fold_in(rng, 200 + i) for i in range(len(mine_nets))]
                mi_vals, terms = mine_zoo_step(mine_states, text_out, gst_out,
                                               spk_for_mine, mi_state, rngs)
                # the sum over nets, the last net's exp_terms (etts)
                mi_state.mi_loss, mi_state.exp_terms = mi_vals.sum(), terms
                new_bs = step_schedule(step, mine_bs_schedule)
                if mine_dataset is not None and \
                        new_bs != mine_dataset.batch_size:
                    mine_dataset.change_batches(new_bs)
                sync()
                log.add_scalar("time/mine_ms",
                               (time.perf_counter() - t1) * 1e3, step)

            if step % sync_every == 0 or step + 1 == max_steps:
                loss_val = float(metrics["loss"])
                _guard(loss_val, step)
                for w in avg_windows.values():
                    w.append(loss_val)
                if primary:
                    print(f"step {step}: loss {loss_val:.5f} " + " ".join(
                        f"avg{n} {w.average:.4f}"
                        for n, w in avg_windows.items()), flush=True)
                log.add_scalar("train/loss", loss_val, step)
                log.add_scalar("train/tts_loss", float(metrics["tts_loss"]),
                               step)
                for k, v in metrics["losses"].items():
                    log.add_scalar(f"train/{k}", float(v), step)
                log.add_scalar("meta/reduction_factor", r, step)
                log.add_scalar("meta/prenet_dropout", prenet_dropout, step)
                if ss_enabled:
                    log.add_scalar("meta/scheduled_sampling_rate", ss_rate,
                                   step)
                if mine_zoo_step is not None:
                    for i, mv in enumerate(mi_vals.tolist()):
                        log.add_scalar(f"mi/{mine_nets[i][0]}_{i}", mv, step)

            if ((step + 1) % config["weights_save_frequency"] == 0
                    or step + 1 == max_steps):
                # every save is guarded: a loss gone bad between syncs must
                # not replace a good checkpoint
                _guard(float(metrics["loss"]), step, " (before saving)")
                ckpt.save(step + 1, {**state.state_dict(),
                                     "mi_state": mi_state.state_dict()})
                for mngr, st in zip(mine_ckpts, mine_states):
                    mngr.save(step + 1, st.state_dict())

            if (primary and (step + 1) % config["prediction_frequency"] == 0
                    and step + 1 >= config.get("prediction_start_step", 0)):
                mel, phon, _, spk = host_batch[:4]
                ref = (model.encode_ref(torch.from_numpy(mel[0]).to(device),
                                        r) if model.has_style else None)
                spk_in = (torch.from_numpy(spk[0]).to(device)[None, None]
                          if model.has_speaker else None)
                out = autoregressive_predict(
                    model, torch.from_numpy(phon[:1]).long().to(device), ref,
                    spk_in, r=r, max_length=min(mel.shape[1] * 2, 1000),
                    prenet_dropout=prenet_dropout,
                    generator=generator(fold_in(rng, 9), device))
                pred = out["mel"][0, :out["mel_length"]].float()
                log.save_mel(pred.cpu().numpy(), "prediction/mel", step)
                if (step + 1 >= config.get("audio_start_step", 0)
                        and (step + 1) % config.get(
                            "audio_prediction_frequency", 10 ** 9) == 0):
                    if audio is None:
                        audio = AudioProcessor(config)
                    log.add_audio("prediction/audio",
                                  audio.reconstruct_waveform(pred.T).cpu(),
                                  config["sampling_rate"], step)
            if trace:
                trace.end_step(step)
        if device.type == "cuda":
            log.add_scalar("meta/max_memory_allocated",
                           torch.cuda.max_memory_allocated(device),
                           max_steps - 1)
    finally:
        loader.stop()
        if trace:
            trace.close()
    if primary:
        print("Done.")


if __name__ == "__main__":
    main()
