"""The data-parallel cases of tests/test_torch_multihost.py, and one rank
of them:

    python tests/torch_dp_ranks.py --port P --rank R --world N --work DIR

Each rank joins a gloo group of N on the CPU and runs, on its rows of the
same global batches, every case below; it writes its results to
``DIR/rank{R}.npz``. The test runs the same functions in its own process,
with no process group, for the single-process reference.

  - ``ar_case``: one AR train step at test width (the GST reference
    encoder's and the postnet's BatchNorm, dropout 0.1, prenet dropout
    0.5, HeadDrop 1) on a global batch of 4 padded rows, with the MINE
    zoo's update on the step's embeddings ("mine"), or with the zoo's
    estimate inside the tape ("adversarial", Rényi with CLUB beside; in
    float64, see ``DTYPES``). Rank 1 starts from other weights, which
    ``replicate`` must replace.
  - ``step_case``: one WaveRNN (MOL) train step, whose upsample network
    normalises by batch statistics, on a global batch of 4 crops; one
    GST-Tacotron train step (its CBHGs' and reference encoder's BatchNorm,
    the prenets' and zoneout's uniforms, the gradients clipped to a global
    norm) on a global batch of 4 texts; both in float64.
  - ``vocode_case``: ``generate_batch_sharded`` on a peaky RAW vocoder.
  - ``driver_case``: ``train_autoregressive``, ``train_wavernn`` and
    ``train_tacotron`` with ``--multihost`` for a few steps each on tiny
    corpora.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

AR_TEST = dict(
    system_type="speaker_style_text", mel_channels=12,
    encoder_model_dimension=32, decoder_model_dimension=32,
    encoder_num_heads=[2, 2], decoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    decoder_prenet_dimension=24, encoder_prenet_dimension=32,
    encoder_attention_conv_filters=32, decoder_attention_conv_filters=32,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=2, decoder_dense_blocks=2,
    ref_encoder_filters=[4, 8], ref_encoder_gru_cell_units=8,
    gst_style_embed_dim=16, gst_multi_num_heads=2, gst_heads=5,
    reduction_factor_schedule=[[0, 2]], dropout_rate=0.1, use_mine=True,
    mine_dense_hidden_units=[16, 8])
GLOBAL_B = 4
STEPS = 3           # the driver case's steps
R = 2
# The cases compared in float64: in float32 two summation orders leave
# some gradients further apart than the test's bar, and by an amount that
# moves with the host (oneDNN's instruction set, the thread count). The
# MOL vocoder's gradients, carried through its GRUs, move by 1e-4 to 1e-2
# of their scale (chip_smoke.py's VT_F32_GRAD); the zoo's MINE output bias,
# whose gradient is zero in exact arithmetic (mean(T) - log mean exp(T)
# does not move when T shifts), is 1 - 1 in float32, noise of one ulp of
# 1.0 (2.4e-7 against the 1e-7 the test allows a zero); a Tacotron CBHG
# conv kernel read 1.49e-5 of its scale apart. The "mine" case stays in
# float32.
DTYPES = {"mine": torch.float32, "adversarial": torch.float64,
          "voc": torch.float64, "taco": torch.float64}


def ar_config(kind: str) -> dict:
    cfg = yaml.safe_load(open(ROOT / "configs/default/"
                              "autoregressive_config.yaml"))
    cfg.update(yaml.safe_load(open(ROOT / "configs/default/"
                                   "data_config.yaml")))
    cfg.update(AR_TEST)
    if kind == "adversarial":
        cfg.update(mine_adversarial=True, divergence_type="reyni",
                   mine_type="MINE_CLUB")
    return cfg


def ar_batch(seed=0, t_mel=21, n=9, mel_c=12):
    """A global batch (mel, phonemes, stop, spk) of GLOBAL_B rows of
    different lengths, zero-padded as the Dataset pads it."""
    rng = np.random.default_rng(seed)
    mel = np.zeros((GLOBAL_B, t_mel, mel_c), np.float32)
    stop = np.zeros((GLOBAL_B, t_mel), np.int64)
    phon = np.zeros((GLOBAL_B, n), np.int64)
    for i, (tl, nl) in enumerate(zip((21, 14, 17, 9), (9, 6, 8, 4))):
        mel[i, :tl] = 0.3 * rng.standard_normal((tl, mel_c))
        mel[i, 0], mel[i, tl - 1] = 0.5, -0.5
        stop[i, :tl], stop[i, tl - 1] = 1, 2
        phon[i, :nl] = rng.integers(1, 40, nl)
    spk = rng.standard_normal((GLOBAL_B, 256)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=-1, keepdims=True)
    return mel, phon, stop, spk


def _capturing(module, schedule, **kw):
    from etts_torch.train.state import TrainState

    class Capture(TrainState):
        def apply_gradients(self, grads):
            self.grads = [g.detach().clone() for g in grads]
            super().apply_gradients(grads)
    return Capture(module, schedule, **kw)


def _step_outputs(metrics, state, model) -> dict:
    """{"loss", "grad/<name>", "stat/<name>"} of a step just taken."""
    out = {"loss": metrics["loss"].numpy()}
    out.update({f"grad/{n}": g.numpy()
                for n, g in zip(state.names, state.grads)})
    out.update({f"stat/{n}": b.numpy() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


def ar_case(kind: str) -> dict:
    """One step (and the zoo's update) on this process's rows of
    ``ar_batch()``: {"loss", "mi", "grad/<name>" (after the all-reduce),
    "stat/<name>" (the BatchNorm statistics it moved), "zoo/<i>/<name>"
    (the gradients of the zoo's update)}."""
    from etts_torch.models.init import init_flax
    from etts_torch.models.mine import MIState
    from etts_torch.parallel import local_shard, rank_world, replicate
    from etts_torch.text import default_tokenizer
    from etts_torch.train.steps import (fold_in, make_autoregressive_train_step,
                                        make_mine_zoo_update)
    from etts_torch.train_autoregressive import build_mine_zoo, to_device
    from etts_torch.utils.config import _mine_pair_types, build_tts
    cfg = ar_config(kind)
    cfg["mine_pair_types"] = _mine_pair_types(cfg)
    dtype = DTYPES[kind]
    model = build_tts(cfg, default_tokenizer(True).vocab_size)
    rank = rank_world()[0]
    init_flax(model, torch.Generator().manual_seed(42 + rank))
    model.to(dtype)
    state = _capturing(model, [[0, 1e-3]])
    replicate(state)
    nets = build_mine_zoo(cfg, 32, 16, 256)
    zoo = []
    for i, (_, net) in enumerate(nets):
        init_flax(net, torch.Generator().manual_seed(100 + i))
        net.to(dtype)
        zoo.append(_capturing(net, [[0, 1e-2]]))
    mi_state = MIState.create(len(cfg["mine_beta_values"]),
                              smoothing_factor=0.5)
    mi_state.exp_terms = mi_state.exp_terms.to(dtype)
    mi_state.mi_loss = mi_state.mi_loss.to(dtype)
    adversarial = kind == "adversarial"
    step = make_autoregressive_train_step(
        model, adversarial_mine=nets if adversarial else None)
    glob = ar_batch()
    batch = tuple(x.to(dtype) if x.is_floating_point() else x
                  for x in to_device(local_shard(glob), "cpu"))
    rng = fold_in(42, 0)
    metrics, aux = step(state, batch, mi_state if adversarial else 0.3, rng,
                        r=R, prenet_dropout=0.5, drop_n_heads=1)
    spk = torch.from_numpy(glob[3])[:, None].to(dtype)
    mis, _ = make_mine_zoo_update(nets)(
        zoo, aux["text_enc_output"], aux["gst_output"], spk, mi_state,
        [fold_in(rng, 200 + i) for i in range(len(nets))])
    out = _step_outputs(metrics, state, model)
    out.update(mi=mis.numpy(), mi_live=metrics["mi_live"].numpy())
    for i, st in enumerate(zoo):
        out.update({f"zoo/{i}/{n}": g.numpy()
                    for n, g in zip(st.names, st.grads)})
    return out


def step_case(kind: str, work: Path) -> dict:
    """One WaveRNN ("voc", MOL) or GST-Tacotron ("taco") train step on this
    process's rows of a seeded global batch of 4, from rank 0's weights:
    ``_step_outputs``."""
    from etts_torch.models.init import init_flax
    from etts_torch.models.tacotron import Tacotron
    from etts_torch.models.wavernn import WaveRNN
    from etts_torch.parallel import local_shard, rank_world, replicate
    from etts_torch.train.steps import (fold_in, make_tacotron_train_step,
                                        make_wavernn_train_step)
    widths = torch.load(work / "voc.pt", weights_only=True)
    rng = np.random.default_rng(5)
    if kind == "voc":
        model = WaveRNN(mode="MOL", **widths["kwargs"])
        glob = (rng.uniform(-1, 1, (GLOBAL_B, 50)).astype(np.float32),
                rng.uniform(-1, 1, (GLOBAL_B, 50)).astype(np.float32),
                rng.uniform(0, 1, (GLOBAL_B, 9, 8)).astype(np.float32))
        kw, step = {}, make_wavernn_train_step(model)
    else:
        model = Tacotron(**widths["taco_kwargs"])
        lengths = np.array([7, 5, 6, 4])
        ids = np.zeros((GLOBAL_B, 7), np.int64)
        for i, n in enumerate(lengths):
            ids[i, :n] = rng.integers(1, 30, n)
        glob = (ids, lengths,
                rng.uniform(0, 1, (GLOBAL_B, 12, 10)).astype(np.float32),
                rng.uniform(0, 1, (GLOBAL_B, 12, 33)).astype(np.float32))
        kw, step = dict(clip_norm=1.0), make_tacotron_train_step(model)
    init_flax(model, torch.Generator().manual_seed(rank_world()[0]))
    dtype = DTYPES[kind]
    model.to(dtype)
    state = replicate(_capturing(model, [[0, 1e-3]], **kw))
    batch = tuple(torch.from_numpy(x) for x in local_shard(glob))
    batch = tuple(x.to(dtype) if x.is_floating_point() else x
                  for x in batch)
    metrics = (step(state, batch) if kind == "voc"
               else step(state, batch, fold_in(42, 0)))
    return _step_outputs(metrics, state, model)


def voc_model(work: Path):
    """The peaky RAW vocoder the test wrote (VOC_TINY widths)."""
    from etts_torch.models.wavernn import WaveRNN
    spec = torch.load(work / "voc.pt", weights_only=True)
    model = WaveRNN(mode="RAW", **spec["kwargs"])
    model.load_state_dict(spec["state"])
    return model


def vocode_case(work: Path) -> dict:
    from etts_torch.models.wavernn import generate_batch_sharded
    mels = [torch.from_numpy(m) for m in np.load(work / "mels.npz").values()]
    wavs = generate_batch_sharded(voc_model(work), mels, target=30,
                                  overlap=10, mu_law=True, seed=0)
    return {f"wav/{i}": w.numpy() for i, w in enumerate(wavs)}


def driver_argv(work: Path, kind: str) -> list:
    """A driver's argv on the tiny corpus ``kind`` of ``work`` (the test
    adds the session, the multi-host flags for a rank)."""
    extra = ({"voc": ["--data", str(work / "voc_ws" / "store")]}
             ).get(kind, [])
    return ["--config", str(work / f"{kind}_ws"), "--device", "cpu",
            "--max_steps", str(STEPS), *extra]


DRIVERS = {"ar": "train_autoregressive", "voc": "train_wavernn",
           "taco": "train_tacotron"}


def driver_case(work: Path, port: int, rank: int, world: int):
    import importlib
    for kind, module in DRIVERS.items():
        importlib.import_module(f"etts_torch.{module}").main(
            driver_argv(work, kind) + [
                "--session_name", "dp", "--multihost",
                "--coordinator_address", f"127.0.0.1:{port}",
                "--num_processes", str(world), "--process_id", str(rank),
                "--dist_backend", "gloo"])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--work", required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    from etts_torch.parallel import init_multihost
    init_multihost(f"127.0.0.1:{args.port}", args.world, args.rank, "gloo")
    work = Path(args.work)
    out = {}
    for kind in ("mine", "adversarial"):
        out.update({f"{kind}/{k}": v for k, v in ar_case(kind).items()})
    for kind in ("voc", "taco"):
        out.update({f"{kind}/{k}": v
                    for k, v in step_case(kind, work).items()})
    out.update(vocode_case(work))
    np.savez(work / f"rank{args.rank}.npz", **out)
    driver_case(work, args.port, args.rank, args.world)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
