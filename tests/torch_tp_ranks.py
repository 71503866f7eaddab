"""The tensor- and sequence-parallel cases of tests/test_torch_tp.py, and
one rank of them:

    python tests/torch_tp_ranks.py --port P --rank R --world N --work DIR

Each rank joins a gloo group of N on the CPU, runs the cases below on its
rows of the same global batches and writes its results to
``DIR/rank{R}.npz``. The test runs ``case`` with no mesh in its own
process for the single-process reference.

  - N = 2: the forward, AR (GST style encoder, a vocabulary of 41 split
    21 / 20) and WaveRNN train steps tensor-parallel on a (data 1, model
    2) mesh, in float64 with dropout, prenet dropout and HeadDrop on, and
    in float32 with them off (held against etts' single-device step); the
    AR step sequence-parallel on a (data 1, seq 2) mesh, in float64 and
    float32 the same way; the forward step's state gathered into a
    checkpoint (``tp.full_state_dict``), written by rank 0; then
    ``train_autoregressive`` with ``sequence_parallel: 2``.
  - N = 4: the forward step on a (data 2, model 2) mesh in float64.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# etts' TINY (tests/test_tensor_parallel.py:13-23)
TINY = dict(encoder_model_dimension=32, decoder_model_dimension=32,
            encoder_num_heads=(4, 4), decoder_num_heads=(4, 4),
            encoder_dense_blocks=2, decoder_dense_blocks=2,
            encoder_feed_forward_dimension=64,
            decoder_feed_forward_dimension=64,
            encoder_attention_conv_filters=32,
            decoder_attention_conv_filters=32,
            postnet_conv_filters=32, postnet_conv_layers=2,
            postnet_kernel_size=3, mel_channels=12, vocab_size=40,
            encoder_maximum_position_encoding=100,
            decoder_maximum_position_encoding=300)
AR = dict(TINY, system_type="style_text", max_r=2, vocab_size=41,
          encoder_prenet_dimension=32, decoder_prenet_dimension=32,
          ref_encoder_filters=(4, 8), ref_encoder_gru_cell_units=8,
          gst_style_embed_dim=16, gst_multi_num_heads=2, gst_heads=5)
VOC = dict(rnn_dims=16, fc_dims=16, bits=4, pad=2, upsample_factors=(2, 5),
           feat_dims=8, compute_dims=8, res_out_dims=8, res_blocks=1,
           hop_length=10, mode="RAW")
GLOBAL_B = 4
MAX_FRAMES = 20
R = 2
SEED = 3
DROPOUT = 0.1
STEPS = 3          # the SP driver's steps
CASES = {2: [("fwd", "model", "f64"), ("fwd", "model", "f32"),
             ("ar", "model", "f64"), ("ar", "model", "f32"),
             ("voc", "model", "f64"), ("voc", "model", "f32"),
             ("ar", "seq", "f64"), ("ar", "seq", "f32")],
         4: [("fwd", "model", "f64")]}


def build(kind: str, noisy: bool):
    """The kind's model, etts' initialisers seeded SEED; dropout on where
    ``noisy``."""
    from etts_torch.models.autoregressive import AutoregressiveTransformer
    from etts_torch.models.forward import ForwardTransformer
    from etts_torch.models.init import init_flax
    from etts_torch.models.wavernn import WaveRNN
    rate = DROPOUT if noisy else 0.0
    model = {"fwd": lambda: ForwardTransformer(**TINY, dropout_rate=rate),
             "ar": lambda: AutoregressiveTransformer(**AR, dropout_rate=rate),
             "voc": lambda: WaveRNN(**VOC)}[kind]()
    return init_flax(model, torch.Generator().manual_seed(SEED))


def global_batch(kind: str):
    """The kind's seeded global batch of GLOBAL_B rows, numpy."""
    rng = np.random.default_rng(7)
    if kind == "fwd":
        mel = rng.standard_normal((GLOBAL_B, MAX_FRAMES, 12)).astype(
            np.float32)
        phon = rng.integers(1, 40, (GLOBAL_B, 10))
        return mel, phon, np.full((GLOBAL_B, 10), 2.0, np.float32)
    if kind == "ar":
        # 33 frames: 32 teacher frames, 16 r-strided, 8 a seq rank
        mel = np.zeros((GLOBAL_B, 33, 12), np.float32)
        stop = np.zeros((GLOBAL_B, 33), np.int64)
        phon = np.zeros((GLOBAL_B, 7), np.int64)
        for i, (tl, nl) in enumerate(zip((33, 25, 30, 17), (7, 5, 6, 4))):
            mel[i, :tl] = 0.3 * rng.standard_normal((tl, 12))
            mel[i, 0], mel[i, tl - 1] = 0.5, -0.5
            stop[i, :tl], stop[i, tl - 1] = 1, 2
            phon[i, :nl] = rng.integers(1, 41, nl)
        return mel, phon, stop, np.zeros((GLOBAL_B, 1), np.float32)
    x = rng.uniform(-1, 1, (GLOBAL_B, 50)).astype(np.float32)
    y = rng.integers(0, 16, (GLOBAL_B, 50))
    return x, y, rng.standard_normal((GLOBAL_B, 9, 8)).astype(np.float32)


def mesh_for(axis: str, world: int):
    from etts_torch.parallel import make_mesh
    return make_mesh(("data", axis), (-1, 2)) if world > 1 else None


def case(kind: str, axis: str, precision: str, mesh=None) -> dict:
    """One train step of ``kind`` on this rank's part of its global batch
    (the whole batch with no ``mesh``): {"loss", "grad/<name>",
    "param/<name>" (after the update), "stat/<name>"}, every tensor whole
    (shards gathered). "f64": float64 with the noise on; "f32": float32
    with it off (etts' parity)."""
    from etts_torch.parallel import local_shard, tp
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import (fold_in, make_autoregressive_train_step,
                                        make_forward_train_step,
                                        make_wavernn_train_step)
    noisy = precision == "f64"
    dtype = torch.float64 if noisy else torch.float32
    model = build(kind, noisy).to(dtype)

    class Capture(TrainState):
        def apply_gradients(self, grads):
            self.grads = [g.detach().clone() for g in grads]
            super().apply_gradients(grads)
    state = Capture(model, [[0, 1e-3]])
    if mesh is not None and axis == "model":
        tp.shard_train_state(state, mesh)
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in
                  (local_shard(global_batch(kind), mesh)))
    batch = tuple(x.to(dtype) if x.is_floating_point() else x.long()
                  for x in batch)
    rng = fold_in(42, 0)
    if kind == "fwd":
        metrics = make_forward_train_step(model, MAX_FRAMES, mesh=mesh)(
            state, batch, rng)
    elif kind == "ar":
        metrics, _ = make_autoregressive_train_step(model, mesh=mesh)(
            state, batch, 0.0, rng, r=R,
            prenet_dropout=0.5 if noisy else 0.0,
            drop_n_heads=1 if noisy else 0)
    else:
        metrics = make_wavernn_train_step(model, mesh=mesh)(state, batch)
    out = {"loss": metrics["loss"].detach().double().numpy()}
    grads = tp.gather_like(model, state.params, state.grads)
    out.update({f"grad/{n}": g.double().numpy()
                for n, g in zip(state.names, grads)})
    for n, t in tp.gathered_state_dict(model).items():
        if n.endswith(("running_mean", "running_var")):
            out[f"stat/{n}"] = t.double().numpy()
        elif not n.endswith("num_batches_tracked"):
            out[f"param/{n}"] = t.double().numpy()
    return out


def checkpoint_case(work: Path, mesh):
    """The f64 forward step's state, gathered (``tp.full_state_dict``) and
    written by rank 0 to ``work/tp_ckpt.pt``."""
    from etts_torch.parallel import local_shard, tp
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import fold_in, make_forward_train_step
    model = build("fwd", True).double()
    state = tp.shard_train_state(TrainState(model, [[0, 1e-3]]), mesh)
    batch = tuple(torch.from_numpy(np.asarray(x)) for x in
                  local_shard(global_batch("fwd"), mesh))
    batch = tuple(x.double() if x.is_floating_point() else x.long()
                  for x in batch)
    make_forward_train_step(model, MAX_FRAMES, mesh=mesh)(
        state, batch, fold_in(42, 0))
    full = tp.full_state_dict(state)
    if torch.distributed.get_rank() == 0:
        torch.save(full, work / "tp_ckpt.pt")


def driver_argv(work: Path) -> list:
    return ["--config", str(work / "sp_ws"), "--device", "cpu",
            "--max_steps", str(STEPS)]


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
    meshes = {axis: mesh_for(axis, args.world) for axis in ("model", "seq")}
    out = {}
    for kind, axis, precision in CASES[args.world]:
        res = case(kind, axis, precision, meshes[axis])
        out.update({f"{kind}_{axis}_{precision}/{k}": v
                    for k, v in res.items()})
    np.savez(work / f"rank{args.rank}_of{args.world}.npz", **out)
    if args.world == 2:
        checkpoint_case(work, meshes["model"])
        from etts_torch.train_autoregressive import main as train_main
        train_main(driver_argv(work) + [
            "--session_name", "sp", "--multihost", "--coordinator_address",
            f"127.0.0.1:{args.port}", "--num_processes", str(args.world),
            "--process_id", str(args.rank), "--dist_backend", "gloo"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
