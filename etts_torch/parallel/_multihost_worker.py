"""One rank of a data-parallel job (port of
``etts/parallel/_multihost_worker.py``).

    python -m etts_torch.parallel._multihost_worker --port P \\
        --process_id R [--num_processes N] [--device cpu|cuda] \\
        [--dist_backend gloo|nccl] [--ckpt_dir DIR]

Joins the process group of N ranks at ``127.0.0.1:P`` (``init_multihost``;
with N = 1 it joins none), takes its ``local_shard`` of a numpy-seeded
global batch of 8, starts from rank 0's state (``replicate``) and runs ONE
data-parallel train step of etts' tiny ``ForwardTransformer``, dropout on.
Prints ``MULTIHOST_LOSS <value>``: every rank prints the global batch's
loss, which one process on the whole batch matches
(``tests/test_torch_multihost.py``). With ``--ckpt_dir`` rank 0 saves the
state and logs the loss, every rank restores the checkpoint into a fresh
state and takes one more step: ``MULTIHOST_RESUME_LOSS <value>``.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--process_id", type=int, required=True)
    parser.add_argument("--num_processes", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--dist_backend", choices=("gloo", "nccl"),
                        default="gloo")
    parser.add_argument("--ckpt_dir", default=None,
                        help="save, restore and log across the group")
    args = parser.parse_args(argv)

    from ..models.forward import ForwardTransformer
    from ..models.init import init_flax
    from ..train.state import TrainState
    from ..train.steps import fold_in, make_forward_train_step
    from . import init_multihost, local_device, local_shard, replicate

    if args.num_processes > 1:
        assert init_multihost(f"127.0.0.1:{args.port}", args.num_processes,
                              args.process_id, args.dist_backend)
    device = local_device(args.device)

    def fresh(seed):
        model = ForwardTransformer(
            encoder_model_dimension=32, decoder_model_dimension=32,
            encoder_num_heads=(2, 2), decoder_num_heads=(2, 2),
            encoder_dense_blocks=2, decoder_dense_blocks=2,
            encoder_feed_forward_dimension=64,
            decoder_feed_forward_dimension=64,
            encoder_attention_conv_filters=32,
            decoder_attention_conv_filters=32, postnet_conv_filters=32,
            postnet_conv_layers=2, postnet_kernel_size=3, mel_channels=12,
            vocab_size=40, encoder_maximum_position_encoding=100,
            decoder_maximum_position_encoding=300)
        init_flax(model, torch.Generator().manual_seed(seed)).to(device)
        return model, TrainState(model, [[0, 1e-3]])

    # the same global batch on every rank (same seed)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((8, 20, 12)).astype(np.float32)
    phon = rng.integers(1, 40, (8, 10))
    durs = np.full((8, 10), 2.0, np.float32)
    batch = tuple(torch.from_numpy(x).to(device)
                  for x in local_shard((mel, phon, durs)))
    model, state = fresh(0)
    replicate(state)
    step = make_forward_train_step(model, max_frames=20)
    loss = float(step(state, batch, 0)["loss"])
    print(f"MULTIHOST_LOSS {loss:.8f}", flush=True)
    assert np.isfinite(loss)

    if args.ckpt_dir:
        from ..utils.checkpoints import CheckpointManager
        from ..utils.logging import ScalarLog
        ScalarLog(Path(args.ckpt_dir) / "logs").add_scalar("train/loss",
                                                           loss, 1)
        ckpt = CheckpointManager(args.ckpt_dir, max_to_keep=2)
        ckpt.save(1, state.state_dict())        # rank 0 writes, all wait
        assert ckpt.latest_step() == 1, ckpt.latest_step()
        # a fresh state restored from the file continues alike everywhere
        model2, restored = fresh(9)
        tree, rstep = ckpt.restore(map_location=device)
        assert rstep == 1, rstep
        restored.load_state_dict(tree)
        for a, b in zip(restored.params, state.params, strict=True):
            assert torch.equal(a, b)
        step2 = make_forward_train_step(model2, max_frames=20)
        loss2 = float(step2(restored, batch, fold_in(0, 1))["loss"])
        print(f"MULTIHOST_RESUME_LOSS {loss2:.8f}", flush=True)
    if args.num_processes > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
