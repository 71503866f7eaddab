"""The port's process-group helpers (``etts_torch.parallel``) in one
process: etts' mesh cases (tests/test_parallel_utils.py) under a gloo
group of one rank, made and destroyed by a fixture; the rows of a global
batch as each rank would take them; the Dataset's per-host shards against
etts'; the multi-host flags; ``generate_batch_sharded`` with no group
against ``generate_batch``; and the AR driver's ``sequence_parallel``
rule. The two-rank runs are in tests/test_torch_multihost.py."""
import argparse
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from etts.data.dataset import Dataset as JDataset
from etts_torch import parallel
from etts_torch.data.dataset import Dataset
from etts_torch.parallel import mesh
from torch_parity import t, voc_pair


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def world1():
    """A gloo process group of one rank, destroyed after the test."""
    assert parallel.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                   "gloo") is False
    try:
        yield
    finally:
        dist.destroy_process_group()
    assert parallel.rank_world() == (0, 1)


class TestMakeMesh:
    def test_1d_all_ranks(self, world1):
        m = parallel.make_mesh(("data",))
        assert m.shape == (1,) and m.mesh_dim_names == ("data",)

    def test_2d_with_wildcard(self, world1):
        assert parallel.make_mesh(("data", "model"), (-1, 1)).shape == (1, 1)

    def test_explicit_sizes(self, world1):
        m = parallel.make_mesh(("a", "b"), (1, 1))
        assert m.shape == (1, 1) and m.mesh_dim_names == ("a", "b")

    def test_multi_axis_requires_sizes(self, world1):
        with pytest.raises(ValueError):
            parallel.make_mesh(("a", "b"))

    def test_sizes_must_make_the_world(self, world1):
        with pytest.raises(ValueError):
            parallel.make_mesh(("a", "b"), (2, 4))


class TestSharding:
    def test_shard_batch_places_leading_dim(self, world1):
        from torch.distributed.tensor import Shard
        x = torch.arange(16.0).reshape(8, 2)
        (xs,) = parallel.shard_batch((x,), parallel.make_mesh(("data",)))
        assert xs.placements == (Shard(0),)
        assert torch.equal(xs.full_tensor(), x)

    def test_replicate(self, world1):
        tree = {"w": torch.ones(4, 4)}
        assert parallel.replicate(tree) is tree
        assert torch.equal(tree["w"], torch.ones(4, 4))

    def test_local_batch_slice_single_process(self, world1):
        assert parallel.local_batch_slice(32) == slice(0, 32)

    def test_rejoining_keeps_or_raises(self, world1):
        assert parallel.init_multihost("127.0.0.1:1", 1, 0, "gloo") is False
        with pytest.raises(RuntimeError, match="process group"):
            parallel.init_multihost("127.0.0.1:1", 1, 0, "nccl")


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_each_rank_takes_its_rows(monkeypatch, rank):
    """A rank of 4 keeps its quarter of every array of a global batch, in
    rank order; a batch that does not split raises."""
    monkeypatch.setattr(mesh, "rank_world", lambda group=None: (rank, 4))
    assert parallel.local_batch_slice(32) == slice(8 * rank, 8 * rank + 8)
    batch = (np.arange(8)[:, None] * np.ones((1, 3)),
             {"ids": torch.arange(8)})
    a, d = parallel.local_shard(batch)
    np.testing.assert_array_equal(a[:, 0], [2 * rank, 2 * rank + 1])
    assert d["ids"].tolist() == [2 * rank, 2 * rank + 1]
    with pytest.raises(ValueError):
        parallel.local_batch_slice(30)


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_dataset_shards_match_etts(shard):
    """``Dataset(shard_index, num_shards)``: every num_shards-th sample
    from shard_index, shuffled and batched as etts' of the same
    samples."""
    rng = np.random.default_rng(0)
    samples = [(rng.standard_normal((int(rng.integers(5, 30)), 4)).astype(
                    np.float32), rng.integers(1, 9, n).astype(np.int32),
                np.full(n, 2.0, np.float32))
               for n in rng.integers(3, 9, 23)]
    kw = dict(batch_size=2, mel_channels=4, shard_index=shard, num_shards=3)
    ours = Dataset(samples, lambda s: s, **kw)
    etts = JDataset(samples, lambda s: s, **kw)
    assert len(ours) == len(etts) == len(samples[shard::3])
    for _ in range(6):
        for a, b in zip(ours.next_batch(), etts.next_batch()):
            np.testing.assert_array_equal(a, b)


def test_multihost_flags_and_devices(monkeypatch):
    parser = parallel.add_multihost_args(argparse.ArgumentParser())
    args = parser.parse_args(["--multihost", "--coordinator_address",
                              "10.0.0.1:8476", "--num_processes", "4",
                              "--process_id", "2", "--dist_backend", "gloo"])
    assert (args.multihost, args.coordinator_address, args.num_processes,
            args.process_id, args.dist_backend) == (
        True, "10.0.0.1:8476", 4, 2, "gloo")
    assert parallel.maybe_init_multihost(parser.parse_args([])) is False
    assert not dist.is_initialized()
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        parallel.init_multihost()
    assert parallel.local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.local_device("cuda")


def test_generate_batch_sharded_single_process_is_generate_batch():
    """With no process group the sharded vocoding is ``generate_batch``
    seeded ``fold_in(seed, 0)``, bit for bit (MOL: the draws count)."""
    from etts_torch.models.wavernn import (generate_batch,
                                           generate_batch_sharded)
    from etts_torch.utils.seeds import fold_in
    _, _, tm = voc_pair("MOL")
    rng = np.random.default_rng(1)
    mels = [t(rng.uniform(0, 1, (n, 8)).astype(np.float32)) for n in (9, 6)]
    got = generate_batch_sharded(tm, mels, target=30, overlap=10, seed=5)
    want = generate_batch(tm, mels, target=30, overlap=10,
                          seed=fold_in(5, 0))
    assert len(got) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sequence_parallel_not_ported(tmp_path, monkeypatch, capsys):
    """``sequence_parallel: N`` with N ranks or more builds the ("data",
    "seq") mesh (context parallelism, ported since slice 20; the steps
    themselves are tests/test_torch_tp.py's); with fewer the driver trains
    data-parallel and says so (here: one rank seen as two, so that only
    the rule reads it)."""
    import etts_torch.train_autoregressive as tar
    from torch_parity import tiny_corpus
    argv = ["--config", str(tmp_path), "--device", "cpu", "--max_steps",
            "1"]
    monkeypatch.setattr(tar, "rank_world", lambda group=None: (0, 2))
    asked = []

    class Built(Exception):
        pass

    def make_mesh(*args, **kwargs):
        asked.append(args)
        raise Built
    monkeypatch.setattr(tar, "make_mesh", make_mesh)
    tiny_corpus(tmp_path, sequence_parallel=2)
    with pytest.raises(Built):
        tar.main(argv)
    assert asked == [(("data", "seq"), (-1, 2))]
    tiny_corpus(tmp_path, sequence_parallel=4)
    tar.main(argv)
    assert asked == [(("data", "seq"), (-1, 2))]
    assert ("data parallelism over 2 ranks (sequence_parallel: 4 needs 4 "
            "ranks; 2 here)") in capsys.readouterr().out
