"""Process groups, meshes and the global batch's rows (port of
``etts/parallel/mesh.py``).

etts runs one SPMD program over a ``jax.sharding.Mesh`` and lets GSPMD
insert the gradient reduction. The port runs one process a rank, joined in
a ``torch.distributed`` process group (``init_multihost``), each on its own
device (``local_device``): every rank runs the same seeded data stream,
keeps its rows of each global batch (``local_shard``), starts from rank 0's
state (``replicate``) and runs the train step, which averages the
gradients over the ranks before the update and keeps the global batch's
BatchNorm statistics, noise and batch-coupled losses (``collectives``).

Backends: ``nccl`` where every rank has a card of its own; ``gloo`` on the
CPU, or for ranks that share one card (NCCL refuses two ranks on one
GPU; gloo all-reduces CUDA tensors). The backend is the one asked for:
nothing here switches backend or device after a failure.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..train.state import TrainState
from .collectives import rank_world

__all__ = ["init_multihost", "add_multihost_args", "maybe_init_multihost",
           "make_mesh", "shard_batch", "replicate", "local_batch_slice",
           "local_shard", "local_device", "is_primary", "barrier"]

TIMEOUT = datetime.timedelta(seconds=300)   # a collective a peer never joins


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "gloo",
                   timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group: ``torch.distributed.init_process_group`` on
    ``tcp://coordinator_address`` (``host:port``, rank 0's) with
    ``num_processes`` ranks, this one ``process_id``, on ``backend``.
    Without an address the four are torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (the counterpart of
    etts' detection on TPU pods). A group already joined with the same
    size, rank and backend is kept; any other raises. Returns whether more
    than one rank takes part."""
    env = os.environ
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(
                f"--multihost without --coordinator_address needs torchrun's "
                f"environment; {', '.join(missing)} not set")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if have != (num_processes, process_id, backend):
            raise RuntimeError(
                f"a process group of (size, rank, backend) {have} is joined; "
                f"asked for {(num_processes, process_id, backend)}")
        return num_processes > 1
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return num_processes > 1


def add_multihost_args(parser):
    """The flags every training driver takes: etts' four, and
    ``--dist_backend``, the torch counterpart of picking a platform."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group before "
                        "any device use (data-parallel training)")
    parser.add_argument("--coordinator_address", default=None,
                        help="rank 0's host:port, e.g. 10.0.0.1:8476 "
                        "(torchrun's MASTER_ADDR:MASTER_PORT where omitted)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="ranks in all (torchrun's WORLD_SIZE where "
                        "omitted)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (torchrun's RANK where "
                        "omitted)")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="nccl: a card a rank; gloo: the CPU, or ranks "
                        "sharing a card (default: nccl with --device cuda, "
                        "else gloo)")
    return parser


def _backend(args) -> str:
    if args.dist_backend:
        return args.dist_backend
    return ("nccl" if torch.device(getattr(args, "device", "cuda")).type
            == "cuda" else "gloo")


def maybe_init_multihost(args) -> bool:
    """A driver's entry, before any device use: join the process group
    where ``--multihost`` is set. Returns whether more than one rank takes
    part."""
    if getattr(args, "multihost", False):
        return init_multihost(args.coordinator_address, args.num_processes,
                              args.process_id, _backend(args))
    return False


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``device`` itself where it names an index or is
    not a card, or where no process group is joined; else the card of
    index ``LOCAL_RANK`` (torchrun's; the rank where unset): under NCCL
    that card must exist, one a rank; under gloo the ranks wrap round the
    host's cards (two ranks on one card share it). The card becomes the
    current one."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    if device.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        count = torch.cuda.device_count()
        if dist.get_backend() == "nccl" and local >= count:
            raise RuntimeError(
                f"nccl: local rank {local} has no card of its own ({count} "
                "on this host); use --dist_backend gloo for ranks that "
                "share a card")
        device = torch.device("cuda", local % count)
    if device.index is not None:
        torch.cuda.set_device(device)
    return device


def is_primary() -> bool:
    """Whether this process writes logs, checkpoints and progress: rank
    0, or the only process."""
    return rank_world()[0] == 0


def barrier():
    """Wait for every rank (nothing without a process group)."""
    if rank_world()[1] > 1:
        dist.barrier()


def make_mesh(axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None,
              device_type: str = "cpu"):
    """A ``DeviceMesh`` over every rank of the process group, the axes
    named ``axis_names`` with ``axis_sizes`` (one axis: all ranks; a -1
    takes what the others leave), in rank order, the last axis fastest:
    ("data", "model") and ("data", "seq") are the train steps' (a tensor-
    or sequence-parallel group of neighbouring ranks on each data index).
    Each axis has its process group, ``mesh.get_group(axis)``, of the
    world's backend. A multi-axis mesh needs its sizes, and sizes that do
    not make the world size raise, as etts' reshape does.
    ``device_type``: "cuda" for NCCL groups."""
    from torch.distributed.device_mesh import init_device_mesh
    n = rank_world()[1]
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        axis_sizes = (n,)
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"mesh sizes {tuple(sizes)} do not divide the "
                             f"{n} ranks of the process group")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh sizes {tuple(sizes)} do not make the {n} "
                         "ranks of the process group")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axis_names))


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows (``local_shard`` of the global batch) as
    ``DTensor``s sharded along their first dimension over the mesh axis
    ``axis``, replicated over any other: ``full_tensor()`` is the global
    batch. A tuple, list or dict of tensors, or one tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    place = [Shard(0) if name == axis else Replicate()
             for name in mesh.mesh_dim_names]

    def put(x):
        return DTensor.from_local(torch.as_tensor(x), mesh, place,
                                  run_check=False)
    return _tree_map(put, batch)


def replicate(obj, src: int = 0):
    """Rank ``src``'s tensors on every rank, in place: a ``TrainState``
    (its module's parameters and buffers, its optimizer's state), a
    module, or a dict, list or tuple of tensors. Returns ``obj``."""
    if rank_world()[1] == 1:
        return obj
    for t in _tensors(obj):
        with torch.no_grad():
            dist.broadcast(t, src)
    return obj


def _tensors(obj):
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, TrainState):
        out = _tensors(obj.module)
        for st in obj.optimizer.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
        return out
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


def local_batch_slice(global_batch_size: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """This rank's slice of a global batch (``rank`` of ``world`` parts,
    the process group's where not given): equal parts in rank order."""
    if rank is None:
        rank, world = rank_world()
    if global_batch_size % world:
        raise ValueError(f"a global batch of {global_batch_size} rows does "
                         f"not split over {world} ranks")
    per = global_batch_size // world
    return slice(per * rank, per * (rank + 1))


def local_shard(batch, mesh=None):
    """A global batch (a tuple, list or dict of arrays or tensors, or one)
    cut down to this rank's rows (of ``mesh``'s data axis where given:
    the ranks of a model or seq axis keep the same rows); the batch itself
    in a single process. Every rank runs the same seeded data stream and
    keeps its slice."""
    if mesh is not None:
        rank, world = mesh.get_local_rank("data"), mesh.size(0)
    else:
        rank, world = rank_world()
    if world == 1:
        return batch
    return _tree_map(lambda x: x[local_batch_slice(len(x), rank, world)],
                     batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
