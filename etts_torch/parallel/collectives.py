"""The global-batch semantics of a data-parallel step (no counterpart
module in etts: under GSPMD the step is the global batch's by
construction).

Each rank of a ``torch.distributed`` process group runs the same step on
its rows of one global batch (``mesh.local_shard``). Three things make
that step the global batch's, and this module holds each:

  - BatchNorm on batch statistics: the moments are averaged over the ranks
    with the gradient through them (``mean_over_ranks``), and the running
    statistics move by the global moments (``models.layers.batch_norm``);
  - noise: every draw is made at the global batch's shape from the step's
    generator, as one process draws it, and the rank keeps its rows
    (``rand``);
  - batch-coupled losses (the MINE/CLUB estimators' log-mean-exp terms and
    batch maxima, the marginal's permutation) see the global batch through
    ``gather_rows``, whose gradient reaches each rank's rows.

The train steps run inside ``sharded_step`` and average their gradients
over the ranks (``average_gradients``) before the update, and report the
global batch's losses (``global_mean``): the mean of equal-size ranks'
means, as every loss of the port divides by the count of positions of a
batch padded once, before it is sliced. Outside a data-parallel step (no
process group, a group of one, or code that is not a train step) every
function here is the plain single-process one.

A step over a mesh (``sharded_step(step, mesh)``, ``step_layout``) takes
its rows from the mesh's ``data`` axis. Under tensor parallelism
(("data", "model")) the model axis computes one loss, so the averages run
over the data axis. Under sequence parallelism (("data", "seq"), the AR
step) each seq rank holds its frames of the rows (``SeqShard``) and its
share of the loss, so the averages run over every rank; the decoder runs
in a ``time_region``, where a 3-d draw is the whole sequence's and the
rank keeps its frames, and what mixes time gathers the sequence.

The collectives are ``all_reduce`` only (a gather sums zero-padded rows):
gloo all-reduces CUDA tensors as well as CPU ones, so two ranks may share
one card on gloo, which NCCL refuses.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["rank_world", "rows", "sharded", "sharded_step", "rand",
           "mean_over_ranks", "gather_rows", "average_gradients",
           "global_mean", "SeqShard", "seq_shard", "time_region",
           "step_layout"]


@dataclass(frozen=True)
class SeqShard:
    """This rank's place on the ``seq`` axis of a sequence-parallel step:
    its ``rank`` of ``size`` in ``group``. A time axis of T frames splits
    as GSPMD pads it: ceil(T / size) frames a rank, the last ranks
    short."""
    rank: int
    size: int
    group: object

    def bounds(self, total: int, rank: Optional[int] = None) -> tuple:
        """[start, stop) of ``rank``'s (this one's) frames of ``total``."""
        per = -(-total // self.size)
        rank = self.rank if rank is None else rank
        start = min(rank * per, total)
        return start, min(start + per, total)

    def local(self, x, total: Optional[int] = None, dim: int = 1,
              per_frame: int = 1):
        """This rank's frames of the whole sequence ``x`` of ``total``
        frames (``x.shape[dim]`` where not given), each frame
        ``per_frame`` rows along ``dim``; the rows past ``x``'s end are
        left out."""
        total = x.shape[dim] if total is None else total
        start, stop = self.bounds(total)
        start, stop = (min(i * per_frame, x.shape[dim])
                       for i in (start, stop))
        return x.narrow(dim, start, stop - start)

    def gather(self, x, total: int, dim: int = 1, per_frame: int = 1):
        """The whole sequence of ``total`` frames along ``dim`` (each
        ``per_frame`` rows) from every rank's frames ``x``, with its
        gradient: each rank's frames get the gradient every rank's loss
        sends them (one all-reduce of the zero-padded sequence, exact)."""
        dim %= x.dim()
        start, stop = (i * per_frame for i in self.bounds(total))
        if x.shape[dim] != stop - start:
            raise ValueError(f"{x.shape[dim]} rows along dim {dim}; rank "
                             f"{self.rank} holds {stop - start} of "
                             f"{total * per_frame}")
        full = torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 1 - dim)
            + [start, total * per_frame - stop])
        return _AllSum.apply(full, self.group)


@dataclass(frozen=True)
class _Layout:
    """A data-parallel step's ranks: this rank's ``rank`` of ``world`` on
    the data axis (its rows of the global batch; ``group`` joins those
    ranks), and the ``avg_world`` ranks of ``avg_group`` that its
    gradients, metrics and BatchNorm moments average over: the data axis
    under tensor parallelism (the model axis computes one loss), every
    rank under sequence parallelism (each holds its part of the loss).
    ``seq``: this rank's place on the seq axis, or None."""
    rank: int
    world: int
    group: object = None
    avg_group: object = None
    avg_world: int = 1
    seq: Optional[SeqShard] = None


_STEP: Optional[_Layout] = None     # while a data-parallel step runs
_TIME: Optional[tuple] = None       # (start, stop, total) of a time region


def rank_world(group=None) -> tuple:
    """(this process's rank, the group's size); (0, 1) without a process
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rows() -> tuple:
    """(this rank's part, the parts) of the global batch's rows in a
    data-parallel step; (0, 1) outside one."""
    return (0, 1) if _STEP is None else (_STEP.rank, _STEP.world)


def sharded() -> bool:
    """Whether a data-parallel step runs: the tensors with a batch axis
    hold this rank's rows of the global batch."""
    return _STEP is not None


def seq_shard() -> Optional[SeqShard]:
    """This rank's place on the seq axis in a sequence-parallel step, else
    None."""
    return None if _STEP is None else _STEP.seq


def step_layout(mesh=None) -> Optional[_Layout]:
    """The layout of a step over ``mesh`` (a ``DeviceMesh`` whose first
    axis is ``data``, its second, if any, ``model`` or ``seq``), or over
    every rank of the process group without one; None for a single
    process."""
    if mesh is None:
        rank, world = rank_world()
        return (None if world == 1
                else _Layout(rank, world, None, None, world))
    names = tuple(mesh.mesh_dim_names)
    if names[0] != "data" or len(names) > 2 or (
            len(names) == 2 and names[1] not in ("model", "seq")):
        raise ValueError(f"a step's mesh has the axes ('data',), ('data', "
                         f"'model') or ('data', 'seq'); got {names}")
    data = mesh.get_group("data")
    rank, world = mesh.get_local_rank("data"), mesh.size(0)
    if len(names) == 1 or names[1] == "model":
        return _Layout(rank, world, data, data, world)
    seq = SeqShard(mesh.get_local_rank("seq"), mesh.size(1),
                   mesh.get_group("seq"))
    return _Layout(rank, world, data, None, mesh.size(), seq)


def sharded_step(step, mesh=None):
    """Decorate a train step: with a process group of more than one rank,
    each call runs as this rank's part of the global batch's step, over
    the ranks of ``mesh`` where given (``step_layout``)."""
    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        global _STEP
        layout = step_layout(mesh)
        if layout is None:
            return step(*args, **kwargs)
        saved, _STEP = _STEP, layout
        try:
            return step(*args, **kwargs)
        finally:
            _STEP = saved
    return wrapped


@contextlib.contextmanager
def time_region(start: int, stop: int, total: int):
    """Code whose (b, t, d) tensors hold frames [start, stop) of ``total``
    along t (the decoder of a sequence-parallel step): ``rand`` draws
    such a tensor's noise at the whole sequence's length and keeps these
    frames."""
    global _TIME
    saved, _TIME = _TIME, (start, stop, total)
    try:
        yield
    finally:
        _TIME = saved


def in_time_region() -> Optional[tuple]:
    """(start, stop, total) inside a ``time_region``, else None."""
    return _TIME


def rand(shape, generator=None, device=None, batch_dim: int = 0):
    """``torch.rand(shape)`` from ``generator`` on ``device``; in a
    data-parallel step, this rank's rows (along ``batch_dim``) of the draw
    at the global batch's shape, so that every rank keeps its part of the
    one draw a single process makes; in a ``time_region``, a 3-d draw's
    frames too."""
    if _STEP is None and _TIME is None:
        return torch.rand(shape, generator=generator, device=device)
    shape = list(shape)
    time = _TIME if _TIME is not None and len(shape) == 3 else None
    if time is not None:
        shape[1] = time[2]
    rank, world = rows()
    b = shape[batch_dim]
    shape[batch_dim] = b * world
    out = torch.rand(shape, generator=generator, device=device).narrow(
        batch_dim, rank * b, b)
    if time is not None:
        out = out.narrow(1, time[0], time[1] - time[0])
    return out


class _AllSum(torch.autograd.Function):
    """The sum over the ranks of ``group``; its gradient is the sum of the
    ranks' gradients (every rank's loss reads the one sum)."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def mean_over_ranks(x):
    """The mean of ``x`` over the ranks a data-parallel step averages over,
    with its gradient (``x`` itself outside one)."""
    if _STEP is None or _STEP.avg_world == 1:
        return x
    return _AllSum.apply(x, _STEP.avg_group) / _STEP.avg_world


def gather_rows(x, dim: int = 0):
    """The global batch (all ranks' rows in rank order along ``dim``) of
    this rank's ``x`` (every rank holds the same shape), with its
    gradient: the rows' share of every rank's loss reaches this rank's
    rows. Over the data axis in a data-parallel step, else over every rank
    of the process group; ``x`` itself over one rank. Exact: the other
    ranks' places hold zeros in the sum."""
    if _STEP is not None:
        (rank, world), group = rows(), _STEP.group
    else:
        (rank, world), group = rank_world(), None
    if world == 1:
        return x
    dim %= x.dim()
    n = x.shape[dim]
    full = torch.nn.functional.pad(
        x, [0, 0] * (x.dim() - 1 - dim) + [rank * n, (world - 1 - rank) * n])
    return _AllSum.apply(full, group)


def average_gradients(grads: list) -> list:
    """The mean over the ranks of a data-parallel step of each gradient,
    in one all-reduce of their concatenation (``grads`` as they are
    outside one). A tensor-parallel shard's gradient stays on its shard:
    it averages over the data axis with the same shard's."""
    if _STEP is None or _STEP.avg_world == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_STEP.avg_group)
    flat /= _STEP.avg_world
    return [f.view_as(g) for f, g in zip(flat.split([g.numel()
                                                     for g in grads]),
                                         grads)]


def global_mean(tree):
    """A dict (nested) of metrics with every 0-d tensor replaced by its
    mean over the ranks of a data-parallel step, in one all-reduce; other
    values are left as they are (the rank's rows)."""
    if _STEP is None or _STEP.avg_world == 1:
        return tree
    leaves = []

    def collect(t):
        for k, v in t.items():
            if isinstance(v, dict):
                collect(v)
            elif torch.is_tensor(v) and v.dim() == 0:
                leaves.append(v)
    collect(tree)
    if not leaves:
        return tree
    # float32 sums, float64 where a metric is float64
    wide = torch.float64 if any(v.dtype == torch.float64 for v in leaves) \
        else torch.float32
    flat = torch.stack([v.detach().to(wide) for v in leaves])
    dist.all_reduce(flat, group=_STEP.avg_group)
    means = iter((flat / _STEP.avg_world).unbind())

    def rebuild(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = rebuild(v)
            elif torch.is_tensor(v) and v.dim() == 0:
                out[k] = next(means).to(v.dtype)
            else:
                out[k] = v
        return out
    return rebuild(tree)
