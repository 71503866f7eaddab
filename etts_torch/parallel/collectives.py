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

The collectives are ``all_reduce`` only (a gather sums zero-padded rows):
gloo all-reduces CUDA tensors as well as CPU ones, so two ranks may share
one card on gloo, which NCCL refuses.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

__all__ = ["rank_world", "sharded", "sharded_step", "rand",
           "mean_over_ranks", "gather_rows", "average_gradients",
           "global_mean"]

_STEP = None     # (rank, world) while a data-parallel step runs


def rank_world(group=None) -> tuple:
    """(this process's rank, the group's size); (0, 1) without a process
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def sharded() -> bool:
    """Whether a data-parallel step runs: the tensors with a batch axis
    hold this rank's rows of the global batch."""
    return _STEP is not None


def sharded_step(step):
    """Decorate a train step: with a process group of more than one rank,
    each call runs as this rank's part of the global batch's step."""
    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        global _STEP
        rank, world = rank_world()
        if world == 1:
            return step(*args, **kwargs)
        saved, _STEP = _STEP, (rank, world)
        try:
            return step(*args, **kwargs)
        finally:
            _STEP = saved
    return wrapped


def rand(shape, generator=None, device=None, batch_dim: int = 0):
    """``torch.rand(shape)`` from ``generator`` on ``device``; in a
    data-parallel step, this rank's rows (along ``batch_dim``) of the draw
    at the global batch's shape, so that every rank keeps its part of the
    one draw a single process makes."""
    if _STEP is None:
        return torch.rand(shape, generator=generator, device=device)
    rank, world = _STEP
    shape = list(shape)
    b = shape[batch_dim]
    shape[batch_dim] = b * world
    return torch.rand(shape, generator=generator, device=device).narrow(
        batch_dim, rank * b, b)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks'
    gradients (every rank's loss reads the one sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def mean_over_ranks(x):
    """The mean of ``x`` over the ranks of a data-parallel step, with its
    gradient (``x`` itself outside one)."""
    if _STEP is None:
        return x
    return _AllSum.apply(x) / _STEP[1]


def gather_rows(x, dim: int = 0):
    """The global batch (all ranks' rows in rank order along ``dim``) of
    this rank's ``x`` (every rank holds the same shape), with its
    gradient: the rows' share of every rank's loss reaches this rank's
    rows. ``x`` itself with no process group or a group of one. Exact:
    the other ranks' places hold zeros in the sum."""
    rank, world = rank_world()
    if world == 1:
        return x
    dim %= x.dim()
    n = x.shape[dim]
    full = torch.nn.functional.pad(
        x, [0, 0] * (x.dim() - 1 - dim) + [rank * n, (world - 1 - rank) * n])
    return _AllSum.apply(full)


def average_gradients(grads: list) -> list:
    """The mean over the ranks of a data-parallel step of each gradient,
    in one all-reduce of their concatenation (``grads`` as they are
    outside one)."""
    if _STEP is None or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= _STEP[1]
    return [f.view_as(g) for f, g in zip(flat.split([g.numel()
                                                     for g in grads]),
                                         grads)]


def global_mean(tree):
    """A dict (nested) of metrics with every 0-d tensor replaced by its
    mean over the ranks of a data-parallel step, in one all-reduce; other
    values are left as they are (the rank's rows)."""
    if _STEP is None:
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
    flat = torch.stack([v.detach().float() for v in leaves])
    dist.all_reduce(flat)
    means = iter((flat / _STEP[1]).unbind())

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

