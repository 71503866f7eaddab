"""Tensor parallelism (port of ``etts/parallel/tp.py``).

etts writes megatron-style sharding as ``NamedSharding``s on the
parameter tree and lets GSPMD insert the collectives, its flax modules
unchanged. Here each rank of a ``model`` mesh axis holds its shard of a
parameter, in place of the whole tensor (``apply_tp_sharding``), and the
module that owns it runs the collectives itself (``Shard.dense``,
``Shard.embed``, ``models.layers.MultiHeadAttention``). The rules are
etts':

  - column-parallel (the output axis split): ``ffn/d1``, ``mha/w{q,k,v}``,
    ``FinalProj`` and WaveRNN's ``I``, ``fc1``, ``fc2``, ``fc3``, each bias
    with its outputs;
  - row-parallel (the input axis split): ``ffn/d2``, its bias replicated
    and added after the sum;
  - every embedding table split along its vocabulary;
  - everything else replicated: the concat-query ``mha/dense`` (its input
    is only half head-sharded), the GRU gate matrices, the norms.

The port's ``Dense`` holds torch's (out, in) weight, so etts' ``P(None,
'model')`` on a kernel (its outputs split) is ``Shard(0)`` here, and
``P('model', None)`` (its inputs split) is ``Shard(1)``; an embedding's
``P('model', None)`` is ``Shard(0)`` of its (vocab, d) table.

The arithmetic is megatron's. A column-parallel product reads its input
through ``_Copy`` (the identity; its backward sums the input's partial
gradients over the model axis) and keeps its output shard: the attention
runs on its heads, the FFN on its hidden units. A row-parallel product
sums its partial outputs over the model axis (``_Reduce``, whose backward
is the identity), then adds its bias. The head-sharded attention output,
``FinalProj``'s and WaveRNN's column outputs are gathered (``_Gather``: the
shards in order, its backward the rank's part) before the layer that
needs the whole width. The vocabulary-sharded lookup reads the rank's
rows, zeroes the ids outside them and sums over the model axis.

An axis that does not divide by the model axis is split as GSPMD pads
it, ceil(n / size) a rank and the last ranks short (a vocabulary,
fc3's 30 MoL outputs over 4): the sums and gathers give the unsharded
result. A head count or an FFN width the axis does not divide raises.

Every collective is an all-reduce (a gather sums zero-padded shards):
gloo has no reduce-scatter and all-reduces CUDA tensors, so ranks may
share a card on gloo. The data axis is the train step's
(``collectives.step_layout``): a replicated parameter's gradient is
complete on every model rank and averages over the data axis, a shard's
averages over the data axis with the same shard's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["tp_param_specs", "apply_tp_sharding", "shard_train_state",
           "gathered_state_dict", "full_state_dict", "gather_like", "Shard"]

_COLUMN = re.compile(
    r"(ffn/d1|mha/wq|mha/wk|mha/wv|FinalProj|(^|/)(I|fc1|fc2|fc3))$")
_ROW = re.compile(r"(ffn/d2)$")
# column outputs gathered at once (the attention keeps its heads, the FFN
# its hidden units)
_GATHERED = re.compile(r"(FinalProj|(^|/)(I|fc1|fc2|fc3))$")


def _split(n: int, size: int, rank: int) -> tuple:
    """[start, stop) of ``rank``'s part of an axis of ``n``, GSPMD's
    padding: ceil(n / size) a rank."""
    per = -(-n // size)
    start = min(rank * per, n)
    return start, min(start + per, n)


def tp_param_specs(model: nn.Module, model_axis: str = "model") -> dict:
    """{parameter name: its placement along ``model_axis``}, for every
    parameter of ``model``: ``torch.distributed.tensor``'s ``Shard(dim)``
    of the port's layout, or ``Replicate()`` (etts' rules, module
    docstring)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard as Split
    del model_axis      # one axis: the placements are along it
    specs = {}
    for mod_name, mod in model.named_modules():
        path = mod_name.replace(".", "/")
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            spec = Replicate()
            if p.dim() == 0:
                pass
            elif isinstance(mod, nn.Embedding) and leaf == "weight":
                spec = Split(0)
            elif isinstance(mod, nn.Linear) and _COLUMN.search(path):
                spec = Split(0)
            elif (isinstance(mod, nn.Linear) and _ROW.search(path)
                  and leaf == "weight"):
                spec = Split(1)
            specs[name] = spec
    return specs


@dataclass(frozen=True)
class Shard:
    """A layer's place in tensor parallelism: ``kind`` "column", "row" or
    "vocab", its shard [start, stop) of the ``full`` split axis, this
    rank's ``rank`` of ``size`` in ``group``, and whether a column
    layer's output is ``gathered``."""
    kind: str
    group: object
    rank: int
    size: int
    full: int
    start: int
    stop: int
    gathered: bool = False

    def dense(self, layer, x, affine):
        """``layer``'s product under its shard; ``affine(x, weight, bias)``
        is the layer's own (its compute dtype's casts)."""
        if self.kind == "column":
            y = affine(_Copy.apply(x, self.group), layer.weight, layer.bias)
            return _Gather.apply(y, self) if self.gathered else y
        y = _Reduce.apply(affine(x, layer.weight, None), self.group)
        return y if layer.bias is None else y + layer.bias.to(y.dtype)

    def embed(self, weight, ids):
        """The rows of ``ids`` of a vocabulary-sharded table: this rank's
        rows, zeros for ids outside them, summed over the model axis."""
        local = ids - self.start
        inside = (local >= 0) & (local < self.stop - self.start)
        if self.stop == self.start:
            rows = weight.new_zeros(*ids.shape, weight.shape[1])
        else:
            rows = F.embedding(local.clamp(0, self.stop - self.start - 1),
                               weight)
            rows = rows * inside[..., None].to(rows.dtype)
        return _Reduce.apply(rows, self.group)

    def gather(self, x, dim: int = -1):
        """The whole axis ``dim`` from every rank's shard ``x``."""
        return _Gather.apply(x, self, dim)


class _Copy(torch.autograd.Function):
    """megatron's f: the identity; the gradient summed over the model
    axis (each rank's shard reads all of x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """megatron's g: the sum over the model axis; the gradient passes as
    it is (every rank reads the one sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """The shards of an axis in order (each rank's zero-padded to the
    whole axis and summed); the gradient is the rank's part of it."""

    @staticmethod
    def forward(ctx, x, shard: Shard, dim: int = -1):
        dim %= x.dim()
        ctx.dim, ctx.shard = dim, shard
        full = F.pad(x, [0, 0] * (x.dim() - 1 - dim)
                     + [shard.start, shard.full - shard.stop])
        dist.all_reduce(full, group=shard.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.narrow(ctx.dim, s.start, s.stop - s.start), None, None


def _axis(mesh, model_axis: str) -> tuple:
    """(group, rank, size) of ``model_axis`` of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    if model_axis not in names:
        raise ValueError(f"no {model_axis!r} axis in the mesh {names}")
    return (mesh.get_group(model_axis), mesh.get_local_rank(model_axis),
            mesh.size(names.index(model_axis)))


def _check(model: nn.Module, size: int):
    """Raise where the model axis does not divide a head count or an FFN
    width (no silent replication)."""
    for name, mod in model.named_modules():
        heads = getattr(mod, "num_heads", None)
        if heads is not None and hasattr(mod, "wq") and heads % size:
            raise ValueError(f"{name}: {heads} heads do not split over a "
                             f"model axis of {size}")
        if name.endswith("ffn") and hasattr(mod, "d1"):
            width = mod.d1.out_features
            if width % size:
                raise ValueError(f"{name}: an FFN width of {width} does not "
                                 f"split over a model axis of {size}")


def apply_tp_sharding(model: nn.Module, mesh, model_axis: str = "model"):
    """Shard ``model`` in place over ``model_axis`` of ``mesh`` by
    ``tp_param_specs``: each sharded parameter keeps only this rank's part
    (the same ``Parameter``, its data replaced) and its layer a ``Shard``
    that runs the collectives. Every rank must hold the same whole model
    first (``mesh.replicate``). Returns ``model``."""
    group, rank, size = _axis(mesh, model_axis)
    _check(model, size)
    specs = tp_param_specs(model, model_axis)
    for mod_name, mod in model.named_modules():
        path = mod_name.replace(".", "/")
        w = getattr(mod, "weight", None)
        if w is None or not isinstance(mod, (nn.Linear, nn.Embedding)):
            continue
        spec = specs[f"{mod_name}.weight" if mod_name else "weight"]
        if not hasattr(spec, "dim"):
            continue
        if isinstance(mod, nn.Embedding):
            kind = "vocab"
        else:
            kind = "column" if spec.dim == 0 else "row"
        full = w.shape[spec.dim]
        start, stop = _split(full, size, rank)
        with torch.no_grad():
            w.data = w.data.narrow(spec.dim, start, stop - start).clone()
            if kind == "column" and mod.bias is not None:
                mod.bias.data = mod.bias.data[start:stop].clone()
        mod.tp = Shard(kind, group, rank, size, full, start, stop,
                       gathered=bool(_GATHERED.search(path)))
    return model


def _sharded(module: nn.Module):
    """[(parameter, its Shard, the split dim)] of a sharded module."""
    out = []
    for mod in module.modules():
        tp = getattr(mod, "tp", None)
        if tp is None:
            continue
        out.append((mod.weight, tp, 1 if tp.kind == "row" else 0))
        if tp.kind == "column" and mod.bias is not None:
            out.append((mod.bias, tp, 0))
    return out


def shard_train_state(state, mesh, model_axis: str = "model"):
    """Shard a ``TrainState`` of a whole model: the module by
    ``apply_tp_sharding``, Adam's moments (``exp_avg``, ``exp_avg_sq``)
    like their parameter, the step counts and BatchNorm statistics
    replicated. Returns ``state``."""
    apply_tp_sharding(state.module, mesh, model_axis)
    for p, tp, dim in _sharded(state.module):
        for k, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() and k != "step":
                state.optimizer.state[p][k] = v.narrow(
                    dim, tp.start, tp.stop - tp.start).clone()
    return state


def _whole(t, tp: Shard, dim: int):
    with torch.no_grad():
        return _Gather.apply(t.detach(), tp, dim)


def gather_like(module: nn.Module, params, tensors) -> list:
    """``tensors`` (a gradient, a moment: one a parameter of ``params``,
    ``module``'s) whole: each one of a sharded parameter gathered along
    its split axis, the others as they are."""
    whole = {id(p): (tp, dim) for p, tp, dim in _sharded(module)}
    return [_whole(t, *whole[id(p)]) if id(p) in whole else t
            for p, t in zip(params, tensors, strict=True)]


def gathered_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with every tensor-parallel shard gathered
    to its whole tensor (on every rank): the unsharded model's."""
    whole = {id(p): (tp, dim) for p, tp, dim in _sharded(module)}
    out = {}
    for name, t in module.state_dict(keep_vars=True).items():
        out[name] = (_whole(t, *whole[id(t)]) if id(t) in whole
                     else t.detach().clone())
    return out


def full_state_dict(state) -> dict:
    """A tensor-parallel ``TrainState``'s ``state_dict`` in the format of
    the unsharded state's (its module's and Adam's tensors gathered): a
    checkpoint rank 0 writes as it writes any other."""
    d = state.state_dict()
    d["model"] = gathered_state_dict(state.module)
    whole = {id(p): (tp, dim) for p, tp, dim in _sharded(state.module)}
    for i, p in enumerate(state.params):
        if id(p) not in whole:
            continue
        if i not in d["optimizer"]["state"]:
            continue
        # a copy: the optimizer's state_dict holds its live dicts
        st = d["optimizer"]["state"][i] = dict(d["optimizer"]["state"][i])
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() and k != "step":
                st[k] = _whole(v, *whole[id(p)])
    return d
