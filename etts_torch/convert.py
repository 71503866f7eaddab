"""Carry flax weights into the port's modules.

Input: the flat ``{jax.tree_util.keystr(path): array}`` dict that
``scripts/export_params_npz.py:56-72`` writes (BatchNorm running statistics
under a ``batch_stats:`` prefix), or the path of such an npz. The port names
its modules after the flax tree, so a key maps mechanically:
``['Decoder']['CADB_0']['sarn']['mha']['wq']['kernel']`` ->
``Decoder.CADB_0.sarn.mha.wq.weight``, with the layout transposed:

  - Dense (in, out) -> (out, in)
  - Conv (k, in, out) -> (out, in, k)
  - Conv2d (kh, kw, in, out) -> (out, in, kh, kw)

Raw parameters (GRU ``*_wi``, ``gst_tokens``) keep the flax layout.
``export_flat`` is the inverse: a port module's weights in that layout;
``seeded_flat`` draws a module's weights from a seed and exports them so.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

__all__ = ["read_flat", "convert", "load_into", "export_flat"]

_KEY_RE = re.compile(r"\['([^']+)'\]")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}


def read_flat(src) -> dict:
    """npz path or flat dict -> {key: float32 ndarray}."""
    if isinstance(src, (str, Path)):
        with np.load(src) as z:
            return {k: z[k].astype(np.float32) for k in z.files}
    return {k: np.asarray(v, np.float32) for k, v in src.items()}


def _torch_name(key: str) -> str:
    key = key.removeprefix("batch_stats:")
    parts = _KEY_RE.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise KeyError(f"not a keystr path: {key!r}")
    leaf = parts[-1]
    if leaf in _LEAF:
        parts[-1] = _LEAF[leaf]
    return ".".join(parts)


def _to_torch_layout(key: str, a: np.ndarray) -> np.ndarray:
    if not key.endswith("['kernel']"):
        return a
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"{key}: unexpected kernel rank {a.ndim}")


def convert(src, module: torch.nn.Module) -> dict:
    """Flat flax weights -> a float32 ``state_dict`` for ``module``.

    Raises on a key the module has no place for, on a shape mismatch, and on
    any module parameter the weights do not provide. BatchNorm running
    statistics may be absent (the committed exports have none): those keep
    the module's init values, mean 0 and variance 1."""
    flat = read_flat(src)
    expected = module.state_dict()
    out, unknown = {}, []
    for key, arr in flat.items():
        name = _torch_name(key)
        if name not in expected:
            unknown.append(key)
            continue
        t = torch.from_numpy(np.array(_to_torch_layout(key, arr)))
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} does not fit "
                             f"{name} {tuple(expected[name].shape)}")
        out[name] = t
    if unknown:
        raise KeyError(f"weights with no place in {type(module).__name__}: "
                       f"{unknown[:5]} ({len(unknown)} in all)")
    optional = ("running_mean", "running_var", "num_batches_tracked")
    missing = [n for n in expected
               if n not in out and not n.endswith(optional)]
    if missing:
        raise KeyError(f"{type(module).__name__} parameters not found in the "
                       f"weights: {missing[:5]} ({len(missing)} in all)")
    return out


def load_into(module: torch.nn.Module, src) -> torch.nn.Module:
    """``convert`` then load; returns the module in eval mode."""
    module.load_state_dict(convert(src, module), strict=False)
    return module.eval()


_NORMS = (torch.nn.LayerNorm, torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)


def export_flat(module: torch.nn.Module) -> dict:
    """A port module's weights as the flat ``{keystr: float32 ndarray}``
    dict that ``convert`` reads (BatchNorm running statistics under
    ``batch_stats:``), kernels in the flax layout: the inverse of
    ``convert``. The arrays are copies: training the module on leaves
    them as they were."""
    flat = {}
    for name, t in module.state_dict().items():
        path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(path)
        key = "".join(f"['{p}']" for p in path.split(".")) if path else ""
        a = t.detach().cpu().float().numpy().copy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            flat[f"batch_stats:{key}['{leaf[len('running_'):]}']"] = a
        elif leaf == "weight" and isinstance(owner, torch.nn.Embedding):
            flat[key + "['embedding']"] = a
        elif leaf == "weight" and isinstance(owner, _NORMS):
            flat[key + "['scale']"] = a
        elif leaf == "weight":
            # torch (out, in, *k) -> flax (*k, in, out)
            flat[key + "['kernel']"] = a.transpose(*range(2, a.ndim), 1, 0)
        else:
            flat[f"{key}['{leaf}']"] = a
    return flat


def seeded_flat(module: torch.nn.Module, seed: int,
                std_1d: float = 0.02) -> dict:
    """Draw every parameter and BatchNorm statistic of a port module in
    place from a CPU torch generator seeded with ``seed``, and return them
    as ``export_flat`` does: matrices and kernels (embeddings, GRU and
    style tokens too) normal with std 1 / sqrt(fan in), other 1-D
    parameters normal ``std_1d``, norm scales 1 + that, running means
    normal 0.1, running variances uniform in [0.5, 1.5]."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, x in module.state_dict(keep_vars=True).items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                x.copy_(0.5 + torch.rand(x.shape, generator=g))
                continue
            std = (x[0].numel() ** -0.5 if x.dim() > 1
                   else 0.1 if name.endswith("running_mean") else std_1d)
            noise = torch.randn(x.shape, generator=g) * std
            scale = name.endswith("weight") and x.dim() == 1
            x.copy_(1.0 + noise if scale else noise)
    return export_flat(module)
