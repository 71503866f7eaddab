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
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

__all__ = ["read_flat", "convert", "load_into"]

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
