"""GRU cell with separate input and hidden biases (port of
``etts/ops/gru.py:33-71``): gates [r, z, n], ``n = tanh(gi_n + r * gh_n)``.
Parameters keep the flax layout: wi (in, 3h), wh (h, 3h), bi, bh (3h,)."""
from __future__ import annotations

import torch

__all__ = ["gru_cell", "gru_scan"]


def gru_cell(gi, h, wh, bh):
    """One step from the precomputed input projection gi (b, 3h)."""
    hd = h.shape[-1]
    gh = h @ wh + bh
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    return (1.0 - z) * n + z * h


def gru_scan(wi, wh, bi, bh, xs, h0=None):
    """xs (b, t, in) -> (outputs (b, t, h), final h); the input projection
    for all steps is one matmul, only the recurrent one is sequential."""
    b, t, _ = xs.shape
    h = xs.new_zeros(b, wh.shape[0]) if h0 is None else h0
    gi_all = xs @ wi + bi
    ys = []
    for i in range(t):
        h = gru_cell(gi_all[:, i], h, wh, bh)
        ys.append(h)
    return torch.stack(ys, 1), h
