"""GRU cell with separate input and hidden biases (port of
``etts/ops/gru.py:33-71``): gates [r, z, n], ``n = tanh(gi_n + r * gh_n)``.
Parameters keep the flax layout: wi (in, 3h), wh (h, 3h), bi, bh (3h,).
On bf16 inputs and parameters the scan follows etts' rounding: both gate
projections sum in float32 and add their bf16 bias in float32, and only h
rounds to bf16, once a step."""
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


def gru_scan(wi, wh, bi, bh, xs, h0=None, reverse: bool = False):
    """xs (b, t, in) -> (outputs (b, t, h), final h); the input projection
    for all steps is one matmul, only the recurrent one is sequential.
    ``reverse`` runs from the last step to the first, each output kept at
    its step's place, as ``lax.scan(reverse=True)`` does (the backward half
    of Tacotron's CBHG BiGRU, `etts/models/tacotron.py:122-123`)."""
    if xs.dtype == torch.bfloat16:
        return _gru_scan_bf16(wi, wh, bi, bh, xs, h0, reverse)
    b, t, _ = xs.shape
    h = xs.new_zeros(b, wh.shape[0]) if h0 is None else h0
    # unbind, not an index a step: its backward stacks the steps'
    # gradients once, where indexing would add t zero-padded copies of
    # the whole (b, t, 3h) projection
    gi = (xs @ wi + bi).unbind(1)
    ys = [None] * t
    for i in (reversed(range(t)) if reverse else range(t)):
        h = gru_cell(gi[i], h, wh, bh)
        ys[i] = h
    return torch.stack(ys, 1), h


def _gru_scan_bf16(wi, wh, bi, bh, xs, h0, reverse: bool):
    """``gru_scan`` on bf16 xs: the bf16 operands' products exact in
    float32, summed in float32 (etts' ``preferred_element_type``), the gates
    in float32, h rounded to bf16 after each step."""
    wi, wh, bi, bh = (p.to(torch.bfloat16).float() for p in (wi, wh, bi, bh))
    b, t, _ = xs.shape
    h = (xs.new_zeros(b, wh.shape[0]) if h0 is None
         else h0.to(torch.bfloat16))
    gi = (xs.float() @ wi + bi).unbind(1)
    ys = [None] * t
    for i in (reversed(range(t)) if reverse else range(t)):
        h = gru_cell(gi[i], h.float(), wh, bh).to(torch.bfloat16)
        ys[i] = h
    return torch.stack(ys, 1), h
