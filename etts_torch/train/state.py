"""Train state: a module with ``torch.optim.Adam`` on etts' settings
(port of ``etts/train/state.py``).

Adam(0.9, 0.98, eps 1e-9) as the reference's (`config_manager.py:171-176`);
the learning rate comes from a piecewise-linear schedule and is set before
each update with optax's count: the k-th update (from 0) uses
``schedule(k)``. Frozen top-level modules (the pretrained text-encoder
transplant freezes ``FROZEN_PRETRAINED``) are left out of the optimizer,
where etts zeroes their updates. With ``clip_norm`` the gradients are
first clipped to that global norm by optax's ``clip_by_global_norm``
formula (GST-Tacotron clips at 1.0, `gst_tacotron/models/tacotron.py:197`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["TrainState", "interp_schedule", "clip_by_global_norm",
           "FROZEN_PRETRAINED"]

FROZEN_PRETRAINED = ("TextEncoder", "TextEmbedding")


def interp_schedule(schedule) -> Callable[[int], float]:
    """[[step, value], ...] -> the piecewise-linear function of the step,
    clamped at both ends, with the float32 arithmetic of etts'
    ``jnp.interp`` as XLA compiles it on the CPU (the last multiply-add
    fused, one rounding)."""
    arr = np.asarray(schedule, np.float32)
    xs, ys = arr[:, 0], arr[:, 1]

    def lr(step) -> float:
        x = np.float32(step)
        if x <= xs[0] or len(xs) == 1:
            return float(ys[0] if x <= xs[0] else ys[-1])
        if x >= xs[-1]:
            return float(ys[-1])
        i = int(np.searchsorted(xs, x, side="right"))
        dx = xs[i] - xs[i - 1]
        if dx == 0:
            return float(ys[i - 1])
        q = np.float32((x - xs[i - 1]) / dx)
        return float(np.float32(np.float64(ys[i - 1]) + np.float64(q)
                                * np.float64(ys[i] - ys[i - 1])))
    return lr


def clip_by_global_norm(grads, max_norm: float) -> list:
    """optax's ``clip_by_global_norm``: the gradients unchanged where
    their global norm (the root of the summed squares) is below
    ``max_norm``, else each ``g / norm * max_norm``. Unlike
    ``torch.nn.utils.clip_grad_norm_``, no epsilon is added to the norm;
    and nothing is read back to the host."""
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class TrainState:
    """``module``'s trainable parameters (``params``, in named order, the
    top-level modules named in ``frozen`` left out), their Adam optimizer,
    the learning-rate schedule and ``step``, the number of updates made;
    ``clip_norm``, where given, the global norm the gradients are clipped
    to before each update."""

    def __init__(self, module: torch.nn.Module, lr_schedule,
                 frozen: Sequence[str] = (), betas=(0.9, 0.98),
                 eps: float = 1e-9, clip_norm: float | None = None):
        if not callable(lr_schedule):
            lr_schedule = interp_schedule(lr_schedule)
        self.module = module
        self.lr_schedule = lr_schedule
        named = [(n, p) for n, p in module.named_parameters()
                 if n.split(".")[0] not in frozen]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = torch.optim.Adam(self.params, lr=lr_schedule(0),
                                          betas=betas, eps=eps)
        self.clip_norm = clip_norm
        self.step = 0

    def apply_gradients(self, grads):
        """One Adam update of ``params`` by ``grads`` (aligned with them,
        clipped first where ``clip_norm`` is set) at the learning rate
        ``schedule(step)``."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        for p, g in zip(self.params, grads, strict=True):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> dict:
        """Parameters and BatchNorm statistics, optimizer state, step."""
        return {"model": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, d: dict):
        self.module.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])
