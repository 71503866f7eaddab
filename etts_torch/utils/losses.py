"""Masked losses (port of ``etts/utils/losses.py``).

The reduction is Keras' ``sample_weight`` one: a masked loss divides by
the number of ALL positions, padding included, not by the mask's sum
(`etts/utils/losses.py:24-26`), so the padding of a batch changes its loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["new_scaled_crossentropy", "masked_crossentropy",
           "masked_mean_squared_error", "masked_mean_absolute_error",
           "l1_loss", "l2_loss", "weighted_sum_losses"]


def _weighted_mean(per_pos, weights):
    """sum(loss * w) / total positions."""
    return (per_pos * weights).sum() / per_pos.numel()


def _sparse_ce(targets, logits):
    """Per-position sparse categorical cross-entropy from logits."""
    logz = F.log_softmax(logits.float(), -1)
    return -logz.gather(-1, targets.long()[..., None])[..., 0]


def new_scaled_crossentropy(index: int = 2, scaling: float = 1.0):
    """Masked cross-entropy with class ``index`` weighted by ``scaling``
    (the stop class, x8 in training)."""
    def loss_fn(targets, logits):
        weights = (targets != 0).float() + (targets == index).float() * (
            scaling - 1.0)
        return _weighted_mean(_sparse_ce(targets, logits), weights)
    return loss_fn


def masked_crossentropy(targets, logits):
    return _weighted_mean(_sparse_ce(targets, logits),
                          (targets != 0).float())


def _channel_mask(targets):
    """(b, t, c) -> (b, t): a position is real iff any channel is non-zero."""
    return (targets != 0).float().amax(-1)


def masked_mean_squared_error(targets, logits):
    per_pos = (targets.float() - logits.float()).square().mean(-1)
    return _weighted_mean(per_pos, _channel_mask(targets))


def masked_mean_absolute_error(targets, logits):
    per_pos = (targets.float() - logits.float()).abs().mean(-1)
    return _weighted_mean(per_pos, _channel_mask(targets))


def l1_loss(targets, logits):
    return (targets - logits).abs().mean()


def l2_loss(targets, logits):
    return (targets - logits).square().mean()


def weighted_sum_losses(targets, pred, loss_functions, coeffs):
    """(total, [losses]) over parallel target / prediction / loss triples."""
    vals = [f(t, p) for f, t, p in zip(loss_functions, targets, pred)]
    return sum(c * v for c, v in zip(coeffs, vals)), vals
