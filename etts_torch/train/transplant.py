"""Pretrained-weight transplant (port of ``etts/train/transplant.py``).

Builds a donor model from its config dir and checkpoint
(``load_pretrained_params``), grafts either all of its parameters that
fit, or only those of the text encoder, into a fresh model's
(``transplant_params``), and names the text encoder's parameters
(``text_encoder_freeze_mask``), which ``TrainState(frozen=
FROZEN_PRETRAINED)`` leaves out of the optimizer. Parameters are the
port's dotted names (``model.named_parameters()``); BatchNorm statistics
are buffers and are not transplanted, as etts grafts ``params`` without
``batch_stats``. Neither etts' AR driver nor the port's loads a donor: with
``use_pretrained`` both only freeze a freshly initialised text encoder.
"""
from __future__ import annotations

import torch

from .state import FROZEN_PRETRAINED

__all__ = ["transplant_params", "load_pretrained_params",
           "text_encoder_freeze_mask"]


def _text_encoder(name: str) -> bool:
    return name.split(".")[0] in FROZEN_PRETRAINED


def transplant_params(target: dict, donor: dict,
                      only_text_encoder: bool = False):
    """Copy the donor's parameters into the target's wherever the name and
    the shape both match (``target`` and ``donor``: {dotted name: tensor});
    with ``only_text_encoder``, only those of ``FROZEN_PRETRAINED``'s
    modules (the others are kept, and neither copied nor skipped).
    Returns (new {name: tensor}, the count copied, the names skipped: the
    target's names the donor lacks or holds at another shape). A copy
    takes the target's dtype and device."""
    new, copied, skipped = {}, 0, []
    for name, tgt in target.items():
        dnr = donor.get(name)
        if dnr is None:
            skipped.append(name)
            new[name] = tgt
        elif only_text_encoder and not _text_encoder(name):
            new[name] = tgt
        elif dnr.shape == tgt.shape:
            new[name] = dnr.detach().to(tgt.dtype).to(tgt.device)
            copied += 1
        else:
            skipped.append(name)
            new[name] = tgt
    return new, copied, skipped


def load_pretrained_params(config_dir, model_kind: str = "autoregressive",
                           step=None, device="cuda"):
    """The donor's parameters ({dotted name: tensor} on ``device``) and its
    step: the model of ``config_dir``'s session with the weights of its
    checkpoint ``step`` (the latest where None), built by
    ``utils.config.ConfigManager.load_model`` (`etts/train/transplant.py:50`).
    On the card by default; without one it raises."""
    from ..utils.config import ConfigManager
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to load on "
                           "the CPU")
    model, step, _ = ConfigManager(config_dir, model_kind).load_model(
        step, device=device)
    return {n: p.detach() for n, p in model.named_parameters()}, step


def text_encoder_freeze_mask(named_params: dict) -> dict:
    """{name: True where the parameter belongs to the text encoder
    (``FROZEN_PRETRAINED``: ``TextEncoder``, ``TextEmbedding``)}, the
    parameters etts freezes after a transplant."""
    return {name: _text_encoder(name) for name in named_params}
