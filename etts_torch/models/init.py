"""Draw a port module's parameters as flax initialises etts' module
(`etts/utils/config.py:340-351` inits the model the driver trains):

  - Dense and Conv kernels ``lecun_normal``: a normal truncated at 2
    standard deviations, scaled to variance 1 / fan-in (fan-in: the input
    width times the kernel's taps);
  - the GST's GRU input kernel ``lecun_normal``, its recurrent kernel
    orthogonal, its biases zero; the style tokens a normal truncated at 2,
    times 0.5;
  - WaveRNN's GRU input kernels ``rnn{1,2}_wi`` ``lecun_normal`` (fan-in
    the rnn width, and that plus the aux width), the recurrent kernels
    orthogonal, their biases zero (`etts/models/wavernn.py:224-237`); the
    upsampling's smoothing kernels the constant 1 / (2 s + 1) of their
    width (`:172-180`), taking no draw; convs without a bias keep none;
  - Embed normal with variance 1 / width (flax's default);
  - the linear MINE critics (``init_std``): kernels and biases normal 0.05;
  - the duration predictor's output bias ones (``bias_init=ones``,
    `etts/models/layers.py:592`), so that its relu starts live;
  - other biases zero; norm scales 1, running means 0, running variances 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import DurationPredictor, ReferenceEncoderGST
from .wavernn import UpsampleNetwork, WaveRNN

__all__ = ["init_flax"]

_TRUNC_STD = 0.87962566103423978   # std of a standard normal cut at +-2


def _lecun(x, fan_in: int, g):
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
    x.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def init_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module`` in place from ``generator`` (a CPU generator,
    so that every device starts from the same draw); returns it."""
    g = generator
    # the linear critics' std reaches every layer inside them
    std = {id(c): m.init_std for m in module.modules()
           if hasattr(m, "init_std") for c in m.modules()}
    smooth = {id(getattr(m, f"smooth_{i}")) for m in module.modules()
              if isinstance(m, UpsampleNetwork) for i in range(len(m.scales))}
    for sub in module.modules():
        normal_std = std.get(id(sub))
        if id(sub) in smooth:
            sub.weight.fill_(1.0 / sub.weight.shape[-1])
        elif isinstance(sub, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            if normal_std is None:
                _lecun(sub.weight, sub.weight[0].numel(), g)
                if sub.bias is not None:
                    sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, sub.weight.shape[1] ** -0.5, generator=g)
        elif isinstance(sub, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            sub.reset_parameters()
        elif isinstance(sub, ReferenceEncoderGST):
            _lecun(sub.gru_wi, sub.gru_wi.shape[0], g)
            nn.init.orthogonal_(sub.gru_wh, generator=g)
            sub.gru_bi.zero_()
            sub.gru_bh.zero_()
            nn.init.trunc_normal_(sub.gst_tokens, 0.0, 1.0, -2.0, 2.0,
                                  generator=g)
            sub.gst_tokens.mul_(0.5)
        elif isinstance(sub, WaveRNN):
            for name in ("rnn1", "rnn2"):
                wi = getattr(sub, f"{name}_wi")
                _lecun(wi, wi.shape[0], g)
                nn.init.orthogonal_(getattr(sub, f"{name}_wh"), generator=g)
                getattr(sub, f"{name}_bi").zero_()
                getattr(sub, f"{name}_bh").zero_()
        if normal_std is not None:
            for p in sub.parameters(recurse=False):
                p.normal_(0.0, normal_std, generator=g)
    # after the loop, which zeroes every plain bias; no draw is taken
    for sub in module.modules():
        if isinstance(sub, DurationPredictor):
            sub.linear.bias.fill_(1.0)
    return module
