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
  - GST-Tacotron (`etts/models/tacotron.py`): flax's ``GRUCell`` and
    ``LSTMCell`` (input kernels ``lecun_normal``, each recurrent gate's
    kernel orthogonal, biases zero); the CBHGs' and the reference
    encoder's GRUs as the GST's; the highways' ``T`` bias -1 (`:78-80`);
    the text embedding and the style tokens a normal truncated at 2,
    times 0.5 (`:298-301`, `:313-316`); both ``attention_v`` vectors
    ``lecun_normal`` of shape (1, d), whose fan-in is 1 (`:191-192`,
    `:236-237`); ``attention_g`` sqrt(1 / d) (`:194-196`);
  - other biases zero; norm scales 1, running means 0, running variances 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from . import tacotron as taco
from .layers import DurationPredictor, ReferenceEncoderGST
from .wavernn import UpsampleNetwork, WaveRNN

__all__ = ["init_flax"]

_TRUNC_STD = 0.87962566103423978   # std of a standard normal cut at +-2


def _lecun(x, fan_in: int, g):
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
    x.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _half_trunc(x, g):
    """flax's ``truncated_normal(stddev=0.5)``: cut at +-2, times 0.5."""
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
    x.mul_(0.5)


def _gru(wi, wh, bi, bh, g):
    """A GRU's stacked (in, 3h) / (h, 3h) kernels, flax's way."""
    _lecun(wi, wi.shape[0], g)
    nn.init.orthogonal_(wh, generator=g)
    bi.zero_()
    bh.zero_()


def _tacotron(sub: nn.Module, g):
    """The Tacotron's own initialisers on ``sub``, after the generic ones
    (which drew a kernel for every Linear and zeroed its bias)."""
    if isinstance(sub, taco.Highway):
        sub.T.bias.fill_(-1.0)
    elif isinstance(sub, (taco.GRUCell, taco.LSTMCell)):
        gates = (("hr", "hz", "hn") if isinstance(sub, taco.GRUCell)
                 else ("hi", "hf", "hg", "ho"))
        for gate in gates:
            nn.init.orthogonal_(getattr(sub, gate).weight, generator=g)
    elif isinstance(sub, taco.CBHG):
        for d in ("fw", "bw"):
            _gru(*(getattr(sub, f"gru_{d}_{n}")
                   for n in ("wi", "wh", "bi", "bh")), g)
    elif isinstance(sub, taco.TacoReferenceEncoder):
        _gru(sub.gru_wi, sub.gru_wh, sub.gru_bi, sub.gru_bh, g)
    elif isinstance(sub, taco.StyleAttention) and sub.mlp:
        _lecun(sub.attention_v, 1, g)
        if sub.normalize:
            sub.attention_g.fill_(math.sqrt(1.0 / sub.d))
            sub.attention_b.zero_()
    elif isinstance(sub, taco.TacotronDecoderCell):
        _lecun(sub.attention_v, 1, g)
    elif isinstance(sub, taco.Tacotron):
        _half_trunc(sub.text_embedding.weight, g)
        if sub.use_gst:
            _half_trunc(sub.style_tokens, g)


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
            _half_trunc(sub.gst_tokens, g)
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
    # after the loop, which zeroes every plain bias
    for sub in module.modules():
        if isinstance(sub, DurationPredictor):
            sub.linear.bias.fill_(1.0)
        _tacotron(sub, g)
    return module
