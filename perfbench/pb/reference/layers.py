"""Plain PyTorch layers of the TransformerTTS family, written from the
published description (`TransformerTTS/model/layers.py` of the reference
monorepo) on a parameter tree in the flax layout: a Dense kernel is
(in, out), a Conv kernel (k, in, out) or (kh, kw, in, out). No module of
the program is imported; every function takes the tree and its inputs and
computes in the dtype of its inputs (float64 for the reference, float32
for the lower-precision control).

Departures kept from the reference implementation, as the published code
has them: the attention's output projection reads concat([query input,
attention]); the FFN's two Dense layers have no activation between them;
the decoder's cross mask is worked out from the dense encoder output, so
it masks nothing."""
from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
KEY = re.compile(r"\['([^']+)'\]")


def tree(flat: dict, dtype, device) -> dict:
    """{keystr: array} -> nested dict of tensors in ``dtype``; BatchNorm
    statistics (``batch_stats:`` keys) sit beside their scale and bias."""
    root: dict = {}
    for key, a in flat.items():
        parts = KEY.findall(key.removeprefix("batch_stats:"))
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return root


def dense(p, x):
    return x @ p["kernel"] + p["bias"]


def layer_norm(p, x):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], LN_EPS)


def batch_norm(p, x, eps: float, train: bool = False):
    """x (b, c, ...): the running statistics, or the batch's (biased
    variance) under ``train``."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = (x - mean.view(shape)).square().mean(dims)
    else:
        mean, var = p["mean"], p["var"]
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + eps)
    return y * p["scale"].view(shape) + p["bias"].view(shape)


def conv1d(p, x, pad):
    """x (b, c, t), kernel (k, in, out), ``pad`` (before, after)."""
    w = p["kernel"].permute(2, 1, 0)
    y = F.conv1d(F.pad(x, pad), w)
    return y + p["bias"][:, None] if "bias" in p else y


def positional_encoding(max_position: int, d: int) -> np.ndarray:
    pos = np.arange(max_position, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / float(d))
    angle[:, 0::2] = np.sin(angle[:, 0::2])
    angle[:, 1::2] = np.cos(angle[:, 1::2])
    return angle.astype(np.float32)


def attention(q, k, v, mask=None):
    logits = q @ k.transpose(-1, -2) / math.sqrt(k.shape[-1])
    if mask is not None:
        logits = logits + mask * -1e9
    w = torch.softmax(logits, -1)
    return w @ v, w


def mha(p, v_in, k_in, q_in, heads: int, mask=None):
    def split(x):
        b, t, _ = x.shape
        return x.view(b, t, heads, -1).transpose(1, 2)
    out, w = attention(split(dense(p["wq"], q_in)),
                       split(dense(p["wk"], k_in)),
                       split(dense(p["wv"], v_in)), mask)
    b, h, t, _ = out.shape
    concat = out.transpose(1, 2).reshape(b, t, -1)
    return dense(p["dense"], torch.cat([q_in, concat], -1)), w


class Dropout:
    """The training dropout: keep where u < 1 - rate, u drawn in float32
    from ``generator`` at x's shape, one draw a call in the order of the
    forward pass; kept values divided by 1 - rate."""

    def __init__(self, rate: float, generator=None):
        self.rate, self.gen = rate, generator

    def __call__(self, x):
        if self.gen is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


NO_DROPOUT = Dropout(0.0)


def ffn(p, x, drop):
    y = torch.relu(layer_norm(p["ln"], dense(p["d2"], dense(p["d1"], x))))
    return layer_norm(p["last_ln"], x + drop(y))


def self_attention(p, x, mask, heads, drop):
    attn, w = mha(p["mha"], x, x, x, heads, mask)
    return layer_norm(p["last_ln"], drop(layer_norm(p["ln"], attn)) + x), w


def encoder_stack(p, x, mask, heads, drop, r: int = 1):
    """Self-attention dense blocks SADB_i on x * sqrt(d) + pe[::r]."""
    d = x.shape[-1]
    pe = torch.as_tensor(positional_encoding(x.shape[1] * r, d)[::r],
                         dtype=x.dtype, device=x.device)
    x = drop(x * math.sqrt(d) + pe)
    for i, h in enumerate(heads):
        b = p[f"SADB_{i}"]
        x, _ = self_attention(b["sarn"], x, mask, h, drop)
        x = ffn(b["ffn"], x, drop)
    return x


def cnn_resnorm(p, x, n_layers: int, kernel: int, inner, last,
                causal: bool, norm: str = "batch", eps: float = 1e-3,
                train: bool = False):
    """x (b, t, c): n_layers - 1 convs with norm and ``inner``, a last conv
    with norm and ``last``, then norm(x + stack)."""
    pad = (kernel - 1, 0) if causal else ((kernel - 1) // 2, kernel // 2)

    def normed(q, y):
        if norm == "layer":
            return layer_norm(q, y.transpose(1, 2)).transpose(1, 2)
        return batch_norm(q, y, eps, train)
    y = x.transpose(1, 2)
    for i in range(n_layers - 1):
        y = inner(normed(p[f"norm_{i}"], conv1d(p[f"conv_{i}"], y, pad)))
    y = last(normed(p["norm_last"], conv1d(p["last_conv"], y, pad)))
    return normed(p["norm_out"], x.transpose(1, 2) + y).transpose(1, 2)


def gru(wi, wh, bi, bh, xs, h=None):
    """GRU with separate input and hidden biases, gates [r, z, n],
    n = tanh(gi_n + r * gh_n): xs (b, t, in) -> (outputs, last h)."""
    hd = wh.shape[0]
    h = xs.new_zeros(xs.shape[0], hd) if h is None else h
    gi = xs @ wi + bi
    ys = []
    for t in range(xs.shape[1]):
        gh = h @ wh + bh
        r = torch.sigmoid(gi[:, t, :hd] + gh[:, :hd])
        z = torch.sigmoid(gi[:, t, hd:2 * hd] + gh[:, hd:2 * hd])
        n = torch.tanh(gi[:, t, 2 * hd:] + r * gh[:, 2 * hd:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, 1), h
