"""Transformer-TTS building blocks (port of ``etts/models/layers.py``).

Module and parameter names follow the flax tree (``sarn``, ``carn``, ``mha``,
``wq`` ...) so ``etts_torch.convert`` maps exported keys mechanically.
Behaviour kept from the reference (SURVEY §2.7):
  - the MHA output projection takes concat([query_input, attention])
  - DecoderPrenet dropout is always on, at a runtime rate
  - positional encodings are r-strided under the reduction factor
  - a stack runs its dense blocks first, then its conv blocks

Train mode is an explicit ``train`` argument, as in etts, never
``Module.train()``: etts sets it per sub-stack. Under ``train`` a layer
applies its dropout (``dropout_rate``), HeadDrop (``drop_n_heads`` heads
per row) and BatchNorm on the batch's statistics, moving the running ones
as flax does; the draws come from the ``generator`` passed down.

Every module here has a compute ``dtype``, as etts' modules have, set for a
whole model by ``set_compute_dtype``. float32 is the plain path: no casts,
the parameters' own dtype throughout. bfloat16 is etts' mixed precision:
the parameters stay float32 and are cast where flax casts them
(``Dense``, ``Conv1d``, ``Conv2d``, ``Embedding``: inputs, kernel and bias
in bf16, the bias added to the rounded product), the norms compute in
float32 and return bf16, the attention's logits and softmax are float32,
and the reference encoder's GRU sums its gates in float32. No
``torch.autocast``: its per-op policy is not flax's.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..ops.masking import positional_encoding
from ..parallel import collectives

LN_EPS = 1e-6
BN_EPS = 1e-3          # flax BatchNorm(epsilon=1e-3) in CNNResNorm / GST
BN_MOMENTUM = 0.99     # flax: running = 0.99 * running + 0.01 * batch

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
                "linear": lambda x: x}

class Compute:
    """A module with a compute ``dtype`` (float32: the plain path)."""
    dtype = torch.float32

    @property
    def low_precision(self) -> bool:
        return self.dtype != torch.float32


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Give ``module`` and every ``Compute`` module in it the compute
    ``dtype``; the parameters keep theirs."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    for m in module.modules():
        if isinstance(m, Compute):
            m.dtype = dtype
    return module


def _product(fn, x, w, *args):
    """``fn(x, w, *args)`` of bf16 operands as flax computes it: the exact
    products summed in float32 and rounded once to bf16, forward and
    backward. On the CPU the operands go through float32 explicitly:
    oneDNN's own bf16 kernels sum in an order and at a precision that
    depend on the host's instruction set (AMX, AVX512-BF16 or AVX2) and
    its thread count. A card's bf16 kernels sum in float32 already."""
    if x.device.type != "cpu":
        return fn(x, w, *args)
    return fn(x.float(), w.float(), *args).to(x.dtype)


class Dense(Compute, nn.Linear):
    """flax ``Dense``: at bf16 the input, kernel and bias are cast, the
    product rounds once, and the bias is added to it in bf16 (one more
    rounding, where ``F.linear`` would fuse it). Under tensor parallelism
    ``tp`` (a ``parallel.tp.Shard``) holds its place and runs the
    collectives around the product."""
    tp = None

    def forward(self, x):
        if self.tp is not None:
            return self.tp.dense(self, x, self._affine)
        return self._affine(x, self.weight, self.bias)

    def _affine(self, x, weight, bias):
        if not self.low_precision:
            return F.linear(x, weight, bias)
        d = self.dtype
        y = _product(F.linear, x.to(d), weight.to(d))
        return y if bias is None else y + bias.to(d)


class Conv1d(Compute, nn.Conv1d):
    """flax ``Conv`` on (b, c, t), cast as ``Dense``."""

    def forward(self, x):
        if not self.low_precision:
            return super().forward(x)
        d = self.dtype
        return (_product(self._conv_forward, x.to(d), self.weight.to(d),
                         None) + self.bias.to(d)[:, None])


class Conv2d(Compute, nn.Conv2d):
    """flax ``Conv`` on (b, c, h, w), cast as ``Dense``."""

    def forward(self, x):
        if not self.low_precision:
            return super().forward(x)
        d = self.dtype
        return (_product(self._conv_forward, x.to(d), self.weight.to(d),
                         None) + self.bias.to(d)[:, None, None])


class Embedding(Compute, nn.Embedding):
    """flax ``Embed``: the table's rows in the compute dtype; a
    vocabulary-sharded table (``tp``) sums its ranks' rows."""
    tp = None

    def forward(self, ids):
        x = (super().forward(ids) if self.tp is None
             else self.tp.embed(self.weight, ids))
        return x.to(self.dtype) if self.low_precision else x


class LayerNorm(Compute, nn.LayerNorm):
    """flax ``LayerNorm``: statistics and normalisation in float32 (at
    least), the result in the compute dtype."""

    def forward(self, x):
        if not self.low_precision:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


class BatchNorm1d(Compute, nn.BatchNorm1d):
    """A BatchNorm whose compute dtype ``batch_norm`` reads."""


class BatchNorm2d(Compute, nn.BatchNorm2d):
    """A BatchNorm whose compute dtype ``batch_norm`` reads."""


def variable_rate_dropout(x, rate: float, generator=None):
    """Inverted dropout that is always applied: keep where u < 1 - rate, u
    drawn from ``generator`` on its own device (a CPU generator gives a
    card's x the CPU's draws); rate 0 is the identity and draws nothing.
    In a data-parallel step x holds the rank's rows, and u is their part of
    the global batch's draw (``parallel.collectives.rand``)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate   # x / keep rounds once, in x's dtype
    u = collectives.rand(x.shape, generator, x.device if generator is None
                         else generator.device).to(x.device)
    return torch.where(u < keep, x / max(keep, 1e-8), torch.zeros_like(x))


def dropout(x, rate: float, train: bool, generator=None):
    """flax ``nn.Dropout``: the identity unless ``train`` (and rate > 0),
    else ``variable_rate_dropout``."""
    if not train:
        return x
    return variable_rate_dropout(x, rate, generator)


def head_drop(x, drop_n: int, scores, first: int = 0):
    """Zero exactly ``drop_n`` heads per batch row and rescale the rest by
    h / (h - drop_n) (`layers.py:122-133`): x (b, h, t, depth); ``scores``
    (b, h), uniform draws, drop the heads of the ``drop_n`` lowest. Under
    tensor parallelism x holds heads ``first`` onward of the h that
    ``scores`` rank."""
    h = scores.shape[1]
    if h == 1:
        return x
    ranks = scores.argsort(-1).argsort(-1)[:, first:first + x.shape[1]]
    keep = (ranks >= drop_n).to(x.dtype)[:, :, None, None]
    scale = h / max(h - drop_n, 1)
    if x.dtype == torch.bfloat16:   # etts rounds the scale to x's dtype
        scale = torch.tensor(scale, dtype=x.dtype)
    return x * keep * scale


def batch_norm(bn, x, train: bool, momentum: float = BN_MOMENTUM):
    """flax ``BatchNorm`` on x (b, c, ...) with ``bn``'s parameters and
    running statistics: those statistics unless ``train``; else the batch's
    (biased variance), and the running ones move by ``momentum`` (flax's:
    running = momentum * running + (1 - momentum) * batch) under no_grad,
    as flax's mutable ``batch_stats``. A ``bn`` of compute dtype bf16
    normalises (and takes the batch's statistics) in float32 and returns
    bf16, as flax's ``_normalize`` does. In a data-parallel step the
    batch is the global one: the rank's moments are averaged over the
    ranks, the gradient through them (``_global_batch_norm``)."""
    dtype = getattr(bn, "dtype", torch.float32)
    if dtype != torch.float32:
        return _batch_norm(bn, x.float(), train, momentum).to(dtype)
    return _batch_norm(bn, x, train, momentum)


def _batch_norm(bn, x, train: bool, momentum: float):
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if collectives.sharded():
        return _global_batch_norm(bn, x, momentum)
    with torch.no_grad():
        dims = [0, *range(2, x.dim())]
        for stat, batch in ((bn.running_mean, x.mean(dims)),
                            (bn.running_var, x.var(dims, unbiased=False))):
            stat.mul_(momentum).add_(batch, alpha=1 - momentum)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _global_batch_norm(bn, x, momentum: float):
    """``_batch_norm`` in train mode on the global batch of a
    data-parallel step, x this rank's rows: the mean, then the biased
    variance about it, each averaged over the ranks (equal-size parts) with
    the gradient through the average; the running statistics move by
    them."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = collectives.mean_over_ranks(x.mean(dims))
    centred = x - mean.view(shape)
    var = collectives.mean_over_ranks(centred.square().mean(dims))
    with torch.no_grad():
        for stat, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            stat.mul_(momentum).add_(batch, alpha=1 - momentum)
    y = centred * torch.rsqrt(var + bn.eps).view(shape)
    if bn.weight is not None:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y


def whole_time(x):
    """In a ``collectives.time_region`` (the decoder of a
    sequence-parallel step, x (b, t, d) this rank's frames), the whole
    sequence gathered from the seq axis, its gradient reaching every
    rank's frames; x itself elsewhere."""
    region = collectives.in_time_region()
    if region is None:
        return x
    return collectives.seq_shard().gather(x, region[2])


class _RenormSoftmax(torch.autograd.Function):
    """The softmax over the last axis, its rows divided once more by their
    sums taken in float64; the backward is the softmax's own, on those
    rows.

    In the decoder's self-attention at 1280 frames the gradient of ``wk``
    nearly cancels, and what is left of it depends on how exactly each
    row of weights sums to one: against the float64 step, the float32
    gradient lost 5.3e-4 through CUDA's ``torch.softmax`` and 1.9e-5
    through the CPU's; renormalised, 1.2e-5 on the card and 1.4e-5 on the
    CPU (H100, ``chip_smoke.py`` phase 11)."""

    @staticmethod
    def forward(ctx, logits):
        w = torch.softmax(logits, -1)
        w.div_(w.sum(-1, keepdim=True, dtype=torch.float64).to(w.dtype))
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, grad):
        w, = ctx.saved_tensors
        return torch._softmax_backward_data(grad, w, -1, grad.dtype)


def attention(q, k, v, mask=None):
    """q (..., tq, d), k/v (..., tk, d); mask broadcastable, 1 = masked.
    A bf16 q takes etts' mixed path (`etts/ops/attention.py`): float32
    logits of the bf16 operands, float32 softmax (the weights returned),
    the weights cast to bf16 for the value product, which sums in float32
    and rounds once to bf16."""
    if q.dtype == torch.bfloat16:
        logits = q.float() @ k.float().transpose(-1, -2) / (k.shape[-1]
                                                            ** 0.5)
        if mask is not None:
            logits = logits + mask * -1e9
        w = _RenormSoftmax.apply(logits)
        return (w.to(q.dtype).float() @ v.float()).to(q.dtype), w
    logits = q @ k.transpose(-1, -2) / (k.shape[-1] ** 0.5)
    if mask is not None:
        logits = logits + mask * -1e9
    w = _RenormSoftmax.apply(logits)
    return w @ v, w


def scaled_positions(x, pe, model_dim: int):
    """x * sqrt(model_dim) + pe; a bf16 x takes sqrt(model_dim) and the
    table rounded to bf16, each step rounding, as etts
    (`layers.py:288-289, :441-442`)."""
    if x.dtype == torch.bfloat16:
        return (x * torch.tensor(model_dim ** 0.5, dtype=x.dtype)
                + pe.to(x.dtype))
    return x * (model_dim ** 0.5) + pe


class MultiHeadAttention(nn.Module):
    """MHA with the reference's concat-query output projection
    (`layers.py:136-188`)."""

    def __init__(self, model_dim: int, num_heads: int, q_dim: int,
                 kv_dim: int):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.model_dim, self.num_heads = model_dim, num_heads
        self.wq = Dense(q_dim, model_dim)
        self.wk = Dense(kv_dim, model_dim)
        self.wv = Dense(kv_dim, model_dim)
        self.dense = Dense(q_dim + model_dim, model_dim)

    @property
    def local_heads(self) -> int:
        """The heads this rank computes: all, or its share under tensor
        parallelism (``wq`` column-sharded)."""
        tp = self.wq.tp
        return self.num_heads if tp is None else self.num_heads // tp.size

    def split(self, x):
        b, t, _ = x.shape
        return x.view(b, t, self.local_heads, -1).transpose(1, 2)

    def forward(self, v, k, q_in, mask=None, kv=None, cache=None,
                cache_index=None, train=False, drop_n_heads=0,
                generator=None):
        """``kv``: precomputed head-split (k, v). ``cache``: {'k','v'}
        (b, h, T, depth) self-attention cache, written in place at
        ``cache_index`` (q covers one step); attention reads rows <= index.
        Under ``train`` the attention output drops ``drop_n_heads`` heads
        per row (``head_drop``)."""
        q = self.split(self.wq(q_in))
        if kv is not None:
            k, v = kv
        else:
            k, v = self.split(self.wk(k)), self.split(self.wv(v))
        if cache is not None:
            cache["k"][:, :, cache_index] = k[:, :, 0]
            cache["v"][:, :, cache_index] = v[:, :, 0]
            k = cache["k"][:, :, :cache_index + 1]
            v = cache["v"][:, :, :cache_index + 1]
        out, w = attention(q, k, v, mask)
        b, h, tq, _ = out.shape
        tp = self.wq.tp
        if train and drop_n_heads:
            out = head_drop(out, drop_n_heads, collectives.rand(
                (b, self.num_heads), generator, out.device),
                0 if tp is None else tp.rank * h)
        concat = out.transpose(1, 2).reshape(b, tq, -1)
        if tp is not None:
            concat = tp.gather(concat)
        return self.dense(torch.cat([q_in, concat], -1)), w


class FFNResNorm(nn.Module):
    """Dense-Dense + LN + relu + dropout + LN(x + y) (`layers.py:99-115`)."""

    def __init__(self, model_dim: int, hidden: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.d1 = Dense(model_dim, hidden)
        self.d2 = Dense(hidden, model_dim)
        self.ln = LayerNorm(model_dim, eps=LN_EPS)
        self.last_ln = LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, x, train=False, generator=None):
        y = torch.relu(self.ln(self.d2(self.d1(x))))
        y = dropout(y, self.dropout_rate, train, generator)
        return self.last_ln(x + y)


class SelfAttentionResNorm(nn.Module):
    """MHA + LN + dropout + LN(x + out) (`layers.py:190-207`)."""

    def __init__(self, model_dim: int, num_heads: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mha = MultiHeadAttention(model_dim, num_heads, model_dim,
                                      model_dim)
        self.ln = LayerNorm(model_dim, eps=LN_EPS)
        self.last_ln = LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, x, mask, cache=None, cache_index=None, train=False,
                drop_n_heads=0, generator=None):
        """-> (output, attention weights (b, h, tq, tk)). In a time region
        the queries are this rank's frames, the keys and values the whole
        sequence's."""
        kv = whole_time(x)
        attn, w = self.mha(kv, kv, x, mask, cache=cache,
                           cache_index=cache_index,
                           train=train, drop_n_heads=drop_n_heads,
                           generator=generator)
        out = dropout(self.ln(attn), self.dropout_rate, train, generator)
        return self.last_ln(out + x), w


class CrossAttentionResnorm(nn.Module):
    """Cross-MHA + dropout + LN(attn + q) (`layers.py:307-323`)."""

    def __init__(self, model_dim: int, num_heads: int, enc_dim: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mha = MultiHeadAttention(model_dim, num_heads, model_dim, enc_dim)
        self.layernorm = LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, q, enc, mask, kv=None, train=False, drop_n_heads=0,
                generator=None):
        attn, w = self.mha(enc, enc, q, mask, kv=kv, train=train,
                           drop_n_heads=drop_n_heads, generator=generator)
        attn = dropout(attn, self.dropout_rate, train, generator)
        return self.layernorm(attn + q), w


class SelfAttentionDenseBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, hidden: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.ffn = FFNResNorm(model_dim, hidden, dropout_rate)

    def forward(self, x, mask, train=False, drop_n_heads=0, generator=None):
        x, w = self.sarn(x, mask, train=train, drop_n_heads=drop_n_heads,
                         generator=generator)
        return self.ffn(x, train, generator), w


class CrossAttentionDenseBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, hidden: int,
                 enc_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.carn = CrossAttentionResnorm(model_dim, num_heads, enc_dim,
                                          dropout_rate)
        self.ffn = FFNResNorm(model_dim, hidden, dropout_rate)

    def forward(self, x, enc, self_mask, cross_mask, cache=None,
                cache_index=None, train=False, drop_n_heads=0,
                generator=None):
        mode = dict(train=train, drop_n_heads=drop_n_heads,
                    generator=generator)
        x, _ = self.sarn(x, self_mask, cache, cache_index, **mode)
        kv = None if cache is None else (cache["ck"], cache["cv"])
        x, w = self.carn(x, enc, cross_mask, kv, **mode)
        return self.ffn(x, train, generator), w


class SelfAttentionConvBlock(nn.Module):
    """Self-attention, then a 2-layer ``same``-padded relu CNNResNorm with
    BatchNorm (`layers.py:228-250`; etts builds it with relu only)."""

    def __init__(self, model_dim: int, num_heads: int, conv_filters: int,
                 kernel_size: int, dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.conv = CNNResNorm(model_dim, model_dim, 2, conv_filters,
                               kernel_size, "relu", "relu", padding="same")

    def forward(self, x, mask, train=False, drop_n_heads=0, generator=None):
        x, w = self.sarn(x, mask, train=train, drop_n_heads=drop_n_heads,
                         generator=generator)
        return self.conv(x, train), w


class CrossAttentionConvBlock(nn.Module):
    """Self- and cross-attention, then a 2-layer causal relu CNNResNorm with
    BatchNorm (`layers.py:358-400`). In the incremental decode the cache's
    ``conv`` entry holds the 2 * (kernel - 1) block inputs before the new
    step (zeros before the start); the step convolves [window | new], keeps
    the last rows, and moves the window on."""

    def __init__(self, model_dim: int, num_heads: int, conv_filters: int,
                 kernel_size: int, enc_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.carn = CrossAttentionResnorm(model_dim, num_heads, enc_dim,
                                          dropout_rate)
        self.conv = CNNResNorm(model_dim, model_dim, 2, conv_filters,
                               kernel_size, "relu", "relu", padding="causal")

    def forward(self, x, enc, self_mask, cross_mask, cache=None,
                cache_index=None, train=False, drop_n_heads=0,
                generator=None):
        mode = dict(train=train, drop_n_heads=drop_n_heads,
                    generator=generator)
        x, _ = self.sarn(x, self_mask, cache, cache_index, **mode)
        kv = None if cache is None else (cache["ck"], cache["cv"])
        x, w = self.carn(x, enc, cross_mask, kv, **mode)
        if cache is None:
            return self.conv(x, train), w
        window = torch.cat([cache["conv"], x], 1)
        cache["conv"] = window[:, x.shape[1]:]
        return self.conv(window)[:, -x.shape[1]:], w


class SelfAttentionBlocks(nn.Module):
    """Encoder stack with sqrt(d)-scaled, positionally encoded input
    (`layers.py:253-304`): ``dense_blocks`` dense blocks ``SADB_i``, then
    conv blocks ``SACB_j``. Returns (x, {f"{name_prefix}_DenseBlock{i}_
    SelfAttention" or f"{name_prefix}_ConvBlock{j}_SelfAttention": each
    block's attention weights (b, h, t, t)}), numbered from 1, etts' keys.
    ``reduction_factor`` strides the positional encoding."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int, conv_filters: int,
                 kernel_size: int, name_prefix: str = "TextEncoder",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.model_dim = model_dim
        self.dropout_rate = dropout_rate
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        self.attention_keys = {}            # block name -> etts' key
        for i, h in enumerate(num_heads):
            if i < dense_blocks:
                name, kind, j = f"SADB_{i}", "DenseBlock", i
                block = SelfAttentionDenseBlock(model_dim, h, hidden,
                                                dropout_rate)
            else:
                j = i - dense_blocks
                name, kind = f"SACB_{j}", "ConvBlock"
                block = SelfAttentionConvBlock(model_dim, h, conv_filters,
                                               kernel_size, dropout_rate)
            self.add_module(name, block)
            self.attention_keys[name] = (
                f"{name_prefix}_{kind}{j + 1}_SelfAttention")

    def forward(self, x, padding_mask, train=False, drop_n_heads=0,
                generator=None, reduction_factor: int = 1):
        r = reduction_factor
        x = scaled_positions(x, self.pos_encoding[:x.shape[1] * r:r],
                             self.model_dim)
        x = dropout(x, self.dropout_rate, train, generator)
        weights = {}
        for name, key in self.attention_keys.items():
            x, weights[key] = getattr(self, name)(
                x, padding_mask, train, drop_n_heads, generator)
        return x, weights


class CrossAttentionBlocks(nn.Module):
    """Decoder stack: self- and cross-attention per block
    (`layers.py:403-464`), ``dense_blocks`` dense blocks ``CADB_i``, then
    causal conv blocks ``CACB_j``."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int, enc_dim: int,
                 conv_filters: int, conv_kernel: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.model_dim = model_dim
        self.dropout_rate = dropout_rate
        self.num_heads = tuple(num_heads)
        self.dense_blocks = dense_blocks
        self.conv_kernel = conv_kernel
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        for i, h in enumerate(num_heads):
            if i < dense_blocks:
                self.add_module(f"CADB_{i}", CrossAttentionDenseBlock(
                    model_dim, h, hidden, enc_dim, dropout_rate))
            else:
                self.add_module(f"CACB_{i - dense_blocks}",
                                CrossAttentionConvBlock(
                                    model_dim, h, conv_filters, conv_kernel,
                                    enc_dim, dropout_rate))

    def blocks(self):
        n = self.dense_blocks
        return [getattr(self, f"CADB_{i}" if i < n else f"CACB_{i - n}")
                for i in range(len(self.num_heads))]

    def forward(self, x, enc, self_mask, cross_mask, r: int = 1, train=False,
                drop_n_heads=0, generator=None):
        """Teacher-forced stack over x (b, T, d) (`layers.py:436-468`): the
        positional encoding ``pe[::r][:T]``, dropout, each block under
        ``self_mask`` (look-ahead and padding combined); in a time region x
        holds frames [start, stop) and reads ``pe[::r][start:stop]``, and
        ``self_mask`` those frames' rows. Returns (x,
        {"Decoder_DenseBlock{i}_CrossAttention" or
        "Decoder_ConvBlock{j}_CrossAttention": each block's cross-attention
        (b, h, T, n_enc)}), numbered from 1, etts' keys."""
        region = collectives.in_time_region()
        o = 0 if region is None else region[0]
        pe = self.pos_encoding[o * r:(o + x.shape[1]) * r:r]
        x = scaled_positions(x, pe, self.model_dim)
        x = dropout(x, self.dropout_rate, train, generator)
        weights = {}
        for i, block in enumerate(self.blocks()):
            kind, j = (("DenseBlock", i) if i < self.dense_blocks
                       else ("ConvBlock", i - self.dense_blocks))
            x, weights[f"Decoder_{kind}{j + 1}_CrossAttention"] = block(
                x, enc, self_mask, cross_mask, train=train,
                drop_n_heads=drop_n_heads, generator=generator)
        return x, weights

    def step(self, x, enc, cross_mask, caches, index: int, r: int):
        """One incremental step (x: (b, 1, d)) at position ``index * r``.
        Returns (x, last block's cross-attention (b, h, 1, n_enc))."""
        x = scaled_positions(x, self.pos_encoding[index * r], self.model_dim)
        w = None
        for block, cache in zip(self.blocks(), caches):
            x, w = block(x, enc, None, cross_mask, cache, index)
        return x, w


class DecoderPrenet(nn.Module):
    """Two relu Dense layers with always-on dropout at a runtime rate
    (`layers.py:471-488`)."""

    def __init__(self, mel_channels: int, hidden: int, model_dim: int):
        super().__init__()
        self.d1 = Dense(mel_channels, hidden)
        self.d2 = Dense(hidden, model_dim)

    def forward(self, x, rate: float, generator=None):
        x = variable_rate_dropout(torch.relu(self.d1(x)), rate, generator)
        return variable_rate_dropout(torch.relu(self.d2(x)), rate, generator)


class CNNResNorm(nn.Module):
    """Conv1D stack with a norm after each conv and a residual
    (`layers.py:58-96`): n_layers - 1 convs to ``hidden_size``, each
    normed and passed through ``inner_activation``, a last conv to
    ``out_size``, normed and passed through ``last_activation``, then
    norm(inputs + stack). ``padding`` "causal" pads k - 1 steps before,
    "same" (flax ``SAME``) (k - 1) // 2 before and k // 2 after;
    ``normalization`` "batch" is BatchNorm (eps 1e-3), "layer" LayerNorm
    (eps 1e-6). Layout (b, t, c) at the interface."""

    def __init__(self, in_size: int, out_size: int, n_layers: int,
                 hidden_size: int, kernel_size: int,
                 inner_activation: str = "relu",
                 last_activation: str = "linear", padding: str = "same",
                 normalization: str = "batch"):
        super().__init__()
        if normalization not in ("batch", "layer"):
            raise ValueError("normalization must be layer|batch, got "
                             f"{normalization}")
        self.n_layers = n_layers
        self.kernel_size = k = kernel_size
        self.pad = ((k - 1, 0) if padding.lower() == "causal"
                    else ((k - 1) // 2, k // 2))
        self.inner = _ACTIVATIONS[inner_activation]
        self.last = _ACTIVATIONS[last_activation]
        self.layer_norm = normalization == "layer"

        def norm(c):
            return (LayerNorm(c, eps=LN_EPS) if self.layer_norm
                    else BatchNorm1d(c, eps=BN_EPS))
        c = in_size
        for i in range(n_layers - 1):
            self.add_module(f"conv_{i}", Conv1d(c, hidden_size, k))
            self.add_module(f"norm_{i}", norm(hidden_size))
            c = hidden_size
        self.last_conv = Conv1d(c, out_size, k)
        self.norm_last = norm(out_size)
        self.norm_out = norm(out_size)

    def _norm(self, norm, x, train):
        """x (b, c, t); LayerNorm normalises over c."""
        if self.layer_norm:
            return norm(x.transpose(1, 2)).transpose(1, 2)
        return batch_norm(norm, x, train)

    def forward(self, inputs, train=False):
        """In a time region (inputs this rank's frames) the stack runs on
        the whole sequence, its convs' halos and BatchNorm statistics the
        sequence's, and returns this rank's frames."""
        region = collectives.in_time_region()
        if region is not None:
            start, stop, _ = region
            return self._stack(whole_time(inputs), train)[:, start:stop]
        return self._stack(inputs, train)

    def _stack(self, inputs, train):
        x = inputs.transpose(1, 2)
        for i in range(self.n_layers - 1):
            x = getattr(self, f"conv_{i}")(F.pad(x, self.pad))
            x = self.inner(self._norm(getattr(self, f"norm_{i}"), x, train))
        x = self.last(self._norm(self.norm_last,
                                 self.last_conv(F.pad(x, self.pad)), train))
        return self._norm(self.norm_out, inputs.transpose(1, 2) + x,
                          train).transpose(1, 2)


class Postnet(nn.Module):
    """Stop-token Dense(3) + causal conv residual stack
    (`layers.py:491-508`)."""

    def __init__(self, mel_channels: int, conv_filters: int, conv_layers: int,
                 kernel_size: int):
        super().__init__()
        self.stop_linear = Dense(mel_channels, 3)
        self.conv_blocks = CNNResNorm(mel_channels, mel_channels, conv_layers,
                                      conv_filters, kernel_size, "tanh",
                                      padding="causal")

    def forward(self, x, train=False):
        return {"mel_linear": x, "final_output": self.conv_blocks(x, train),
                "stop_prob": self.stop_linear(x)}


class ReferenceEncoderGST(Compute, nn.Module):
    """GST reference encoder: strided Conv2D+BN+relu stack -> GRU -> tanh
    projection -> MHA over the tanh'd style-token bank (`layers.py:511-569`).
    Flax's stride-2 ``SAME`` padding puts the extra pad on the high side, so
    it is an explicit ``F.pad`` here."""

    def __init__(self, mel_channels: int, kernel_size: int, strides: int,
                 conv_filters: Sequence[int], gru_cell_units: int,
                 gst_style_embed_dim: int, multi_num_heads: int,
                 gst_heads: int):
        super().__init__()
        self.kernel_size, self.strides = kernel_size, strides
        self.n_conv = len(conv_filters)
        c, m = 1, mel_channels
        for i, f in enumerate(conv_filters):
            self.add_module(f"conv_{i}", Conv2d(c, f, kernel_size, strides))
            self.add_module(f"bn_{i}", BatchNorm2d(f, eps=BN_EPS))
            c, m = f, -(-m // strides)
        g = gru_cell_units
        self.gru_wi = nn.Parameter(torch.zeros(m * c, 3 * g))
        self.gru_wh = nn.Parameter(torch.zeros(g, 3 * g))
        self.gru_bi = nn.Parameter(torch.zeros(3 * g))
        self.gru_bh = nn.Parameter(torch.zeros(3 * g))
        self.rnn_proj = Dense(g, g)
        self.gst_tokens = nn.Parameter(
            torch.zeros(gst_heads, gst_style_embed_dim // multi_num_heads))
        self.mha = MultiHeadAttention(gst_style_embed_dim, multi_num_heads, g,
                                      gst_style_embed_dim // multi_num_heads)

    def _same_pad(self, size: int):
        out = -(-size // self.strides)
        total = max((out - 1) * self.strides + self.kernel_size - size, 0)
        return total // 2, total - total // 2

    def forward(self, mel, train=False, drop_n_heads=0, generator=None):
        """mel (b, t, n_mels) -> (style embedding (b, 1, gst_style_embed_dim),
        {"gst_attention": the token-bank attention (b, heads, 1, gst_heads)},
        {"GST_tokens": the token parameters (gst_heads, depth)}), as
        `layers.py:569` returns them."""
        b = mel.shape[0]
        x = mel[:, None]                       # (b, 1, t, mel)
        for i in range(self.n_conv):
            pt, pm = self._same_pad(x.shape[2]), self._same_pad(x.shape[3])
            x = getattr(self, f"conv_{i}")(F.pad(x, pm + pt))
            x = torch.relu(batch_norm(getattr(self, f"bn_{i}"), x, train))
        x = x.permute(0, 2, 3, 1).reshape(b, x.shape[2], -1)
        gru = [self.gru_wi, self.gru_wh, self.gru_bi, self.gru_bh]
        tokens = self.gst_tokens
        if self.low_precision:
            # the float32 parameters cast to bf16 (``gru_scan`` then sums
            # the gates in float32 and rounds h once a step)
            gru, x = [p.to(self.dtype) for p in gru], x.to(self.dtype)
            tokens = tokens.to(self.dtype)
        _, h = gru_scan(*gru, x)
        ref = torch.tanh(self.rnn_proj(h))[:, None]
        bank = torch.tanh(tokens)[None].expand(b, -1, -1)
        out, attn = self.mha(bank, bank, ref, train=train,
                             drop_n_heads=drop_n_heads, generator=generator)
        return out, {"gst_attention": attn}, {"GST_tokens": self.gst_tokens}


class DurationPredictor(nn.Module):
    """A 2-layer ``same``-padded CNNResNorm of kernel 3 with LayerNorm and
    relu, then a relu Dense(1): a duration in frames per token
    (`layers.py:572-594`, as the forward model builds it)."""

    def __init__(self, model_dim: int):
        super().__init__()
        self.conv_blocks = CNNResNorm(model_dim, model_dim, 2, model_dim, 3,
                                      "relu", "relu", padding="same",
                                      normalization="layer")
        self.linear = Dense(model_dim, 1)

    def forward(self, x, train=False):
        return torch.relu(self.linear(self.conv_blocks(x, train)))


class ProsodyStatEncoder(nn.Module):
    """Six statistics of the reference mel (TTS layout (b, t, n_mels) in
    [-4, 4]) over its non-padding frames (max |m| > 1e-3), projected to
    ``embed_dim`` through tanh (`layers.py:687-746`): the mean and spread
    of the energy centroid over the lowest min(48, n_mels) bins (a pitch
    proxy), the mean and spread of the frame's mean log-mel, the frame
    count, and the centroid's mean movement between valid neighbours, each
    at etts' scale. Returns (b, 1, embed_dim)."""

    n_centroid_bins = 48

    def __init__(self, embed_dim: int = 32):
        super().__init__()
        self.proj = Dense(6, embed_dim)

    def forward(self, mel):
        m = mel.detach().float()
        valid = (m.abs().amax(-1) > 1e-3).float()
        n = valid.sum(-1).clamp(min=1.0)

        def mean_(x):
            return (x * valid).sum(-1) / n

        def std_(x, mu):
            return torch.sqrt(mean_((x - mu[:, None]) ** 2) + 1e-6)

        nb = min(self.n_centroid_bins, m.shape[-1])
        e = torch.exp(m[:, :, :nb])
        bins = torch.arange(nb, dtype=torch.float32, device=m.device)
        cent = (e * bins).sum(-1) / e.sum(-1).clamp(min=1e-6)
        c_mu = mean_(cent)
        le = m.mean(-1)
        e_mu = mean_(le)
        both = valid[:, 1:] * valid[:, :-1]
        dc = (((cent[:, 1:] - cent[:, :-1]).abs() * both).sum(-1)
              / both.sum(-1).clamp(min=1.0))
        feats = torch.stack([c_mu / nb, std_(cent, c_mu) / 12.0, e_mu / 4.0,
                             std_(le, e_mu) / 2.0, n / 500.0, dc / 8.0], -1)
        return torch.tanh(self.proj(feats))[:, None]


# ---------------------------------------------------------------------------
# MINE / CLUB critic networks (`layers.py:601-684`); ``in_dim`` is the width
# of the pair they read (flax infers it at init)
# ---------------------------------------------------------------------------

def _mlp(module, in_dim: int, hidden: Sequence[int], out_dim: int):
    """relu Dense layers ``fc_i``, then ``fc_proj`` to ``out_dim``."""
    for i, f in enumerate(hidden):
        module.add_module(f"fc_{i}", nn.Linear(in_dim, f))
        in_dim = f
    module.n_hidden = len(hidden)
    module.fc_proj = nn.Linear(in_dim, out_dim)


def _run_mlp(module, x):
    for i in range(module.n_hidden):
        x = torch.relu(getattr(module, f"fc_{i}")(x))
    return module.fc_proj(x)


class MineNetFirstOrder(nn.Module):
    """relu MLP -> Dense(1) critic (`layers.py:601-610`)."""

    def __init__(self, in_dim: int, dense_hidden_units: Sequence[int]):
        super().__init__()
        _mlp(self, in_dim, dense_hidden_units, 1)

    def forward(self, x):
        return _run_mlp(self, x)


class MineNetSecondOrder(nn.Module):
    """``VALID`` relu Conv1D stack over the ``length`` axis of x (b, length,
    in_dim) -> flatten -> MLP critic (`layers.py:613-628`)."""

    def __init__(self, in_dim: int, length: int, filters: Sequence[int],
                 kernel_size: int, dense_hidden_units: Sequence[int]):
        super().__init__()
        self.n_conv = len(filters)
        for i, f in enumerate(filters):
            self.add_module(f"conv_{i}", nn.Conv1d(in_dim, f, kernel_size))
            in_dim, length = f, length - kernel_size + 1
        if length < 1:
            raise ValueError("MineNetSecondOrder needs more frames than its "
                             "convs' kernels take")
        _mlp(self, in_dim * length, dense_hidden_units, 1)

    def forward(self, x):
        x = x.transpose(1, 2)
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        return _run_mlp(self, x.transpose(1, 2).reshape(x.shape[0], -1))


class MineNetLinear(nn.Module):
    """Linear-stack critic on (b, 1, d), its middle axis squeezed and
    restored (`layers.py:631-646`); etts draws its kernels and biases
    normal with std ``init_std``."""
    init_std = 0.05

    def __init__(self, in_dim: int, dense_hidden_units: Sequence[int]):
        super().__init__()
        _mlp(self, in_dim, dense_hidden_units, 1)

    def forward(self, x):
        return _run_mlp(self, x[:, 0])[:, None]


class MineNetLinearQ(nn.Module):
    """Linear stack + quadratic term x^T W x + x b (`layers.py:649-669`),
    every parameter normal with std ``init_std``."""
    init_std = 0.05

    def __init__(self, in_dim: int, dense_hidden_units: Sequence[int]):
        super().__init__()
        self.q_w = nn.Parameter(torch.zeros(in_dim, in_dim))
        self.q_b = nn.Parameter(torch.zeros(in_dim, 1))
        _mlp(self, in_dim, dense_hidden_units, 1)

    def forward(self, x):
        x = x[:, 0]
        q_term = (x * (x @ self.q_w)).sum(1, keepdim=True)
        return (_run_mlp(self, x) + x @ self.q_b + q_term)[:, None]


class CLUBNet(nn.Module):
    """MLP -> Dense(out_dim), tanh'd for the log-variance head
    (`layers.py:672-684`)."""

    def __init__(self, in_dim: int, dense_hidden_units: Sequence[int],
                 log_var: bool, out_dim: int = 256):
        super().__init__()
        self.log_var = log_var
        _mlp(self, in_dim, dense_hidden_units, out_dim)

    def forward(self, x):
        x = _run_mlp(self, x)
        return torch.tanh(x) if self.log_var else x
