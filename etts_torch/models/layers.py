"""Transformer-TTS building blocks for inference (port of
``etts/models/layers.py``).

Module and parameter names follow the flax tree (``sarn``, ``carn``, ``mha``,
``wq`` ...) so ``etts_torch.convert`` maps exported keys mechanically.
Behaviour kept from the reference (SURVEY §2.7):
  - the MHA output projection takes concat([query_input, attention])
  - DecoderPrenet dropout is always on, at a runtime rate
  - positional encodings are r-strided under the reduction factor
Only the all-dense block stacks are ported; conv attention blocks raise.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..ops.masking import positional_encoding

LN_EPS = 1e-6
BN_EPS = 1e-3          # flax BatchNorm(epsilon=1e-3) in CNNResNorm / GST


def variable_rate_dropout(x, rate: float, generator=None):
    """Inverted dropout that is always applied: keep where u < 1 - rate, u
    drawn from ``generator``; rate 0 is the identity and draws nothing."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / max(keep, 1e-8), torch.zeros_like(x))


def attention(q, k, v, mask=None):
    """q (..., tq, d), k/v (..., tk, d); mask broadcastable, 1 = masked."""
    logits = q @ k.transpose(-1, -2) / (k.shape[-1] ** 0.5)
    if mask is not None:
        logits = logits + mask * -1e9
    w = torch.softmax(logits, dim=-1)
    return w @ v, w


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
        self.wq = nn.Linear(q_dim, model_dim)
        self.wk = nn.Linear(kv_dim, model_dim)
        self.wv = nn.Linear(kv_dim, model_dim)
        self.dense = nn.Linear(q_dim + model_dim, model_dim)

    def split(self, x):
        b, t, _ = x.shape
        return x.view(b, t, self.num_heads, -1).transpose(1, 2)

    def forward(self, v, k, q_in, mask=None, kv=None, cache=None,
                cache_index=None):
        """``kv``: precomputed head-split (k, v). ``cache``: {'k','v'}
        (b, h, T, depth) self-attention cache, written in place at
        ``cache_index`` (q covers one step); attention reads rows <= index."""
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
        b, _, tq, _ = out.shape
        concat = out.transpose(1, 2).reshape(b, tq, self.model_dim)
        return self.dense(torch.cat([q_in, concat], -1)), w


class FFNResNorm(nn.Module):
    """Dense-Dense + LN + relu + LN(x + y) (`layers.py:99-115`)."""

    def __init__(self, model_dim: int, hidden: int):
        super().__init__()
        self.d1 = nn.Linear(model_dim, hidden)
        self.d2 = nn.Linear(hidden, model_dim)
        self.ln = nn.LayerNorm(model_dim, eps=LN_EPS)
        self.last_ln = nn.LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, x):
        y = torch.relu(self.ln(self.d2(self.d1(x))))
        return self.last_ln(x + y)


class SelfAttentionResNorm(nn.Module):
    def __init__(self, model_dim: int, num_heads: int):
        super().__init__()
        self.mha = MultiHeadAttention(model_dim, num_heads, model_dim,
                                      model_dim)
        self.ln = nn.LayerNorm(model_dim, eps=LN_EPS)
        self.last_ln = nn.LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, x, mask, cache=None, cache_index=None):
        """-> (output, attention weights (b, h, tq, tk))."""
        attn, w = self.mha(x, x, x, mask, cache=cache, cache_index=cache_index)
        return self.last_ln(self.ln(attn) + x), w


class CrossAttentionResnorm(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, enc_dim: int):
        super().__init__()
        self.mha = MultiHeadAttention(model_dim, num_heads, model_dim, enc_dim)
        self.layernorm = nn.LayerNorm(model_dim, eps=LN_EPS)

    def forward(self, q, enc, mask, kv=None):
        attn, w = self.mha(enc, enc, q, mask, kv=kv)
        return self.layernorm(attn + q), w


class SelfAttentionDenseBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, hidden: int):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads)
        self.ffn = FFNResNorm(model_dim, hidden)

    def forward(self, x, mask):
        x, w = self.sarn(x, mask)
        return self.ffn(x), w


class CrossAttentionDenseBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, hidden: int,
                 enc_dim: int):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads)
        self.carn = CrossAttentionResnorm(model_dim, num_heads, enc_dim)
        self.ffn = FFNResNorm(model_dim, hidden)

    def forward(self, x, enc, self_mask, cross_mask, cache=None,
                cache_index=None):
        x, _ = self.sarn(x, self_mask, cache, cache_index)
        kv = None if cache is None else (cache["ck"], cache["cv"])
        x, w = self.carn(x, enc, cross_mask, kv)
        return self.ffn(x), w


def _check_all_dense(num_heads: Sequence[int], dense_blocks: int):
    if dense_blocks != len(num_heads):
        raise NotImplementedError(
            "etts_torch ports the all-dense attention stacks only "
            f"({dense_blocks} dense of {len(num_heads)} blocks)")


class SelfAttentionBlocks(nn.Module):
    """Encoder stack with sqrt(d)-scaled, positionally encoded input
    (`layers.py:253-304`), as the text encoder. Returns (x, {f"TextEncoder_
    DenseBlock{i}_SelfAttention": each block's attention weights (b, h, t,
    t)}), etts' keys for it."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int):
        super().__init__()
        _check_all_dense(num_heads, dense_blocks)
        self.model_dim = model_dim
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        for i, h in enumerate(num_heads):
            self.add_module(f"SADB_{i}",
                            SelfAttentionDenseBlock(model_dim, h, hidden))
        self.n_blocks = len(num_heads)

    def forward(self, x, padding_mask):
        x = x * (self.model_dim ** 0.5) + self.pos_encoding[:x.shape[1]]
        weights = {}
        for i in range(self.n_blocks):
            x, w = getattr(self, f"SADB_{i}")(x, padding_mask)
            weights[f"TextEncoder_DenseBlock{i + 1}_SelfAttention"] = w
        return x, weights


class CrossAttentionBlocks(nn.Module):
    """Decoder stack: self- and cross-attention per block
    (`layers.py:403-464`)."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int, enc_dim: int):
        super().__init__()
        _check_all_dense(num_heads, dense_blocks)
        self.model_dim = model_dim
        self.num_heads = tuple(num_heads)
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        for i, h in enumerate(num_heads):
            self.add_module(f"CADB_{i}", CrossAttentionDenseBlock(
                model_dim, h, hidden, enc_dim))

    def blocks(self):
        return [getattr(self, f"CADB_{i}") for i in range(len(self.num_heads))]

    def step(self, x, enc, cross_mask, caches, index: int, r: int):
        """One incremental step (x: (b, 1, d)) at position ``index * r``.
        Returns (x, last block's cross-attention (b, h, 1, n_enc))."""
        x = x * (self.model_dim ** 0.5) + self.pos_encoding[index * r]
        w = None
        for block, cache in zip(self.blocks(), caches):
            x, w = block(x, enc, None, cross_mask, cache, index)
        return x, w


class DecoderPrenet(nn.Module):
    """Two relu Dense layers with always-on dropout at a runtime rate
    (`layers.py:471-488`)."""

    def __init__(self, mel_channels: int, hidden: int, model_dim: int):
        super().__init__()
        self.d1 = nn.Linear(mel_channels, hidden)
        self.d2 = nn.Linear(hidden, model_dim)

    def forward(self, x, rate: float, generator=None):
        x = variable_rate_dropout(torch.relu(self.d1(x)), rate, generator)
        return variable_rate_dropout(torch.relu(self.d2(x)), rate, generator)


class CNNResNorm(nn.Module):
    """The postnet's conv stack (`layers.py:58-96` with causal padding,
    tanh inner and linear last activation, BatchNorm): n_layers causal
    Conv1D + BatchNorm, then BatchNorm(inputs + stack). Layout (b, t, c) at
    the interface."""

    def __init__(self, in_size: int, out_size: int, n_layers: int,
                 hidden_size: int, kernel_size: int):
        super().__init__()
        self.n_layers = n_layers
        self.kernel_size = kernel_size
        c = in_size
        for i in range(n_layers - 1):
            self.add_module(f"conv_{i}", nn.Conv1d(c, hidden_size, kernel_size))
            self.add_module(f"norm_{i}", nn.BatchNorm1d(hidden_size, eps=BN_EPS))
            c = hidden_size
        self.last_conv = nn.Conv1d(c, out_size, kernel_size)
        self.norm_last = nn.BatchNorm1d(out_size, eps=BN_EPS)
        self.norm_out = nn.BatchNorm1d(out_size, eps=BN_EPS)

    def _conv(self, conv, x):
        return conv(F.pad(x, (self.kernel_size - 1, 0)))

    def forward(self, inputs):
        x = inputs.transpose(1, 2)
        for i in range(self.n_layers - 1):
            x = torch.tanh(getattr(self, f"norm_{i}")(
                self._conv(getattr(self, f"conv_{i}"), x)))
        x = self.norm_last(self._conv(self.last_conv, x))
        return self.norm_out(inputs.transpose(1, 2) + x).transpose(1, 2)


class Postnet(nn.Module):
    """Stop-token Dense(3) + causal conv residual stack
    (`layers.py:491-508`)."""

    def __init__(self, mel_channels: int, conv_filters: int, conv_layers: int,
                 kernel_size: int):
        super().__init__()
        self.stop_linear = nn.Linear(mel_channels, 3)
        self.conv_blocks = CNNResNorm(mel_channels, mel_channels, conv_layers,
                                      conv_filters, kernel_size)

    def forward(self, x):
        return {"mel_linear": x, "final_output": self.conv_blocks(x),
                "stop_prob": self.stop_linear(x)}


class ReferenceEncoderGST(nn.Module):
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
            self.add_module(f"conv_{i}", nn.Conv2d(c, f, kernel_size, strides))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(f, eps=BN_EPS))
            c, m = f, -(-m // strides)
        g = gru_cell_units
        self.gru_wi = nn.Parameter(torch.zeros(m * c, 3 * g))
        self.gru_wh = nn.Parameter(torch.zeros(g, 3 * g))
        self.gru_bi = nn.Parameter(torch.zeros(3 * g))
        self.gru_bh = nn.Parameter(torch.zeros(3 * g))
        self.rnn_proj = nn.Linear(g, g)
        self.gst_tokens = nn.Parameter(
            torch.zeros(gst_heads, gst_style_embed_dim // multi_num_heads))
        self.mha = MultiHeadAttention(gst_style_embed_dim, multi_num_heads, g,
                                      gst_style_embed_dim // multi_num_heads)

    def _same_pad(self, size: int):
        out = -(-size // self.strides)
        total = max((out - 1) * self.strides + self.kernel_size - size, 0)
        return total // 2, total - total // 2

    def forward(self, mel):
        """mel (b, t, n_mels) -> (style embedding (b, 1, gst_style_embed_dim),
        {"gst_attention": the token-bank attention (b, heads, 1, gst_heads)},
        {"GST_tokens": the token parameters (gst_heads, depth)}), as
        `layers.py:569` returns them."""
        b = mel.shape[0]
        x = mel[:, None]                       # (b, 1, t, mel)
        for i in range(self.n_conv):
            pt, pm = self._same_pad(x.shape[2]), self._same_pad(x.shape[3])
            x = getattr(self, f"conv_{i}")(F.pad(x, pm + pt))
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(b, x.shape[2], -1)
        _, h = gru_scan(self.gru_wi, self.gru_wh, self.gru_bi, self.gru_bh, x)
        ref = torch.tanh(self.rnn_proj(h))[:, None]
        bank = torch.tanh(self.gst_tokens)[None].expand(b, -1, -1)
        out, attn = self.mha(bank, bank, ref)
        return out, {"gst_attention": attn}, {"GST_tokens": self.gst_tokens}
