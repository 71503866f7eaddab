"""Transformer-TTS building blocks for inference (port of
``etts/models/layers.py``).

Module and parameter names follow the flax tree (``sarn``, ``carn``, ``mha``,
``wq`` ...) so ``etts_torch.convert`` maps exported keys mechanically.
Behaviour kept from the reference (SURVEY §2.7):
  - the MHA output projection takes concat([query_input, attention])
  - DecoderPrenet dropout is always on, at a runtime rate
  - positional encodings are r-strided under the reduction factor
  - a stack runs its dense blocks first, then its conv blocks
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

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
                "linear": lambda x: x}


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


class SelfAttentionConvBlock(nn.Module):
    """Self-attention, then a 2-layer ``same``-padded relu CNNResNorm with
    BatchNorm (`layers.py:228-250`; etts builds it with relu only)."""

    def __init__(self, model_dim: int, num_heads: int, conv_filters: int,
                 kernel_size: int):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads)
        self.conv = CNNResNorm(model_dim, model_dim, 2, conv_filters,
                               kernel_size, "relu", "relu", padding="same")

    def forward(self, x, mask):
        x, w = self.sarn(x, mask)
        return self.conv(x), w


class CrossAttentionConvBlock(nn.Module):
    """Self- and cross-attention, then a 2-layer causal relu CNNResNorm with
    BatchNorm (`layers.py:358-400`). In the incremental decode the cache's
    ``conv`` entry holds the 2 * (kernel - 1) block inputs before the new
    step (zeros before the start); the step convolves [window | new], keeps
    the last rows, and moves the window on."""

    def __init__(self, model_dim: int, num_heads: int, conv_filters: int,
                 kernel_size: int, enc_dim: int):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads)
        self.carn = CrossAttentionResnorm(model_dim, num_heads, enc_dim)
        self.conv = CNNResNorm(model_dim, model_dim, 2, conv_filters,
                               kernel_size, "relu", "relu", padding="causal")

    def forward(self, x, enc, self_mask, cross_mask, cache=None,
                cache_index=None):
        x, _ = self.sarn(x, self_mask, cache, cache_index)
        kv = None if cache is None else (cache["ck"], cache["cv"])
        x, w = self.carn(x, enc, cross_mask, kv)
        if cache is None:
            return self.conv(x), w
        window = torch.cat([cache["conv"], x], 1)
        cache["conv"] = window[:, x.shape[1]:]
        return self.conv(window)[:, -x.shape[1]:], w


class SelfAttentionBlocks(nn.Module):
    """Encoder stack with sqrt(d)-scaled, positionally encoded input
    (`layers.py:253-304`): ``dense_blocks`` dense blocks ``SADB_i``, then
    conv blocks ``SACB_j``. Returns (x, {f"{name_prefix}_DenseBlock{i}_
    SelfAttention" or f"{name_prefix}_ConvBlock{j}_SelfAttention": each
    block's attention weights (b, h, t, t)}), numbered from 1, etts' keys."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int, conv_filters: int,
                 kernel_size: int, name_prefix: str = "TextEncoder"):
        super().__init__()
        self.model_dim = model_dim
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        self.attention_keys = {}            # block name -> etts' key
        for i, h in enumerate(num_heads):
            if i < dense_blocks:
                name, kind, j = f"SADB_{i}", "DenseBlock", i
                block = SelfAttentionDenseBlock(model_dim, h, hidden)
            else:
                j = i - dense_blocks
                name, kind = f"SACB_{j}", "ConvBlock"
                block = SelfAttentionConvBlock(model_dim, h, conv_filters,
                                               kernel_size)
            self.add_module(name, block)
            self.attention_keys[name] = (
                f"{name_prefix}_{kind}{j + 1}_SelfAttention")

    def forward(self, x, padding_mask):
        x = x * (self.model_dim ** 0.5) + self.pos_encoding[:x.shape[1]]
        weights = {}
        for name, key in self.attention_keys.items():
            x, weights[key] = getattr(self, name)(x, padding_mask)
        return x, weights


class CrossAttentionBlocks(nn.Module):
    """Decoder stack: self- and cross-attention per block
    (`layers.py:403-464`), ``dense_blocks`` dense blocks ``CADB_i``, then
    causal conv blocks ``CACB_j``."""

    def __init__(self, model_dim: int, hidden: int, num_heads: Sequence[int],
                 max_position: int, dense_blocks: int, enc_dim: int,
                 conv_filters: int, conv_kernel: int):
        super().__init__()
        self.model_dim = model_dim
        self.num_heads = tuple(num_heads)
        self.dense_blocks = dense_blocks
        self.conv_kernel = conv_kernel
        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding(max_position, model_dim)[0]), persistent=False)
        for i, h in enumerate(num_heads):
            if i < dense_blocks:
                self.add_module(f"CADB_{i}", CrossAttentionDenseBlock(
                    model_dim, h, hidden, enc_dim))
            else:
                self.add_module(f"CACB_{i - dense_blocks}",
                                CrossAttentionConvBlock(
                                    model_dim, h, conv_filters, conv_kernel,
                                    enc_dim))

    def blocks(self):
        n = self.dense_blocks
        return [getattr(self, f"CADB_{i}" if i < n else f"CACB_{i - n}")
                for i in range(len(self.num_heads))]

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
            return (nn.LayerNorm(c, eps=LN_EPS) if self.layer_norm
                    else nn.BatchNorm1d(c, eps=BN_EPS))
        c = in_size
        for i in range(n_layers - 1):
            self.add_module(f"conv_{i}", nn.Conv1d(c, hidden_size, k))
            self.add_module(f"norm_{i}", norm(hidden_size))
            c = hidden_size
        self.last_conv = nn.Conv1d(c, out_size, k)
        self.norm_last = norm(out_size)
        self.norm_out = norm(out_size)

    def _norm(self, norm, x):
        """x (b, c, t); LayerNorm normalises over c."""
        if self.layer_norm:
            return norm(x.transpose(1, 2)).transpose(1, 2)
        return norm(x)

    def forward(self, inputs):
        x = inputs.transpose(1, 2)
        for i in range(self.n_layers - 1):
            x = getattr(self, f"conv_{i}")(F.pad(x, self.pad))
            x = self.inner(self._norm(getattr(self, f"norm_{i}"), x))
        x = self.last(self._norm(self.norm_last,
                                 self.last_conv(F.pad(x, self.pad))))
        return self._norm(self.norm_out,
                          inputs.transpose(1, 2) + x).transpose(1, 2)


class Postnet(nn.Module):
    """Stop-token Dense(3) + causal conv residual stack
    (`layers.py:491-508`)."""

    def __init__(self, mel_channels: int, conv_filters: int, conv_layers: int,
                 kernel_size: int):
        super().__init__()
        self.stop_linear = nn.Linear(mel_channels, 3)
        self.conv_blocks = CNNResNorm(mel_channels, mel_channels, conv_layers,
                                      conv_filters, kernel_size, "tanh",
                                      padding="causal")

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


class DurationPredictor(nn.Module):
    """A 2-layer ``same``-padded CNNResNorm of kernel 3 with LayerNorm and
    relu, then a relu Dense(1): a duration in frames per token
    (`layers.py:572-594`, as the forward model builds it)."""

    def __init__(self, model_dim: int):
        super().__init__()
        self.conv_blocks = CNNResNorm(model_dim, model_dim, 2, model_dim, 3,
                                      "relu", "relu", padding="same",
                                      normalization="layer")
        self.linear = nn.Linear(model_dim, 1)

    def forward(self, x):
        return torch.relu(self.linear(self.conv_blocks(x)))


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
        self.proj = nn.Linear(6, embed_dim)

    def forward(self, mel):
        m = mel.float()
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
