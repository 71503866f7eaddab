"""GST-Tacotron (port of ``etts/models/tacotron.py``): CBHG encoder,
reference encoder and multi-head style attention over the tanh'd style
tokens, a Bahdanau attention GRU and two zoneout LSTMs decoding r frames a
step, the post CBHG and the linear-spectrogram head; free-running in
``Tacotron.generate`` (inference), teacher-forced in ``Tacotron.forward``
(training and GTA), with ``tacotron_loss`` and ``noam_learning_rate``.

Module and parameter names follow the flax tree (``attention_gru.ir``,
``lstm_1.hf``, ``conv1d_3.Conv_0``, ``gru_fw_wi`` ...), so
``etts_torch.convert`` loads a flat export unchanged. Behaviour kept from
etts:
  - the prenets' dropout 0.5 is always on (`modules.py:6-14`); its
    uniforms, the random style weights used without a reference and
    zoneout's training uniforms are inputs (``Tacotron.draw_uniforms``),
    so a CPU and a card run of one seed compute the same function;
  - zoneout in inference is the fixed mix ``old * 0.1 + new * 0.9`` of
    each LSTM's carry (`tacotron.py:259-265`); in training, per step,
    LSTM and carry part, ``m = floor(0.9 + U)`` keeps the new value where
    it is 1 and the old where it is 0 (`:244-256`); the LSTM's output,
    which the residual adds, is the unmixed h either way;
  - BatchNorm normalises by its running statistics, eps 1e-3; in training
    by the batch's, and the running ones move by flax's rule (momentum
    0.99, biased variance), padded ids and frames included, as etts never
    masks them; the reference encoder's move twice a step, on the target
    and then on the prediction;
  - ``generate`` runs all ``max_iters`` steps, and zeroes a step's frames
    only when an earlier step's frames were all below 1e-6.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..parallel import collectives
from .layers import BN_EPS, batch_norm

__all__ = ["TacoPrenet", "ConvBN1D", "Highway", "CBHG",
           "TacoReferenceEncoder", "StyleAttention", "TacotronDecoderCell",
           "Tacotron", "tacotron_loss", "noam_learning_rate"]

KEEP = 0.5          # the prenets keep half their units, always
ZONEOUT = 0.1
WARMUP = 4000.0     # Noam's warm-up steps
STOP_LEVEL = 1e-6   # a step whose frames all lie below this finishes


def _same_pad(size: int, kernel: int, stride: int):
    """flax ``SAME`` padding (before, after): the odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class TacoPrenet(nn.Module):
    """Dense + relu layers, each followed by dropout 0.5 that is always on
    (`tacotron.py:40-52`): a unit is kept, times 2, where its uniform is
    below 0.5. ``u`` holds one uniform a unit of every layer, the layers'
    concatenated on the last axis."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int] = (256, 128)):
        super().__init__()
        self.sizes = tuple(layer_sizes)
        for i, size in enumerate(self.sizes):
            self.add_module(f"dense_{i + 1}", nn.Linear(in_dim, size))
            in_dim = size

    def forward(self, x, u):
        for i, ui in enumerate(u.split(self.sizes, -1)):
            x = torch.relu(getattr(self, f"dense_{i + 1}")(x))
            x = torch.where(ui < KEEP, x / KEEP, torch.zeros_like(x))
        return x


class ConvBN1D(nn.Module):
    """flax ``SAME`` Conv1D ((k - 1) // 2 before, k // 2 after), relu
    unless ``relu`` is False, then BatchNorm (`tacotron.py:55-68`). Layout
    (b, c, t)."""

    def __init__(self, in_dim: int, channels: int, kernel_size: int,
                 relu: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_dim, channels, kernel_size)
        self.BatchNorm_0 = nn.BatchNorm1d(channels, eps=BN_EPS)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.Conv_0(F.pad(x, self.pad))
        if self.relu:
            x = torch.relu(x)
        return batch_norm(self.BatchNorm_0, x, train)


class Highway(nn.Module):
    def __init__(self, units: int = 128):
        super().__init__()
        self.H = nn.Linear(units, units)
        self.T = nn.Linear(units, units)

    def forward(self, x):
        t = torch.sigmoid(self.T(x))
        return torch.relu(self.H(x)) * t + x * (1.0 - t)


class CBHG(nn.Module):
    """Conv bank (k = 1..K) + max-pool (width 2, stride 1, one -inf frame
    after) + two projection convs + residual + (``dim_match`` where the
    projection's width is not ``width``) + 4 highways + BiGRU
    (`tacotron.py:84-124`). (b, t, in_dim) -> (b, t, 2 * width)."""

    def __init__(self, in_dim: int, K: int, projections: Sequence[int],
                 width: int = 128):
        super().__init__()
        self.K = K
        for k in range(1, K + 1):
            self.add_module(f"conv1d_{k}", ConvBN1D(in_dim, width, k))
        self.proj_1 = ConvBN1D(K * width, projections[0], 3)
        self.proj_2 = ConvBN1D(projections[0], projections[1], 3, relu=False)
        self.dim_match = (nn.Linear(projections[1], width)
                          if projections[1] != width else None)
        for i in range(1, 5):
            self.add_module(f"highway_{i}", Highway(width))
        for d in ("fw", "bw"):
            for name, shape in (("wi", (width, 3 * width)),
                                ("wh", (width, 3 * width)),
                                ("bi", (3 * width,)), ("bh", (3 * width,))):
                setattr(self, f"gru_{d}_{name}",
                        nn.Parameter(torch.zeros(shape)))

    def _gru(self, d: str, x, reverse: bool):
        p = [getattr(self, f"gru_{d}_{n}") for n in ("wi", "wh", "bi", "bh")]
        return gru_scan(*p, x, reverse=reverse)[0]

    def forward(self, x, train: bool = False):
        inputs = x
        x = x.transpose(1, 2)
        x = torch.cat([getattr(self, f"conv1d_{k}")(x, train)
                       for k in range(1, self.K + 1)], 1)
        x = torch.maximum(x, F.pad(x[:, :, 1:], (0, 1), value=-math.inf))
        x = self.proj_2(self.proj_1(x, train), train).transpose(1, 2) + inputs
        if self.dim_match is not None:
            x = self.dim_match(x)
        for i in range(1, 5):
            x = getattr(self, f"highway_{i}")(x)
        return torch.cat([self._gru("fw", x, False),
                          self._gru("bw", x, True)], -1)


class TacoReferenceEncoder(nn.Module):
    """Stride-2 3x3 Conv2D + BatchNorm + relu stack (flax ``SAME``
    padding), GRU, tanh Dense (`tacotron.py:138-162`): mel (b, t, n_mels)
    -> (b, proj_dim)."""

    def __init__(self, n_mels: int,
                 filters: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 depth: int = 128, proj_dim: int = 128):
        super().__init__()
        self.n_conv = len(filters)
        c, m = 1, n_mels
        for i, ch in enumerate(filters):
            self.add_module(f"conv2d_{i}", nn.Conv2d(c, ch, 3, 2))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(ch, eps=BN_EPS))
            c, m = ch, -(-m // 2)
        self.gru_wi = nn.Parameter(torch.zeros(m * c, 3 * depth))
        self.gru_wh = nn.Parameter(torch.zeros(depth, 3 * depth))
        self.gru_bi = nn.Parameter(torch.zeros(3 * depth))
        self.gru_bh = nn.Parameter(torch.zeros(3 * depth))
        self.ref_proj = nn.Linear(depth, proj_dim)

    def forward(self, mel, train: bool = False):
        b = mel.shape[0]
        x = mel[:, None]                       # (b, 1, t, n_mels)
        for i in range(self.n_conv):
            pad = _same_pad(x.shape[3], 3, 2) + _same_pad(x.shape[2], 3, 2)
            x = getattr(self, f"conv2d_{i}")(F.pad(x, pad))
            x = torch.relu(batch_norm(getattr(self, f"bn_{i}"), x, train))
        # flax's NHWC (b, t, f, c) flattened to (b, t, f * c)
        x = x.permute(0, 2, 3, 1).reshape(b, x.shape[2], -1)
        _, h = gru_scan(self.gru_wi, self.gru_wh, self.gru_bi, self.gru_bh, x)
        return torch.tanh(self.ref_proj(h))


class StyleAttention(nn.Module):
    """Multi-head style attention (`tacotron.py:165-209`): q and k
    projected, V the raw token bank tiled per head, heads concatenated.
    ``mlp_attention`` scores by a weight-normalised vector
    ``g * v / |v|`` plus a bias (``normalize``) or by ``v`` alone;
    ``dot_attention`` by q.k, scaled by depth^-0.5 under ``normalize``."""

    def __init__(self, query_dim: int, value_dim: int, num_heads: int = 4,
                 num_units: int = 128, attention_type: str = "mlp_attention",
                 normalize: bool = True):
        super().__init__()
        if num_units % num_heads:
            raise ValueError(f"num_units {num_units} is not a multiple of "
                             f"num_heads {num_heads}")
        if attention_type not in ("mlp_attention", "dot_attention"):
            raise ValueError(attention_type)
        self.num_heads, self.d = num_heads, num_units // num_heads
        self.mlp, self.normalize = attention_type == "mlp_attention", normalize
        self.q_proj = nn.Linear(query_dim, num_units)
        self.k_proj = nn.Linear(value_dim, num_units)
        if self.mlp:
            self.attention_v = nn.Parameter(torch.zeros(1, self.d))
            if normalize:
                self.attention_g = nn.Parameter(torch.zeros(()))
                self.attention_b = nn.Parameter(torch.zeros(self.d))

    def forward(self, query, value):
        """query (b, tq, query_dim), value (b, tk, value_dim) -> (b, tq,
        num_heads * value_dim)."""
        b, h, d = query.shape[0], self.num_heads, self.d
        qs = self.q_proj(query).view(b, -1, h, d).transpose(1, 2)
        ks = self.k_proj(value).view(b, -1, h, d).transpose(1, 2)
        vs = value[:, None].expand(-1, h, -1, -1)
        if not self.mlp:
            qk = qs @ ks.transpose(-1, -2)
            if self.normalize:
                qk = qk * d ** -0.5
            w = torch.softmax(qk, -1)
        else:
            v = self.attention_v[0]
            if self.normalize:
                v = self.attention_g * v * torch.rsqrt((v * v).sum())
                add = (v * torch.tanh(ks + qs + self.attention_b)).sum(
                    -1, keepdim=True)
            else:
                add = (v * torch.tanh(ks + qs)).sum(-1, keepdim=True)
            w = torch.softmax(add.transpose(-1, -2), -1)
        ctx = (w @ vs).transpose(1, 2)
        return ctx.reshape(b, ctx.shape[1], -1)


class GRUCell(nn.Module):
    """flax ``GRUCell``'s parameters: ``ir``, ``iz``, ``in`` with biases,
    ``hr``, ``hz`` without, ``hn`` with one inside r * (...)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, nn.Linear(in_dim, features))
        for g in ("hr", "hz"):
            self.add_module(g, nn.Linear(features, features, bias=False))
        self.add_module("hn", nn.Linear(features, features))

    def stacked(self):
        """The gates' matrices stacked [r, z, n]: (wi, bi, wh, bh)."""
        g = lambda n: getattr(self, n)
        hn = g("hn").bias
        return (torch.cat([g(n).weight for n in ("ir", "iz", "in")]),
                torch.cat([g(n).bias for n in ("ir", "iz", "in")]),
                torch.cat([g(n).weight for n in ("hr", "hz", "hn")]),
                torch.cat([hn.new_zeros(2 * hn.shape[0]), hn]))

    @staticmethod
    def step(w, x, h):
        gi, gh = F.linear(x, w[0], w[1]), F.linear(h, w[2], w[3])
        ir, iz, i_n = gi.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * hn)
        return (1.0 - z) * n + z * h


class LSTMCell(nn.Module):
    """flax ``LSTMCell``'s parameters: ``ii``, ``if``, ``ig``, ``io``
    without biases, ``hi``, ``hf``, ``hg``, ``ho`` with; gates i, f, g, o;
    carry (c, h)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for g in ("ii", "if", "ig", "io"):
            self.add_module(g, nn.Linear(in_dim, features, bias=False))
        for g in ("hi", "hf", "hg", "ho"):
            self.add_module(g, nn.Linear(features, features))

    def stacked(self):
        """The gates' matrices stacked [i, f, g, o]: (wi, wh, bh)."""
        g = lambda n: getattr(self, n)
        return (torch.cat([g(n).weight for n in ("ii", "if", "ig", "io")]),
                torch.cat([g(n).weight for n in ("hi", "hf", "hg", "ho")]),
                torch.cat([g(n).bias for n in ("hi", "hf", "hg", "ho")]))

    @staticmethod
    def step(w, x, c, h):
        """-> (new c, new h)."""
        i, f, g, o = (F.linear(x, w[0]) + F.linear(h, w[1], w[2])).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class TacotronDecoderCell(nn.Module):
    """One decoder step (`tacotron.py:212-283`): prenet -> attention GRU
    -> Bahdanau attention (scores -1e9 on padded encoder steps, context
    over the encoder output) -> rnn_proj -> 2 zoneout LSTMs with residuals
    -> frame_proj (r frames)."""

    def __init__(self, num_mels: int, enc_dim: int, attention_depth: int = 256,
                 rnn_depth: int = 256, outputs_per_step: int = 2,
                 prenet_depths: Sequence[int] = (256, 128)):
        super().__init__()
        self.decoder_prenet = TacoPrenet(num_mels, prenet_depths)
        self.attention_gru = GRUCell(prenet_depths[-1] + enc_dim,
                                     attention_depth)
        self.query_proj = nn.Linear(attention_depth, attention_depth,
                                    bias=False)
        self.attention_v = nn.Parameter(torch.zeros(1, attention_depth))
        self.rnn_proj = nn.Linear(attention_depth + enc_dim, rnn_depth)
        self.lstm_1 = LSTMCell(rnn_depth, rnn_depth)
        self.lstm_2 = LSTMCell(rnn_depth, rnn_depth)
        self.frame_proj = nn.Linear(rnn_depth, num_mels * outputs_per_step)

    def stacked(self) -> dict:
        """The recurrent cells' gate matrices, stacked once for a decode."""
        return {"gru": self.attention_gru.stacked(),
                "lstm_1": self.lstm_1.stacked(),
                "lstm_2": self.lstm_2.stacked()}

    def forward(self, carry, prev, keys, values, enc_mask, u, w=None):
        """carry (gru_h, (c1, h1), (c2, h2), context); prev (b, num_mels),
        the last frame fed back; keys (b, n, attention_depth), values the
        encoder output (b, n, enc_dim), enc_mask (b, n); u the prenet's
        uniforms (b, sum(prenet_depths)); w ``stacked()`` (made here
        without it). -> (carry, frames (b, num_mels * r), alignment
        (b, n)), zoneout the inference mix."""
        return self.step(carry, self.decoder_prenet(prev, u), keys, values,
                         enc_mask, self.stacked() if w is None else w)

    def step(self, carry, x, keys, values, enc_mask, w, zu=None):
        """``forward`` from the prenet's output x (b, prenet_depths[-1])
        on; zu zoneout's training uniforms (2 LSTMs, (c, h), b,
        rnn_depth), None for the inference mix."""
        gru_h, lstm1, lstm2, context = carry
        gru_h = GRUCell.step(w["gru"], torch.cat([x, context], -1), gru_h)
        q = self.query_proj(gru_h)
        scores = torch.tanh(keys + q[:, None]) @ self.attention_v[0]
        align = torch.softmax(scores.masked_fill(~enc_mask, -1e9), -1)
        context = (align[:, None] @ values)[:, 0]
        x = self.rnn_proj(torch.cat([gru_h, context], -1))
        carries = []
        for i, (c_old, h_old) in enumerate((lstm1, lstm2)):
            c_new, h_new = LSTMCell.step(w[f"lstm_{i + 1}"], x, c_old, h_old)
            if zu is None:
                carries.append((c_old * ZONEOUT + c_new * (1 - ZONEOUT),
                                h_old * ZONEOUT + h_new * (1 - ZONEOUT)))
            else:
                mc, mh = torch.floor((1 - ZONEOUT) + zu[i])
                carries.append(((c_new - c_old) * mc + c_old,
                                (h_new - h_old) * mh + h_old))
            x = x + h_new
        return ((gru_h, carries[0], carries[1], context), self.frame_proj(x),
                align)


class Tacotron(nn.Module):
    """GST-Tacotron (see the module docstring), etts' defaults."""

    def __init__(self, vocab_size: int = 149, embed_depth: int = 256,
                 attention_depth: int = 256, rnn_depth: int = 256,
                 num_mels: int = 80, num_freq: int = 1025,
                 outputs_per_step: int = 2,
                 prenet_depths: Sequence[int] = (256, 128),
                 use_gst: bool = True, num_gst: int = 10, num_heads: int = 4,
                 style_embed_depth: int = 256, style_att_dim: int = 128,
                 style_att_type: str = "mlp_attention",
                 reference_filters: Sequence[int] = (32, 32, 64, 64, 128,
                                                     128),
                 reference_depth: int = 128, ref_proj_dim: int = 128,
                 cbhg_width: int = 128, max_iters: int = 1000):
        super().__init__()
        self.num_mels, self.r = num_mels, outputs_per_step
        self.prenet_depths = tuple(prenet_depths)
        self.use_gst = use_gst
        self.num_gst, self.num_heads = num_gst, num_heads
        self.attention_depth, self.rnn_depth = attention_depth, rnn_depth
        self.max_iters = max_iters
        w = cbhg_width
        self.text_embedding = nn.Embedding(vocab_size, embed_depth)
        self.encoder_prenet = TacoPrenet(embed_depth, prenet_depths)
        self.encoder_cbhg = CBHG(self.prenet_depths[-1], 16, (w, w), w)
        self.post_cbhg = CBHG(num_mels, 8, (2 * w, num_mels), w)
        self.linear_proj = nn.Linear(2 * w, num_freq)
        self.ref_encoder = TacoReferenceEncoder(num_mels, reference_filters,
                                                reference_depth, ref_proj_dim)
        style_dim = ref_proj_dim
        if use_gst:
            token_dim = style_embed_depth // num_heads
            self.style_tokens = nn.Parameter(torch.zeros(num_gst, token_dim))
            self.style_attention = StyleAttention(
                ref_proj_dim, token_dim, num_heads, style_att_dim,
                style_att_type)
            style_dim = num_heads * token_dim
        enc_dim = 2 * w + style_dim
        self.decoder_cell = TacotronDecoderCell(
            num_mels, enc_dim, attention_depth, rnn_depth, outputs_per_step,
            prenet_depths)
        self.memory_proj = nn.Linear(enc_dim, attention_depth, bias=False)

    def draw_uniforms(self, b: int, n: int, max_iters: int | None = None,
                      seed: int = 0, device="cpu",
                      zoneout: bool = False) -> dict:
        """Every uniform one ``generate`` of b texts of n ids reads, drawn in
        one call from a CPU generator seeded by ``seed`` and copied to
        ``device`` once: {"encoder_prenet": (b, n, P), "style": (num_heads,
        num_gst), the random style's weights before their softmax,
        "decoder_prenet": (max_iters, b, P)}, P = sum(prenet_depths); with
        ``zoneout``, those of a training ``forward`` of max_iters decoder
        steps: also "zoneout": (max_iters, 2 LSTMs, (c, h), b,
        rnn_depth), drawn after the others. In a data-parallel step b is
        the rank's rows, and each draw is their part of the global batch's
        (``parallel.collectives``)."""
        rank, world = collectives.rows()
        p, steps = sum(self.prenet_depths), max_iters or self.max_iters
        g = b * world
        shapes = {"encoder_prenet": (g, n, p),
                  "style": (self.num_heads, self.num_gst),
                  "decoder_prenet": (steps, g, p)}
        if zoneout:
            shapes["zoneout"] = (steps, 2, 2, g, self.rnn_depth)
        sizes = [math.prod(s) for s in shapes.values()]
        flat = torch.rand(sum(sizes),
                          generator=torch.Generator().manual_seed(seed))
        flat = flat.to(device)
        out = {k: part.view(s) for (k, s), part in
               zip(shapes.items(), flat.split(sizes))}
        if world > 1:
            batch_dim = {"encoder_prenet": 0, "decoder_prenet": 1,
                         "zoneout": 3}
            out.update({k: out[k].narrow(d, rank * b, b)
                        for k, d in batch_dim.items() if k in out})
        return out

    def encode(self, inputs, reference_mel, uniforms: dict,
               train: bool = False):
        """ids (b, n), reference mel (b, t, num_mels) or None, uniforms
        (``draw_uniforms``'s layout) -> (encoder output
        (b, n, 2 * cbhg_width + style width), style (b, 1, style width),
        reference embedding (b, ref_proj_dim) or None) (`tacotron.py:329-352`).
        Without a reference the style is a softmax of ``uniforms["style"]``
        over the tanh'd tokens, one mix per head. ``train``: BatchNorm on
        batch statistics."""
        b, n = inputs.shape
        pre = self.encoder_prenet(self.text_embedding(inputs),
                                  uniforms["encoder_prenet"])
        enc = self.encoder_cbhg(pre, train)
        ref = None
        if reference_mel is not None:
            ref = self.ref_encoder(reference_mel, train)
            style = ref[:, None]
            if self.use_gst:
                tokens = torch.tanh(self.style_tokens)[None].expand(b, -1, -1)
                style = self.style_attention(style, tokens)
        elif self.use_gst:
            rw = torch.softmax(uniforms["style"], -1)
            style = (rw @ torch.tanh(self.style_tokens)).reshape(1, 1, -1)
            style = style.expand(b, -1, -1)
        else:
            raise ValueError("a Tacotron without style tokens needs a "
                             "reference mel")
        return torch.cat([enc, style.expand(-1, n, -1)], -1), style, ref

    def ref_encode(self, mel):
        return self.ref_encoder(mel)

    def _memory(self, enc_out, input_lengths):
        """(keys, encoder mask, the decoder's zero carry)."""
        b, n = enc_out.shape[:2]
        enc_mask = (torch.arange(n, device=enc_out.device)[None]
                    < input_lengths[:, None])
        zeros = lambda d: enc_out.new_zeros(b, d)
        rd = self.rnn_depth
        carry = (zeros(self.attention_depth), (zeros(rd), zeros(rd)),
                 (zeros(rd), zeros(rd)), zeros(enc_out.shape[-1]))
        return self.memory_proj(enc_out), enc_mask, carry

    def forward(self, inputs, input_lengths, mel_targets, uniforms: dict,
                reference_mel=None, train: bool = True) -> dict:
        """The teacher-forced graph (`tacotron.py:382-402`): ids (b, n),
        lengths (b,), target mels (b, t, num_mels), t a multiple of r;
        the style from ``reference_mel``, else from the targets. Decoder
        step k is fed the target frame k * r - 1 (a zero GO frame at step
        0); then the post CBHG, the linear head, and the reference encoder
        again on the predicted mel. ``uniforms``: ``draw_uniforms(b, n, t
        // r, ..., zoneout=train)``'s layout. ``train``: BatchNorm on
        batch statistics (the running ones moved) and zoneout's masks;
        else the running statistics and the inference mix (GTA). -> {
        "mel_outputs" (b, t, num_mels), "linear_outputs" (b, t,
        num_freq), "alignments" (b, t // r, n), "style_embeddings",
        "refnet_outputs" (the reference's embedding), "refnet_outputs2"
        (the prediction's)}."""
        if reference_mel is None:
            reference_mel = mel_targets
        enc_out, style, ref1 = self.encode(inputs, reference_mel, uniforms,
                                           train)
        b, r = inputs.shape[0], self.r
        tf_inputs = mel_targets[:, r - 1::r].transpose(0, 1)
        dec_in = torch.cat([tf_inputs.new_zeros(1, b, self.num_mels),
                            tf_inputs[:-1]])
        # the prenet reads no carry: every step's at once
        pre = self.decoder_cell.decoder_prenet(dec_in,
                                               uniforms["decoder_prenet"])
        keys, enc_mask, carry = self._memory(enc_out, input_lengths)
        cell = self.decoder_cell
        w = cell.stacked()
        frames, aligns = [], []
        for k in range(dec_in.shape[0]):
            carry, frame, align = cell.step(
                carry, pre[k], keys, enc_out, enc_mask, w,
                uniforms["zoneout"][k] if train else None)
            frames.append(frame)
            aligns.append(align)
        mel = torch.stack(frames, 1).reshape(b, -1, self.num_mels)
        return {"mel_outputs": mel,
                "linear_outputs": self.linear_proj(
                    self.post_cbhg(mel, train)),
                "alignments": torch.stack(aligns, 1),
                "style_embeddings": style, "refnet_outputs": ref1,
                "refnet_outputs2": self.ref_encoder(mel, train)}

    @torch.no_grad()
    def generate(self, inputs, input_lengths, reference_mel=None,
                 max_iters: int | None = None, seed: int = 0,
                 uniforms: dict | None = None) -> dict:
        """Free-running decode of ``max_iters`` steps, each fed the last
        frame of the one before (`tacotron.py:404-442`), then the post CBHG
        and the linear head. The finished flag stays on the device: the
        loop reads nothing back. ``uniforms`` (``draw_uniforms``'s layout)
        default to ``draw_uniforms(..., seed)``. -> {"mel_outputs" (b,
        max_iters * r, num_mels), "linear_outputs" (b, max_iters * r,
        num_freq), "alignments" (b, max_iters, n), "style_embeddings"}."""
        max_iters = max_iters or self.max_iters
        b, n = inputs.shape
        if uniforms is None:
            uniforms = self.draw_uniforms(b, n, max_iters, seed,
                                          inputs.device)
        enc_out, style, _ = self.encode(inputs, reference_mel, uniforms)
        keys, enc_mask, carry = self._memory(enc_out, input_lengths)
        cell = self.decoder_cell
        w = cell.stacked()
        prev = enc_out.new_zeros(b, self.num_mels)
        finished = torch.zeros(b, dtype=torch.bool, device=inputs.device)
        frames = enc_out.new_empty(max_iters, b, self.num_mels * self.r)
        aligns = enc_out.new_empty(max_iters, b, n)
        for t in range(max_iters):
            carry, frame, align = cell(carry, prev, keys, enc_out, enc_mask,
                                       uniforms["decoder_prenet"][t], w)
            aligns[t] = align
            done = (frame.abs() < STOP_LEVEL).all(-1) | finished
            frames[t] = frame.masked_fill(finished[:, None], 0.0)
            prev = frames[t, :, -self.num_mels:]
            finished = done
        mel = frames.transpose(0, 1).reshape(b, -1, self.num_mels)
        return {"mel_outputs": mel,
                "linear_outputs": self.linear_proj(self.post_cbhg(mel)),
                "alignments": aligns.transpose(0, 1),
                "style_embeddings": style}


def tacotron_loss(out: dict, mel_targets, linear_targets):
    """(mel L1 + linear L1 + the two reference embeddings' L1, {"mel_loss",
    "linear_loss", "ref_enc_loss"}), every mean over all elements, padding
    included (`tacotron.py:172-180`)."""
    parts = {"mel_loss": (mel_targets - out["mel_outputs"]).abs().mean(),
             "linear_loss": (linear_targets
                             - out["linear_outputs"]).abs().mean(),
             "ref_enc_loss": (out["refnet_outputs"]
                              - out["refnet_outputs2"]).abs().mean()}
    return (parts["mel_loss"] + parts["linear_loss"]
            + parts["ref_enc_loss"]), parts


def noam_learning_rate(init_lr: float, step: int) -> float:
    """Noam's rate at update ``step`` (from 0; `tacotron.py:206-210`):
    ``init_lr * w^0.5 * min((step + 1) * w^-1.5, (step + 1)^-0.5)``, w =
    WARMUP, with etts' float32 arithmetic: the constants in float64,
    rounded once to float32, each product and the power in float32."""
    f = np.float32
    s = f(f(step) + f(1.0))
    return float(f(f(init_lr * WARMUP ** 0.5)
                   * min(f(s * f(WARMUP ** -1.5)), s ** f(-0.5))))
