"""AutoregressiveTransformer (port of ``etts/models/autoregressive.py``):
``encode`` with the four conditioning modes and the optional prosody
statistics, the teacher-forced ``forward`` / ``decode`` that training runs,
``decode_step`` with per-block KV caches, precomputed cross-attention K/V
and the conv blocks' rolling input windows, and the greedy
``autoregressive_predict`` with the stop-on-any-of-r-frames rule and the
two runaway guards.

``dtype`` is the compute dtype (``layers.set_compute_dtype``): bfloat16 is
etts' mixed precision on float32 parameters, and the decode keeps its KV
caches, postnet window, feedback frame and output buffer in it, as etts'
do, so a bf16 model returns a bf16 mel. The decode's cross-attention K/V
are the plain float32 projection of the encoder output, as etts'
``_cross_attention_kv`` computes them outside the module.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masking import (encoder_padding_mask, look_ahead_mask,
                           mel_padding_mask)
from ..parallel import collectives
from .layers import (Compute, CrossAttentionBlocks, Dense, DecoderPrenet,
                     Embedding, Postnet, ProsodyStatEncoder,
                     ReferenceEncoderGST, SelfAttentionBlocks,
                     set_compute_dtype)

SYSTEM_TYPES = ("text", "style_text", "speaker_text", "speaker_style_text")


class AutoregressiveTransformer(Compute, nn.Module):
    stop_prob_index = 2          # the stop class of the 3-class stop head

    def __init__(self, system_type: str = "speaker_style_text",
                 encoder_model_dimension: int = 256,
                 decoder_model_dimension: int = 256,
                 encoder_num_heads: Sequence[int] = (4, 4, 4, 4),
                 decoder_num_heads: Sequence[int] = (4, 4, 4, 4),
                 encoder_maximum_position_encoding: int = 1000,
                 decoder_maximum_position_encoding: int = 10000,
                 encoder_dense_blocks: int = 4, decoder_dense_blocks: int = 4,
                 encoder_prenet_dimension: int = 256,
                 decoder_prenet_dimension: int = 256,
                 postnet_conv_filters: int = 256, postnet_conv_layers: int = 5,
                 postnet_kernel_size: int = 5,
                 mel_start_value: float = 0.5, mel_channels: int = 80,
                 vocab_size: int = 128,
                 ref_encoder_filters: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 ref_encoder_kernel_size: int = 3, ref_encoder_strides: int = 2,
                 ref_encoder_gru_cell_units: int = 128,
                 gst_style_embed_dim: int = 256, gst_multi_num_heads: int = 4,
                 gst_heads: int = 10, speaker_embed_dim: int = 256,
                 encoder_attention_conv_filters: int = 256,
                 decoder_attention_conv_filters: int = 256,
                 encoder_attention_conv_kernel: int = 3,
                 decoder_attention_conv_kernel: int = 3,
                 encoder_feed_forward_dimension: int = 1024,
                 decoder_feed_forward_dimension: int = 1024,
                 max_r: int = 10, use_prosody_stats: bool = False,
                 prosody_embed_dim: int = 32, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        if system_type not in SYSTEM_TYPES:
            raise ValueError(f"system_type must be one of {SYSTEM_TYPES}")
        if encoder_prenet_dimension != encoder_model_dimension:
            raise ValueError("the text embedding width must equal the "
                             "encoder model dimension")
        self.system_type = system_type
        self.mel_channels = mel_channels
        self.mel_start_value = mel_start_value
        self.decoder_model_dimension = decoder_model_dimension
        self.decoder_num_heads = tuple(decoder_num_heads)
        self.decoder_dense_blocks = decoder_dense_blocks
        self.postnet_conv_layers = postnet_conv_layers
        self.postnet_kernel_size = postnet_kernel_size
        self.max_r = max_r
        self.use_prosody_stats = use_prosody_stats

        self.TextEmbedding = Embedding(vocab_size, encoder_prenet_dimension)
        self.TextEncoder = SelfAttentionBlocks(
            encoder_model_dimension, encoder_feed_forward_dimension,
            encoder_num_heads, encoder_maximum_position_encoding,
            encoder_dense_blocks, encoder_attention_conv_filters,
            encoder_attention_conv_kernel, dropout_rate=dropout_rate)
        enc_dim = encoder_model_dimension
        if self.has_style:
            self.RefEncoderGST = ReferenceEncoderGST(
                mel_channels, ref_encoder_kernel_size, ref_encoder_strides,
                ref_encoder_filters, ref_encoder_gru_cell_units,
                gst_style_embed_dim, gst_multi_num_heads, gst_heads)
            enc_dim += gst_style_embed_dim
            if use_prosody_stats:
                self.ProsodyStats = ProsodyStatEncoder(prosody_embed_dim)
                enc_dim += prosody_embed_dim
        if self.has_speaker:
            enc_dim += speaker_embed_dim
        self.DecoderPrenet = DecoderPrenet(
            mel_channels, decoder_prenet_dimension, decoder_model_dimension)
        self.Decoder = CrossAttentionBlocks(
            decoder_model_dimension, decoder_feed_forward_dimension,
            decoder_num_heads, decoder_maximum_position_encoding,
            decoder_dense_blocks, enc_dim, decoder_attention_conv_filters,
            decoder_attention_conv_kernel, dropout_rate=dropout_rate)
        self.FinalProj = Dense(decoder_model_dimension, mel_channels * max_r)
        self.Postnet = Postnet(mel_channels, postnet_conv_filters,
                               postnet_conv_layers, postnet_kernel_size)
        set_compute_dtype(self, dtype)

    @property
    def has_style(self) -> bool:
        return self.system_type in ("style_text", "speaker_style_text")

    @property
    def has_speaker(self) -> bool:
        return self.system_type in ("speaker_text", "speaker_style_text")

    def encode(self, inputs, ref_mel=None, spk_embed=None,
               train_text_encoder: bool = False,
               train_style_encoder: bool = False, drop_n_heads: int = 0,
               generator=None):
        """Text encoding concatenated with the tiled GST (and, with
        ``use_prosody_stats``, the reference mel's prosody statistics)
        and/or speaker embeddings (`autoregressive.py:142-172`). Returns the
        tuple of
        etts' ``encode``: (enc_output, cross_mask, text_attn, gst_attn,
        gst_tokens, gst_output, text_enc_output), the three GST entries None
        without a style encoder; the cross mask is recomputed from the dense
        encoder output, so it is effectively all zeros (reference quirk).
        The train flags put the text and the style encoder in train mode."""
        x = self.TextEmbedding(inputs)
        text_enc, text_attn = self.TextEncoder(
            x, encoder_padding_mask(inputs), train_text_encoder,
            drop_n_heads, generator)
        gst_out = gst_attn = gst_tokens = None
        parts = [text_enc]
        n = inputs.shape[1]
        if self.has_style:
            gst_out, gst_attn, gst_tokens = self.encode_style(
                ref_mel, train_style_encoder, drop_n_heads, generator)
            parts.append(gst_out.expand(-1, n, -1))
            if self.use_prosody_stats:
                parts.append(self.ProsodyStats(ref_mel).expand(-1, n, -1))
        if self.has_speaker:
            parts.append(spk_embed.expand(-1, n, -1))
        enc = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return (enc, mel_padding_mask(enc), text_attn, gst_attn, gst_tokens,
                gst_out, text_enc)

    def encode_style(self, targets, train: bool = False,
                     drop_n_heads: int = 0, generator=None):
        """The style encoder alone (`autoregressive.py:174-179`; the
        style-consistency loss re-encodes the predicted mel through it)."""
        return self.RefEncoderGST(targets, train, drop_n_heads, generator)

    def decode(self, encoder_output, targets, encoder_padding_mask_,
               train: bool = False, drop_n_heads: int = 0, r: int = 1,
               prenet_dropout: float = 0.5, generator=None,
               seq_frames: Optional[int] = None):
        """Teacher-forced decode of the r-strided decoder input ``targets``
        (b, T, mel) (`autoregressive.py:181-198`): the prenet, the decoder
        stack under the look-ahead and padding masks combined, FinalProj's
        first r * mel columns reshaped to T * r frames, the postnet.

        ``seq_frames``: in a sequence-parallel step, T, of which
        ``targets`` holds this rank's frames (``collectives.SeqShard``).
        The prenet, the positions, the queries, the FFNs, the norms and
        FinalProj run on those frames (the decoder in a
        ``collectives.time_region``); the self-attention's keys and values,
        the conv blocks and the postnet read the whole sequence, gathered;
        every output holds this rank's frames."""
        seq = collectives.seq_shard() if seq_frames is not None else None
        if seq is None:
            keys, start, stop, total = targets, 0, targets.shape[1], None
        else:
            total = seq_frames
            start, stop = seq.bounds(total)
            keys = seq.gather(targets.detach(), total)
        mask = torch.maximum(
            mel_padding_mask(keys),
            look_ahead_mask(keys.shape[1], targets.device)[start:stop])
        with (collectives.time_region(start, stop, total) if seq is not None
              else contextlib.nullcontext()):
            x = self.DecoderPrenet(targets, prenet_dropout, generator)
            x, attn = self.Decoder(x, encoder_output, mask,
                                   encoder_padding_mask_, r, train,
                                   drop_n_heads, generator)
            mel = self.FinalProj(x)[:, :, :r * self.mel_channels]
        b, t = mel.shape[:2]
        mel = mel.reshape(b, t * r, self.mel_channels)
        if seq is None:
            out = self.Postnet(mel, train)
        else:
            out = {k: seq.local(v, total, per_frame=r) for k, v in
                   self.Postnet(seq.gather(mel, total, per_frame=r),
                                train).items()}
        out.update({"decoder_attention": attn, "decoder_output": x,
                    "linear": mel})
        return out

    def forward(self, inputs, targets, spk_embed=None,
                train_text_encoder: bool = False,
                train_style_encoder: bool = False,
                train_decoder: bool = False, r: int = 1,
                prenet_dropout: float = 0.5, drop_n_heads: int = 0,
                style_targets=None, generator=None,
                seq_frames: Optional[int] = None):
        """Teacher-forced forward (`autoregressive.py:233-259`): ``encode``
        (the style encoders read ``style_targets`` where given, else
        ``targets``), then ``decode``. Returns etts' dict: mel_linear,
        final_output, stop_prob, decoder_attention, decoder_output,
        linear, text_encoder_attention, gst_encoder_attention, gst_tokens,
        gst_output, text_enc_output. Every draw (dropout, HeadDrop, the
        prenet's) comes from ``generator``. ``seq_frames``: ``decode``'s
        (sequence parallelism; the style encoders then need the whole
        sequence as ``style_targets``)."""
        (enc, cross_mask, text_attn, gst_attn, gst_tokens, gst_out,
         text_enc) = self.encode(
            inputs, targets if style_targets is None else style_targets,
            spk_embed, train_text_encoder, train_style_encoder, drop_n_heads,
            generator)
        out = self.decode(enc, targets, cross_mask, train_decoder,
                          drop_n_heads, r, prenet_dropout, generator,
                          seq_frames)
        out.update({"text_encoder_attention": text_attn,
                    "gst_encoder_attention": gst_attn,
                    "gst_tokens": gst_tokens, "gst_output": gst_out,
                    "text_enc_output": text_enc})
        return out

    @staticmethod
    def input_reshape(mel, stop_prob, r: int):
        """Teacher-forcing shift and r-stride (`autoregressive.py:266-275`):
        (tar_real = mel[:, 1:], tar_mel = mel[:, :-1][:, ::r], tar_stop =
        stop_prob[:, 1:], mel_len = the frames of tar_real)."""
        tar_inp = mel[:, :-1]
        return mel[:, 1:], tar_inp[:, 0::r], stop_prob[:, 1:], \
            tar_inp.shape[1]

    @staticmethod
    def encode_ref(ref_mel, r: int):
        """Reference-mel conditioning input: trim the last frame, r-stride."""
        tar = ref_mel[None] if ref_mel.ndim == 2 else ref_mel
        return tar[:, :-1][:, 0::r, :]

    def cross_kv(self, enc_output):
        """Every decoder block's cross-attention K/V, head-split
        (b, h, n_enc, depth); static during decode. The plain projection
        at the parameters' dtype, whatever the compute dtype, as etts'
        ``_cross_attention_kv`` (`autoregressive.py:285-303`)."""
        out = []
        for block in self.Decoder.blocks():
            mha = block.carn.mha
            proj = lambda lin: mha.split(F.linear(
                enc_output.to(lin.weight.dtype), lin.weight, lin.bias))
            out.append((proj(mha.wk), proj(mha.wv)))
        return out

    def init_caches(self, enc_output, max_steps: int):
        """Each decoder block's zero self-attention KV cache (b, h,
        max_steps, depth) and cross-attention K/V; a conv block also gets
        its zero window of 2 * (kernel - 1) past block inputs
        (`autoregressive.py:310-326`)."""
        b = enc_output.shape[0]
        d = self.decoder_model_dimension
        rf = 2 * (self.Decoder.conv_kernel - 1)
        dt = self.state_dtype(enc_output)
        caches = []
        for i, (h, (ck, cv)) in enumerate(zip(self.decoder_num_heads,
                                              self.cross_kv(enc_output))):
            z = enc_output.new_zeros(b, h, max_steps, d // h, dtype=dt)
            caches.append({"k": z, "v": z.clone(), "ck": ck, "cv": cv})
            if i >= self.decoder_dense_blocks:
                caches[-1]["conv"] = enc_output.new_zeros(b, rf, d, dtype=dt)
        return caches

    def state_dtype(self, enc_output) -> torch.dtype:
        """The dtype of the decode's caches and buffers: the compute dtype
        at bf16, else the encoder output's (float32, or a test's
        float64)."""
        return self.dtype if self.low_precision else enc_output.dtype

    def decode_step(self, new_frame, enc_output, cross_mask, caches,
                    index: int, r: int = 1, prenet_dropout: float = 0.5,
                    generator=None):
        """One incremental step: new_frame (b, 1, mel) -> (mel_linear
        (b, r, mel), last block's cross-attention (b, h, 1, n_enc)).
        The caches (each a dict of ``init_caches``) are updated in place."""
        x = self.DecoderPrenet(new_frame, prenet_dropout, generator=generator)
        x, w = self.Decoder.step(x, enc_output, cross_mask, caches, index, r)
        mel = self.FinalProj(x)[:, :, :r * self.mel_channels]
        return mel.reshape(mel.shape[0], r, self.mel_channels), w


def _decode_group(model: AutoregressiveTransformer, last, window, enc,
                  cross_mask, caches, i: int, r: int, prenet_dropout: float,
                  generator, stop_enabled: bool):
    """Step i of the decode, shared by ``autoregressive_predict`` and the
    chunked decode: ``decode_step`` from the feedback frame ``last``, the
    postnet over the W = ctx + r frames ending at the new group (``window``
    holds the W before it), the stop class on each of the r frames. Returns
    (final frames (b, r, mel), the new window, stop hits (b, r), frames up
    to and including the first hit, else r (b,), the last block's
    cross-attention). The caches are updated in place."""
    mel_r, cross_attn = model.decode_step(
        last, enc, cross_mask, caches, i, r, prenet_dropout, generator)
    window = torch.cat([window[:, r:], mel_r], 1)
    post = model.Postnet(window)
    if stop_enabled:
        hit = post["stop_prob"][:, -r:].argmax(-1) == model.stop_prob_index
    else:
        hit = torch.zeros(last.shape[0], r, dtype=torch.bool,
                          device=last.device)
    group_len = torch.where(hit.any(-1), hit.long().argmax(-1) + 1,
                            torch.full_like(hit[:, 0], r, dtype=torch.long))
    return post["final_output"][:, -r:], window, hit, group_len, cross_attn


@torch.no_grad()
def autoregressive_predict(model: AutoregressiveTransformer, inputs,
                           ref_mel=None, spk_embed=None, *, r: int = 1,
                           max_length: int = 1000,
                           prenet_dropout: float = 0.5,
                           stop_enabled: bool = True,
                           attn_stop_patience: Optional[int] = None,
                           max_frames_per_token: Optional[float] = None,
                           generator: Optional[torch.Generator] = None):
    """Greedy AR decode with stop-token early exit
    (`autoregressive.py:329-452`).

    inputs (b, n) ids; ref_mel already r-strided (``encode_ref``); spk_embed
    (b, 1, d). The stop class may fire on any of the r new frames; the
    length counts frames up to and including the first firing one.
    ``attn_stop_patience=N`` also stops once the last block's cross-attention
    focus has sat on the final real token for N steps;
    ``max_frames_per_token=F`` caps each utterance at F frames per real
    token. Returns {'mel' (b, max_steps*r, mel), 'mel_lengths' (b,),
    'mel_length', 'steps', 'text_encoder_attention', 'gst_encoder_attention',
    'gst_tokens'}, the last three from ``encode``."""
    b = inputs.shape[0]
    dev = inputs.device
    max_steps = int(max_length) // r + 1
    n_real = (inputs != 0).sum(1)
    mel_ch = model.mel_channels
    W = model.postnet_conv_layers * (model.postnet_kernel_size - 1) + r

    enc, cross_mask, text_attn, gst_attn, gst_tokens, *_ = model.encode(
        inputs, ref_mel, spk_embed)
    caches = model.init_caches(enc, max_steps)
    dt = model.state_dtype(enc)
    window = enc.new_zeros(b, W, mel_ch, dtype=dt)
    out_buf = enc.new_zeros(b, max_steps * r, mel_ch, dtype=dt)
    last = enc.new_full((b, 1, mel_ch), model.mel_start_value, dtype=dt)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.zeros(b, dtype=torch.long, device=dev)
    attn_ctr = torch.zeros(b, dtype=torch.long, device=dev)
    cap = None
    if max_frames_per_token is not None:
        cap = torch.clamp((n_real.float() * max_frames_per_token).long(), min=r)
    i = 0
    while i < max_steps and not bool(stopped.all()):
        final_r, window, hit, group_len, cross_attn = _decode_group(
            model, last, window, enc, cross_mask, caches, i, r,
            prenet_dropout, generator, stop_enabled)
        out_buf[:, i * r:(i + 1) * r] = final_r
        hit_any = hit.any(-1)
        stop_now = hit_any
        if attn_stop_patience is not None:
            focus = cross_attn.mean(1)[:, -1].argmax(-1)
            complete = focus >= n_real - 2
            attn_ctr = torch.where(complete & ~stopped, attn_ctr + 1,
                                   torch.zeros_like(attn_ctr))
            stop_now = stop_now | (attn_ctr >= attn_stop_patience)
        if cap is not None:
            cap_hit = (i + 1) * r >= cap
            group_len = torch.where(cap_hit & ~hit_any,
                                    torch.clamp(cap - i * r, 1, r), group_len)
            stop_now = stop_now | cap_hit
        lengths = torch.where(stopped, lengths, i * r + group_len)
        stopped = stopped | stop_now
        last = final_r[:, -1:]
        i += 1
    return {"mel": out_buf, "mel_lengths": lengths,
            "mel_length": int(lengths.max()), "steps": i,
            "text_encoder_attention": text_attn,
            "gst_encoder_attention": gst_attn, "gst_tokens": gst_tokens}


# ---------------------------------------------------------------------------
# Streamed (chunked) decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def streaming_decode_init(model: AutoregressiveTransformer, inputs,
                          ref_mel=None, spk_embed=None, *, r: int = 1,
                          max_length: int = 1000,
                          generator: Optional[torch.Generator] = None):
    """Encode once and build the carry of ``make_chunk_decoder``'s
    ``decode_chunk`` (`etts/models/autoregressive.py:459-494`): the encoder
    output and cross mask, the KV caches at max_steps = max_length // r + 1,
    the feedback frame ``last``, the postnet ``window`` (the W = ctx + r
    frames ending at the newest group, zeros before the start), the step
    ``i``, ``stopped`` and ``lengths`` per row, and the prenet dropout's
    ``generator``. Inputs as ``autoregressive_predict``'s."""
    b = inputs.shape[0]
    max_steps = int(max_length) // r + 1
    W = model.postnet_conv_layers * (model.postnet_kernel_size - 1) + r
    enc, cross_mask, *_ = model.encode(inputs, ref_mel, spk_embed)
    dt = model.state_dtype(enc)
    return {"enc": enc, "cross_mask": cross_mask,
            "caches": model.init_caches(enc, max_steps),
            "max_steps": max_steps,
            "last": enc.new_full((b, 1, model.mel_channels),
                                 model.mel_start_value, dtype=dt),
            "window": enc.new_zeros(b, W, model.mel_channels, dtype=dt),
            "i": 0,
            "stopped": torch.zeros(b, dtype=torch.bool, device=enc.device),
            "lengths": torch.zeros(b, dtype=torch.long, device=enc.device),
            "generator": generator}


def make_chunk_decoder(model: AutoregressiveTransformer, *, chunk: int,
                       r: int = 1, prenet_dropout: float = 0.5,
                       stop_enabled: bool = True):
    """``decode_chunk(state) -> (state, mel (b, chunk * r, mel))``: the next
    ``chunk`` steps of ``autoregressive_predict`` from the carry of
    ``streaming_decode_init`` (`etts/models/autoregressive.py:497-562`).

    Each live step is ``autoregressive_predict``'s step (``_decode_group``,
    with the carried generator), so the chunked decode is that decode split
    at chunk boundaries, bit for bit on one device. Every step reads
    ``stopped`` on the host; a step after every row has stopped, or past
    max_steps, only advances ``i`` and leaves its frames zero, as etts'
    ``dead`` branch does. The returned state is a new dict; the KV caches
    inside it are updated in place."""
    @torch.no_grad()
    def decode_chunk(state):
        state = dict(state)
        last = state["last"]
        b, _, mel_ch = last.shape
        out = last.new_zeros(b, chunk * r, mel_ch)
        for k in range(chunk):
            i = state["i"]
            state["i"] = i + 1
            if i >= state["max_steps"] or bool(state["stopped"].all()):
                continue
            final_r, state["window"], hit, group_len, _ = _decode_group(
                model, state["last"], state["window"], state["enc"],
                state["cross_mask"], state["caches"], i, r, prenet_dropout,
                state["generator"], stop_enabled)
            out[:, k * r:(k + 1) * r] = final_r
            state["lengths"] = torch.where(state["stopped"], state["lengths"],
                                           i * r + group_len)
            state["stopped"] = state["stopped"] | hit.any(-1)
            state["last"] = final_r[:, -1:]
        return state, out

    return decode_chunk
