"""AutoregressiveTransformer inference (port of
``etts/models/autoregressive.py``): ``encode`` with the four conditioning
modes, ``decode_step`` with per-block KV caches and precomputed
cross-attention K/V, and the greedy ``autoregressive_predict`` with the
stop-on-any-of-r-frames rule and the two runaway guards.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.masking import encoder_padding_mask, mel_padding_mask
from .layers import (CrossAttentionBlocks, DecoderPrenet, Postnet,
                     ReferenceEncoderGST, SelfAttentionBlocks)

SYSTEM_TYPES = ("text", "style_text", "speaker_text", "speaker_style_text")


class AutoregressiveTransformer(nn.Module):
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
                 encoder_feed_forward_dimension: int = 1024,
                 decoder_feed_forward_dimension: int = 1024,
                 max_r: int = 10):
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

        self.TextEmbedding = nn.Embedding(vocab_size, encoder_prenet_dimension)
        self.TextEncoder = SelfAttentionBlocks(
            encoder_model_dimension, encoder_feed_forward_dimension,
            encoder_num_heads, encoder_maximum_position_encoding,
            encoder_dense_blocks)
        enc_dim = encoder_model_dimension
        if self.has_style:
            self.RefEncoderGST = ReferenceEncoderGST(
                mel_channels, ref_encoder_kernel_size, ref_encoder_strides,
                ref_encoder_filters, ref_encoder_gru_cell_units,
                gst_style_embed_dim, gst_multi_num_heads, gst_heads)
            enc_dim += gst_style_embed_dim
        if self.has_speaker:
            enc_dim += speaker_embed_dim
        self.DecoderPrenet = DecoderPrenet(
            mel_channels, decoder_prenet_dimension, decoder_model_dimension)
        self.Decoder = CrossAttentionBlocks(
            decoder_model_dimension, decoder_feed_forward_dimension,
            decoder_num_heads, decoder_maximum_position_encoding,
            decoder_dense_blocks, enc_dim)
        self.FinalProj = nn.Linear(decoder_model_dimension,
                                   mel_channels * max_r)
        self.Postnet = Postnet(mel_channels, postnet_conv_filters,
                               postnet_conv_layers, postnet_kernel_size)

    @property
    def has_style(self) -> bool:
        return self.system_type in ("style_text", "speaker_style_text")

    @property
    def has_speaker(self) -> bool:
        return self.system_type in ("speaker_text", "speaker_style_text")

    def encode(self, inputs, ref_mel=None, spk_embed=None):
        """Text encoding concatenated with the tiled GST and/or speaker
        embeddings (`autoregressive.py:142-172`). Returns (enc_output,
        cross_mask); the cross mask is recomputed from the dense encoder
        output, so it is effectively all zeros (reference quirk)."""
        x = self.TextEmbedding(inputs)
        parts = [self.TextEncoder(x, encoder_padding_mask(inputs))]
        n = inputs.shape[1]
        if self.has_style:
            parts.append(self.RefEncoderGST(ref_mel).expand(-1, n, -1))
        if self.has_speaker:
            parts.append(spk_embed.expand(-1, n, -1))
        enc = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return enc, mel_padding_mask(enc)

    @staticmethod
    def encode_ref(ref_mel, r: int):
        """Reference-mel conditioning input: trim the last frame, r-stride."""
        tar = ref_mel[None] if ref_mel.ndim == 2 else ref_mel
        return tar[:, :-1][:, 0::r, :]

    def cross_kv(self, enc_output):
        """Every decoder block's cross-attention K/V, head-split
        (b, h, n_enc, depth); static during decode."""
        out = []
        for block in self.Decoder.blocks():
            mha = block.carn.mha
            out.append((mha.split(mha.wk(enc_output)),
                        mha.split(mha.wv(enc_output))))
        return out

    def init_caches(self, enc_output, max_steps: int):
        b = enc_output.shape[0]
        d = self.decoder_model_dimension
        caches = []
        for h, (ck, cv) in zip(self.decoder_num_heads,
                               self.cross_kv(enc_output)):
            z = enc_output.new_zeros(b, h, max_steps, d // h)
            caches.append({"k": z, "v": z.clone(), "ck": ck, "cv": cv})
        return caches

    def decode_step(self, new_frame, enc_output, cross_mask, caches,
                    index: int, r: int = 1, prenet_dropout: float = 0.5,
                    generator=None):
        """One incremental step: new_frame (b, 1, mel) -> (mel_linear
        (b, r, mel), last block's cross-attention (b, h, 1, n_enc)).
        The caches are updated in place."""
        x = self.DecoderPrenet(new_frame, prenet_dropout, generator=generator)
        x, w = self.Decoder.step(x, enc_output, cross_mask, caches, index, r)
        mel = self.FinalProj(x)[:, :, :r * self.mel_channels]
        return mel.reshape(mel.shape[0], r, self.mel_channels), w


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
    'mel_length', 'steps'}."""
    b = inputs.shape[0]
    dev = inputs.device
    max_steps = int(max_length) // r + 1
    n_real = (inputs != 0).sum(1)
    mel_ch = model.mel_channels
    W = model.postnet_conv_layers * (model.postnet_kernel_size - 1) + r

    enc, cross_mask = model.encode(inputs, ref_mel, spk_embed)
    caches = model.init_caches(enc, max_steps)
    lin_buf = enc.new_zeros(b, W + max_steps * r, mel_ch)
    out_buf = enc.new_zeros(b, max_steps * r, mel_ch)
    last = enc.new_full((b, 1, mel_ch), model.mel_start_value)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.zeros(b, dtype=torch.long, device=dev)
    attn_ctr = torch.zeros(b, dtype=torch.long, device=dev)
    cap = None
    if max_frames_per_token is not None:
        cap = torch.clamp((n_real.float() * max_frames_per_token).long(), min=r)
    i = 0
    while i < max_steps and not bool(stopped.all()):
        mel_r, cross_attn = model.decode_step(
            last, enc, cross_mask, caches, i, r, prenet_dropout, generator)
        lin_buf[:, W + i * r:W + (i + 1) * r] = mel_r
        post = model.Postnet(lin_buf[:, i * r + r:i * r + r + W])
        final_r = post["final_output"][:, -r:]
        out_buf[:, i * r:(i + 1) * r] = final_r
        if stop_enabled:
            hit = post["stop_prob"][:, -r:].argmax(-1) == model.stop_prob_index
        else:
            hit = torch.zeros(b, r, dtype=torch.bool, device=dev)
        hit_any = hit.any(-1)
        group_len = torch.where(hit_any, hit.long().argmax(-1) + 1,
                                torch.full_like(lengths, r))
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
            "mel_length": int(lengths.max()), "steps": i}
