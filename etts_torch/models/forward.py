"""ForwardTransformer (port of ``etts/models/forward.py``): the
duration-based acoustic model. Text encoder, duration predictor, length
regulation at a fixed frame capacity (``ops/expand.py``), a self-attention
decoder, Dense(mel) and a ``same``-padded conv postnet, the whole mel in one
pass. Module names follow the flax tree (``embedding``, ``encoder``,
``dur_pred``, ``decoder_prenet``, ``decoder``, ``out``,
``decoder_postnet``), so ``etts_torch.convert`` carries the weights over.
Train mode is the ``train`` argument, as in etts (``models/layers.py``).
``dtype`` is the compute dtype (``layers.set_compute_dtype``); at bf16 the
durations leave the duration predictor in bf16 and are promoted to float32
by the padding mask before they are rounded, as in etts.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.expand import regulate_lengths
from ..ops.masking import encoder_padding_mask, mel_padding_mask
from .layers import (CNNResNorm, Compute, Dense, DecoderPrenet,
                     DurationPredictor, Embedding, SelfAttentionBlocks,
                     set_compute_dtype)


class ForwardTransformer(Compute, nn.Module):
    def __init__(self, encoder_model_dimension: int = 256,
                 decoder_model_dimension: int = 256,
                 decoder_num_heads: Sequence[int] = (4, 4, 4, 4),
                 encoder_num_heads: Sequence[int] = (4, 4, 4, 4),
                 encoder_maximum_position_encoding: int = 1000,
                 decoder_maximum_position_encoding: int = 10000,
                 postnet_conv_filters: int = 256, postnet_conv_layers: int = 5,
                 postnet_kernel_size: int = 5, encoder_dense_blocks: int = 4,
                 decoder_dense_blocks: int = 4, mel_channels: int = 80,
                 vocab_size: int = 128,
                 encoder_attention_conv_filters: int = 256,
                 decoder_attention_conv_filters: int = 256,
                 encoder_attention_conv_kernel: int = 3,
                 decoder_attention_conv_kernel: int = 3,
                 encoder_feed_forward_dimension: int = 1024,
                 decoder_feed_forward_dimension: int = 1024,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.embedding = Embedding(vocab_size, encoder_model_dimension)
        self.encoder = SelfAttentionBlocks(
            encoder_model_dimension, encoder_feed_forward_dimension,
            encoder_num_heads, encoder_maximum_position_encoding,
            encoder_dense_blocks, encoder_attention_conv_filters,
            encoder_attention_conv_kernel, name_prefix="Encoder",
            dropout_rate=dropout_rate)
        self.dur_pred = DurationPredictor(encoder_model_dimension)
        self.decoder_prenet = DecoderPrenet(encoder_model_dimension,
                                            decoder_feed_forward_dimension,
                                            decoder_model_dimension)
        self.decoder = SelfAttentionBlocks(
            decoder_model_dimension, decoder_feed_forward_dimension,
            decoder_num_heads, decoder_maximum_position_encoding,
            decoder_dense_blocks, decoder_attention_conv_filters,
            decoder_attention_conv_kernel, name_prefix="Decoder",
            dropout_rate=dropout_rate)
        self.out = Dense(decoder_model_dimension, mel_channels)
        self.decoder_postnet = CNNResNorm(
            mel_channels, mel_channels, postnet_conv_layers,
            postnet_conv_filters, postnet_kernel_size, "tanh", "linear",
            padding="same")
        set_compute_dtype(self, dtype)

    def forward(self, x, target_durations=None, *, max_frames: int,
                train: bool = False, durations_scalar: float = 1.0,
                drop_n_heads: int = 0, prenet_dropout: float = 0.0,
                generator=None) -> dict:
        """x (b, n) token ids -> {'mel' (b, max_frames, mel), 'duration'
        (b, n, 1) (the predicted durations times ``durations_scalar``, zero
        at padded tokens), 'expanded_mask' (b, 1, 1, max_frames),
        'mel_lengths' (b,), 'encoder_attention', 'decoder_attention'}, as
        `etts/models/forward.py:88-113`. ``target_durations`` (b, n, 1),
        when given, regulate the lengths in place of the predicted ones.
        ``max_frames`` is the fixed output capacity; frames past a row's
        length are zero before the decoder. Under ``train`` the attention
        stacks apply their dropout and drop ``drop_n_heads`` heads, and
        the postnet's BatchNorm runs on the batch's statistics and moves
        the running ones (flax's momentum 0.99); every draw (and the
        prenet's dropout) comes from ``generator``."""
        mode = dict(train=train, drop_n_heads=drop_n_heads,
                    generator=generator)
        padding_mask = encoder_padding_mask(x)
        h, encoder_attention = self.encoder(self.embedding(x), padding_mask,
                                            **mode)
        durations = self.dur_pred(h, train) * durations_scalar
        durations = (1.0 - padding_mask[:, 0, 0, :, None]) * durations
        used = target_durations if target_durations is not None else durations
        mels, total = regulate_lengths(h, used[..., 0], max_frames)
        expanded_mask = mel_padding_mask(mels)
        mels = self.decoder_prenet(mels, prenet_dropout, generator)
        mels, decoder_attention = self.decoder(mels, expanded_mask, **mode)
        mels = self.decoder_postnet(self.out(mels), train)
        return {"mel": mels, "duration": durations,
                "expanded_mask": expanded_mask, "mel_lengths": total,
                "encoder_attention": encoder_attention,
                "decoder_attention": decoder_attention}
