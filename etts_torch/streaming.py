"""Streamed synthesis (port of ``etts/streaming.py``): the AR decode runs in
chunks of steps (``make_chunk_decoder``) and the WaveRNN sample loop carries
its state across chunks, so audio comes out while the mel is still being
decoded.

Both chunked paths equal their one-shot counterparts: the chunked decode is
``autoregressive_predict`` split at chunk boundaries (the same calls and
draws), and the chunked vocode is ``generate(batched=False)`` before its
fade-out. Each vocoder chunk is upsampled with ``pad`` frames of real
context on both sides, which covers the MelResNet's 2 * pad + 1 frame
window and the smoothing convs' halo, so its conditioning equals the whole
utterance's over the samples it covers; the sample loop's draws are indexed
by the global step, on the card as on the CPU.

Not ported: etts' LRU caches of jitted programs (``_decoder_cache``,
``_fn_cache``), whose only purpose is to bound XLA compiles; PyTorch
compiles nothing per shape.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .models.autoregressive import (AutoregressiveTransformer,
                                    make_chunk_decoder, streaming_decode_init)
from .models.wavernn import (WaveRNN, _clamp_mels, _conditioning_streams,
                             _default_weights)
from .ops.kernels.wavernn_cell import init_state, wavernn_sample_loop
from .ops.normalizers import mu_law_decode, vocoder_mel

__all__ = ["stream_mel", "stream_vocode", "stream_synthesize"]


@torch.no_grad()
def stream_mel(model: AutoregressiveTransformer, inputs, ref_mel=None,
               spk_embed=None, *, chunk: int = 40, r: int = 1,
               max_length: int = 1000, prenet_dropout: float = 0.5,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[np.ndarray]:
    """Yield mel chunks of at most chunk * r frames, (t_i, n_mels) numpy,
    for one utterance (b = 1), in total the frames ``autoregressive_predict``
    keeps (`etts/streaming.py:36-100`). Inputs as
    ``autoregressive_predict``'s; the runaway guards are not applied, as in
    etts.

    Each chunk is yielded as soon as it is decoded, the chunk that holds
    the stop trimmed to the stopped length, and the stream ends there.
    etts reads each chunk's stop flags one chunk late, so that the read
    overlaps the next chunk's device work, and decodes one chunk past the
    stop; here the decode reads the flags on the host at every step anyway
    (``make_chunk_decoder``), so the lag would only delay every chunk by
    one chunk's decode. The frames are the same. A bf16 model's chunks
    hold its bf16 values, as float32."""
    for mel in _mel_chunks(model, inputs, ref_mel, spk_embed, chunk=chunk,
                           r=r, max_length=max_length,
                           prenet_dropout=prenet_dropout,
                           generator=generator):
        yield mel.float().cpu().numpy()


def _mel_chunks(model, inputs, ref_mel, spk_embed, *, chunk, r, max_length,
                prenet_dropout, generator) -> Iterator[torch.Tensor]:
    """``stream_mel``'s chunks as tensors on the device, in the model's
    compute dtype."""
    state = streaming_decode_init(model, inputs, ref_mel, spk_embed, r=r,
                                  max_length=max_length, generator=generator)
    dec = make_chunk_decoder(model, chunk=chunk, r=r,
                             prenet_dropout=prenet_dropout)
    max_steps = state["max_steps"]
    while state["i"] < max_steps and not bool(state["stopped"].all()):
        start = state["i"] * r
        state, out = dec(state)
        end = (int(state["lengths"][0]) if bool(state["stopped"].all())
               else min(state["i"], max_steps) * r)
        yield out[0, :end - start]


def _chunk_contexts(mel_chunks, chunk_frames: int, pad: int, n_mels: int,
                    device) -> Iterator[tuple]:
    """Cut a stream of vocoder mels (t_i, n_mels) into vocoder chunks:
    yields (context (pad + chunk_frames + pad, n_mels), frames to keep).
    Every mel is clamped to the vocoder's [0, 1] contract on entry. The left
    pad of the first chunk is zeros, as ``generate``'s. The tail is
    zero-padded to the interior chunk's shape, which also gives the zero
    right pad of ``generate``, and its kept frames are the real ones, so
    every chunk's conditioning is computed at one shape."""
    left = torch.zeros(pad, n_mels, device=device)
    pending = torch.zeros(0, n_mels, device=device)
    for mel in mel_chunks:
        mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
        pending = torch.cat([pending, _clamp_mels(mel)])
        while pending.shape[0] >= chunk_frames + pad:
            yield torch.cat([left, pending[:chunk_frames + pad]]), chunk_frames
            left = pending[chunk_frames - pad:chunk_frames]
            pending = pending[chunk_frames:]
    n_total, emitted = pending.shape[0], 0
    while emitted < n_total:
        short = chunk_frames + pad - pending.shape[0]
        if short > 0:
            pending = torch.cat([pending,
                                 torch.zeros(short, n_mels, device=device)])
        yield (torch.cat([left, pending[:chunk_frames + pad]]),
               min(chunk_frames, n_total - emitted))
        left = pending[chunk_frames - pad:chunk_frames]
        pending = pending[chunk_frames:]
        emitted += chunk_frames


def _chunk_cond(model: WaveRNN, ctx):
    """One chunk's context (pad + n + pad, n_mels) -> its sample-loop
    conditioning (n * hop, 1, feat + 4 * adim)."""
    mels_up, aux = model.upsample(ctx[None])
    return _conditioning_streams(mels_up, aux)


def _vocode_chunk(model: WaveRNN, ctx, n: int, weights, weight_dtype,
                  seed: int, state: dict):
    """One chunk of the stream (`etts/streaming.py:103-143`): upsample the
    context and run the sample loop from ``state`` over the samples of its
    first ``n`` frames -> (samples (n * hop,), state). For the flushed tail
    that skips the zero-padded frames' sample steps, which etts runs and
    drops; the kept samples are the same, the loop being causal."""
    cond = _chunk_cond(model, ctx)[:n * model.hop_length]
    samples, state = wavernn_sample_loop(
        cond, weights, mode=model.mode, n_classes=model.n_classes, seed=seed,
        state=state, weight_dtype=weight_dtype)
    return samples[:, 0], state


@torch.no_grad()
def stream_vocode(model: WaveRNN, mel_chunks, *, chunk_frames: int = 40,
                  mu_law: bool = True, seed: int = 0, int8_weights=False,
                  weights=None) -> Iterator[np.ndarray]:
    """Consume vocoder mels (t_i, n_mels) in [0, 1] and yield waveform
    chunks of chunk_frames * hop samples, numpy (the last shorter)
    (`etts/streaming.py:157-238`). The GRU state, the fed-back sample and
    the global step carry across chunks, with one ``seed`` for the stream:
    the output equals ``generate(batched=False)`` before its fade-out.

    Any truthy ``int8_weights``, "mxu" included, runs the "int8" sample
    loop, as etts' stream does. Unlike etts' lax.scan path, which ignores
    the flag, the CPU runs int8 through its plain version, as the port's
    ``generate`` does. ``weights``: the prepared weights of that mode
    (``VocoderSynthesizer``'s), built from the model when omitted. Mu-law
    decoding applies to RAW only."""
    pad = model.pad
    if chunk_frames < pad:
        raise ValueError(
            f"chunk_frames ({chunk_frames}) must be >= model.pad ({pad})")
    mu_law = mu_law and model.mode == "RAW"
    weight_dtype = "int8" if int8_weights else None
    if weights is None:
        weights = _default_weights(model, weight_dtype)
    device = model.I.weight.device
    state = init_state(1, model.rnn_dims, device)
    for ctx, n in _chunk_contexts(mel_chunks, chunk_frames, pad,
                                  model.feat_dims, device):
        wav, state = _vocode_chunk(model, ctx, n, weights, weight_dtype,
                                   seed, state)
        if mu_law:
            wav = mu_law_decode(wav, model.n_classes, from_labels=False)
        yield wav.cpu().numpy()


def stream_synthesize(tts_model: AutoregressiveTransformer,
                      voc_model: WaveRNN, inputs, ref_mel=None,
                      spk_embed=None, *, r: int = 1, max_length: int = 1000,
                      mel_chunk: int = 40, prenet_dropout: float = 0.5,
                      mu_law: bool = True,
                      int8_weights=False, seed: int = 0, voc_weights=None
                      ) -> Iterator[np.ndarray]:
    """Text ids (1, n) -> streamed waveform chunks of mel_chunk * r * hop
    samples (`etts/streaming.py:241-263`). The decode's dropout draws from a
    generator seeded with ``seed`` on the inputs' device, the vocoder's
    sample loop from ``seed + 1`` (etts splits one key in two). Between the
    stages the TTS mels in [-4, 4] become the vocoder's (mel + 4) / 8,
    computed on the device in the mel's dtype (bf16 for a bf16 model, as
    etts computes it)."""
    gen = torch.Generator(inputs.device).manual_seed(seed)
    mels = _mel_chunks(tts_model, inputs, ref_mel, spk_embed,
                       chunk=mel_chunk, r=r, max_length=max_length,
                       prenet_dropout=prenet_dropout, generator=gen)
    yield from stream_vocode(voc_model, (vocoder_mel(m, m.dtype)
                                         for m in mels),
                             chunk_frames=mel_chunk * r, mu_law=mu_law,
                             seed=seed + 1, int8_weights=int8_weights,
                             weights=voc_weights)
