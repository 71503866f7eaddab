"""Operations and bytes of the work, counted from shapes, and the least
time the card could take for them (the roofline).

A multiply-add counts two operations. Each input byte is read once and
each output byte written once, whatever a kernel reads again. Peaks are
the H100 SXM data sheet's (``peaks.json``)."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """max(bytes / the memory peak, operations / the product's peak)."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_ops / peak_ops)


# -- the WaveRNN sample loop (kernel B1) -------------------------------------

def sample_loop_matrices(c: dict) -> int:
    """Weights of the sample path's products: [mel | a1] -> I (the x row
    is a vector), the two GRUs' input and hidden products, fc1, fc2 and
    fc3, each split of a concatenated input its own product."""
    feat, aux = c["mel_channels"], c["voc_res_out_dims"] // 4
    d, fc, n_out = c["voc_rnn_dims"], c["voc_fc_dims"], 30
    return ((feat + aux) * d + d * 3 * d + d * 3 * d + (d + aux) * 3 * d
            + d * 3 * d + (d + aux) * fc + (fc + aux) * fc + fc * n_out)


def sample_loop_vectors(c: dict) -> int:
    d, fc = c["voc_rnn_dims"], c["voc_fc_dims"]
    return d + d + 4 * 3 * d + fc + fc + 30


def sample_loop(c: dict, steps: int, rows: int) -> dict:
    """B1 over ``steps`` steps of ``rows`` fold rows: a multiply-add per
    weight, step and row at the bf16 rate; the bf16 weights, the float32
    vectors, the bf16 conditioning stream read once, one float32 sample a
    step and row written."""
    mats = sample_loop_matrices(c)
    width = c["mel_channels"] + c["voc_res_out_dims"]
    ops = 2.0 * mats * steps * rows
    n_bytes = (2 * mats + 4 * sample_loop_vectors(c)
               + 2 * width * steps * rows + 4 * steps * rows)
    return {"ops": ops, "bytes": n_bytes,
            "bound_s": bound_s(n_bytes, ops, PEAKS["bf16_ops_per_s"])}


# -- the vocoder's conditioning ----------------------------------------------

def conditioning_ops(c: dict, frames: int) -> float:
    """MelResNet and the stretch-and-smooth convs of one utterance of
    ``frames`` mel frames (float32)."""
    pad, feat = c["voc_pad"], c["mel_channels"]
    comp, res = c["voc_compute_dims"], c["voc_res_out_dims"]
    t = frames + 2 * pad
    valid = t - 2 * pad
    ops = 2.0 * valid * (2 * pad + 1) * feat * comp
    ops += 2.0 * valid * c["voc_res_blocks"] * 2 * comp * comp
    ops += 2.0 * valid * comp * res
    length = t
    for s in c["voc_upsample_factors"]:
        length *= s
        ops += 2.0 * length * feat * (2 * s + 1)
    return ops


# -- the autoregressive TTS model ---------------------------------------------

def _attention_block(d: int, q_len: int, kv_len: int, kv_dim: int) -> float:
    """One attention projection set and its attention for q_len queries
    over kv_len keys: q, k, v, the concat-query output projection."""
    return 2.0 * (q_len * d * d + 2 * kv_len * kv_dim * d
                  + q_len * 2 * d * d + 2 * q_len * kv_len * d)


def _ffn(d: int, hidden: int, n: int) -> float:
    return 2.0 * n * 2 * d * hidden


def _conv_stack(c_in, c_out, hidden, layers, k, n) -> float:
    ops, ch = 0.0, c_in
    for _ in range(layers - 1):
        ops += 2.0 * n * k * ch * hidden
        ch = hidden
    return ops + 2.0 * n * k * ch * c_out


def text_encoder_ops(c: dict, n: int, prefix: str = "encoder") -> float:
    d, hidden = (c[f"{prefix}_model_dimension"],
                 c[f"{prefix}_feed_forward_dimension"])
    blocks = len(c[f"{prefix}_num_heads"])
    return blocks * (_attention_block(d, n, n, d) + _ffn(d, hidden, n))


def ar_encode_ops(c: dict, n: int, ref_frames: int) -> float:
    """Encode one text of n ids (the style encoder on the r-strided
    reference, the cross-attention keys and values of every block)."""
    ops = text_encoder_ops(c, n)
    m, ch, t = c["mel_channels"], 1, ref_frames
    k, s = c["ref_encoder_kernel_size"], c["ref_encoder_strides"]
    for f in c["ref_encoder_filters"]:
        t, m = -(-t // s), -(-m // s)
        ops += 2.0 * t * m * k * k * ch * f
        ch = f
    g = c["ref_encoder_gru_cell_units"]
    ops += 2.0 * t * (m * ch * 3 * g + g * 3 * g)
    enc_dim = (c["encoder_model_dimension"] + c["gst_style_embed_dim"]
               + c["speaker_embed_dim"])
    ops += len(c["decoder_num_heads"]) * 2.0 * 2 * n * enc_dim * c[
        "decoder_model_dimension"]
    return ops


def ar_decode_step_ops(c: dict, step: int, n_enc: int, r: int) -> float:
    """Decode step ``step`` of one row: the prenet, every block's self
    attention over step + 1 cached positions (keys and values of the new
    position only), the cross attention over n_enc encoder positions (its
    keys and values precomputed), the FFN, FinalProj's r frames, and the
    postnet and stop head over the r new frames."""
    d, hidden = c["decoder_model_dimension"], c["decoder_feed_forward_dimension"]
    mel, pre = c["mel_channels"], c["decoder_prenet_dimension"]
    ops = 2.0 * (mel * pre + pre * d)
    per_block = (2.0 * (d * d + 2 * d * d + 2 * d * d + 2 * (step + 1) * d)
                 + 2.0 * (d * d + 2 * d * d + 2 * n_enc * d)
                 + _ffn(d, hidden, 1))
    ops += len(c["decoder_num_heads"]) * per_block
    ops += 2.0 * d * mel * r
    ops += _conv_stack(mel, mel, c["postnet_conv_filters"],
                       c["postnet_conv_layers"], c["postnet_kernel_size"], r)
    return ops + 2.0 * r * mel * 3


def ar_decode_ops(c: dict, steps: int, n_enc: int, r: int) -> float:
    return sum(ar_decode_step_ops(c, i, n_enc, r) for i in range(steps))


# -- the forward model's train step -------------------------------------------

def forward_model_ops(c: dict, n: int, frames: int) -> float:
    """One forward pass of the forward model over one utterance of n ids
    and ``frames`` real frames (the padded frames not counted)."""
    d = c["encoder_model_dimension"]
    ops = text_encoder_ops(c, n)
    ops += _conv_stack(d, d, d, 2, 3, n) + 2.0 * n * d
    dd, hidden = c["decoder_model_dimension"], c["decoder_feed_forward_dimension"]
    ops += 2.0 * frames * (d * hidden + hidden * dd)
    ops += text_encoder_ops(c, frames, "decoder")
    mel = c["mel_channels"]
    ops += 2.0 * frames * dd * mel
    ops += _conv_stack(mel, mel, c["postnet_conv_filters"],
                       c["postnet_conv_layers"], c["postnet_kernel_size"],
                       frames)
    return ops


def forward_train_ops(c: dict, n: int, frames: int) -> float:
    """Forward and backward: the backward takes two products for each of
    the forward's (the input's gradient and the weight's)."""
    return 3.0 * forward_model_ops(c, n, frames)
