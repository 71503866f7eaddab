"""Plain reference of the GST-TransformerTTS ``speaker_style_text`` model
(`TransformerTTS/model/models.py` of the reference monorepo): the text
encoder, the GST reference encoder (six strided convs with BatchNorm, a
GRU, a tanh projection, attention over the tanh'd token bank), the speaker
vector, and the decoder run teacher-forced over the served frames.

The served decode is greedy: its step i reads the last frame of group
i - 1 (the start frame 0.5 at i = 0) and makes r frames through FinalProj
and the causal postnet. Run once over those fed-back frames, this decoder
gives at every position the frame the model makes from the served
history, which is what the served frame has to equal. The decode runs its
postnet over a window of the last ctx + r frames (ctx = layers x (kernel -
1)) that starts as ctx zero frames, as the JAX package and its port do;
for the first ctx frames that differs from one causal pass over the
utterance, so the reference puts the same ctx zero frames first."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (NO_DROPOUT, batch_norm, cnn_resnorm, dense, encoder_stack,
                     ffn, gru, layer_norm, mha, positional_encoding,
                     self_attention)

GST_BN_EPS = 1e-3


def text_ids(text: str, alphabet: str) -> list:
    """The ids of a text of lowercase letters and spaces: the grapheme
    front end leaves such a text as it is, except g -> U+0261; ids count
    from 1 in the sorted alphabet, with the start and end tokens after
    it."""
    table = {c: i + 1 for i, c in enumerate(alphabet)}
    ids = [table[{"g": "ɡ"}.get(c, c)] for c in text]
    return [len(alphabet) + 1] + ids + [len(alphabet) + 2]


def _same_pad(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def style_embedding(p, c: dict, ref_mel):
    """ref_mel (b, t, n_mels), already trimmed and r-strided ->
    (b, 1, gst_style_embed_dim)."""
    k, s = c["ref_encoder_kernel_size"], c["ref_encoder_strides"]
    x = ref_mel[:, None]
    for i in range(len(c["ref_encoder_filters"])):
        q = p[f"conv_{i}"]
        pt = _same_pad(x.shape[2], k, s)
        pm = _same_pad(x.shape[3], k, s)
        w = q["kernel"].permute(3, 2, 0, 1)
        x = F.conv2d(F.pad(x, pm + pt), w, q["bias"], stride=s)
        x = torch.relu(batch_norm(p[f"bn_{i}"], x, GST_BN_EPS))
    b = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(b, x.shape[2], -1)
    _, h = gru(p["gru_wi"], p["gru_wh"], p["gru_bi"], p["gru_bh"], x)
    ref = torch.tanh(dense(p["rnn_proj"], h))[:, None]
    bank = torch.tanh(p["gst_tokens"])[None].expand(b, -1, -1)
    out, _ = mha(p["mha"], bank, bank, ref, c["gst_multi_num_heads"])
    return out


def encode(p, c: dict, ids, ref_mel, spk):
    """ids (b, n), zero-padded; ref_mel (b, t, n_mels) r-strided; spk (b,
    1, d) -> (encoder output (b, n, enc_dim), cross mask)."""
    x = p["TextEmbedding"]["embedding"][ids]
    mask = (ids == 0).to(x.dtype)[:, None, None, :]
    text = encoder_stack(p["TextEncoder"], x, mask, c["encoder_num_heads"],
                         NO_DROPOUT)
    n = ids.shape[1]
    gst = style_embedding(p["RefEncoderGST"], c, ref_mel)
    enc = torch.cat([text, gst.expand(-1, n, -1), spk.expand(-1, n, -1)], -1)
    cross = (enc.abs().sum(-1) == 0).to(x.dtype)[:, None, None, :]
    return enc, cross


def decode(p, c: dict, enc, cross_mask, inputs, r: int):
    """Teacher-forced decoder over ``inputs`` (b, T, n_mels), the frames
    fed back at steps 0..T-1 -> final frames (b, T * r, n_mels)."""
    q = p["DecoderPrenet"]
    x = torch.relu(dense(q["d2"], torch.relu(dense(q["d1"], inputs))))
    T, d = x.shape[1], x.shape[2]
    pe = torch.as_tensor(positional_encoding(T * r, d)[::r], dtype=x.dtype,
                         device=x.device)
    x = x * math.sqrt(d) + pe
    pad = (inputs.abs().sum(-1) == 0).to(x.dtype)[:, None, None, :]
    ahead = torch.ones(T, T, dtype=x.dtype, device=x.device).triu(1)
    self_mask = torch.maximum(pad, ahead)
    for i, h in enumerate(c["decoder_num_heads"]):
        b = p["Decoder"][f"CADB_{i}"]
        x, _ = self_attention(b["sarn"], x, self_mask, h, NO_DROPOUT)
        a, _ = mha(b["carn"]["mha"], enc, enc, x, h, cross_mask)
        x = layer_norm(b["carn"]["layernorm"], a + x)
        x = ffn(b["ffn"], x, NO_DROPOUT)
    n_mels = c["mel_channels"]
    mel = dense(p["FinalProj"], x)[:, :, :r * n_mels]
    mel = mel.reshape(mel.shape[0], T * r, n_mels)
    # the served decode runs the postnet over a window of the last ctx + r
    # frames that starts as ctx zero frames: the same as a causal pass
    # over the frames behind ctx zero frames
    ctx = c["postnet_conv_layers"] * (c["postnet_kernel_size"] - 1)
    mel = F.pad(mel, (0, 0, ctx, 0))
    post = p["Postnet"]["conv_blocks"]
    return cnn_resnorm(post, mel, c["postnet_conv_layers"],
                       c["postnet_kernel_size"], torch.tanh, lambda y: y,
                       causal=True)[:, ctx:]


def teacher_frames(p, c: dict, ids, ref_mel, spk, served: list, r: int):
    """The frames the model makes from each served history: ids (b, n) as
    the batch padded them, ref_mel (b, t, n_mels) r-strided, spk (b, 1,
    d), ``served`` b arrays (t_i, n_mels). Returns b tensors (t_i,
    n_mels)."""
    dev, dt = enc_device_dtype(p)
    enc, cross = encode(p, c, ids, ref_mel, spk)
    T = max(-(-len(m) // r) for m in served)
    fed = torch.zeros(len(served), T, c["mel_channels"], dtype=dt, device=dev)
    fed[:, 0] = c["mel_start_value"]
    for i, m in enumerate(served):
        m = torch.as_tensor(m, dtype=dt, device=dev)
        steps = -(-len(m) // r)
        fed[i, 1:steps] = m[r - 1:(steps - 1) * r:r]
    ref = decode(p, c, enc, cross, fed, r)
    return [ref[i, :len(m)] for i, m in enumerate(served)]


def greedy(p, c: dict, ids, ref_mel, spk, steps: int, r: int):
    """The model's own greedy decode of ``steps`` steps from the start
    frame, no stop: (b, steps * r, n_mels)."""
    dev, dt = enc_device_dtype(p)
    enc, cross = encode(p, c, ids, ref_mel, spk)
    fed = torch.full((ids.shape[0], 1, c["mel_channels"]),
                     c["mel_start_value"], dtype=dt, device=dev)
    for i in range(steps):
        out = decode(p, c, enc, cross, fed, r)
        if i + 1 < steps:
            fed = torch.cat([fed, out[:, (i + 1) * r - 1:(i + 1) * r]], 1)
    return out


def enc_device_dtype(p):
    x = p["TextEmbedding"]["embedding"]
    return x.device, x.dtype
