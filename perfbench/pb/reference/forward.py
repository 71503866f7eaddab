"""Plain reference of the forward (duration) TransformerTTS and its train
step (`TransformerTTS/model/models.py::ForwardTransformer` of the
reference monorepo): the text encoder, the duration predictor (two
same-padded convs with LayerNorm and relu, a relu Dense), the length
regulation by the target durations into a fixed capacity of frames, the
decoder prenet and self-attention decoder, Dense(mel) and the same-padded
BatchNorm postnet (batch statistics in training); the masked mean absolute
errors of the mel (weight 3) and the durations (weight 1), each summed
over the real positions and divided by all positions; Adam(0.9, 0.98,
1e-9).

Training draws dropout: one float32 uniform draw a dropout, at its input's
shape, from one generator a step, in the order of the forward pass (the
encoder's input, then each block's attention and feed-forward, the same for
the decoder). ``TrainReference`` takes that generator's seed a step, as
the benchmark hands it to the program."""
from __future__ import annotations

import torch

from .layers import Dropout, cnn_resnorm, dense, encoder_stack, tree

BN_EPS = 1e-3


def regulate(x, durations, max_frames: int):
    """(b, n, d) repeated by integer durations (b, n), left-packed into
    (b, max_frames, d), zero past each row's total."""
    dur = torch.clamp(torch.round(durations), min=0).long()
    csum = torch.cumsum(dur, 1)
    t = torch.arange(max_frames, device=x.device)
    src = torch.clamp((t[None, :, None] >= csum[:, None, :]).sum(-1),
                      max=x.shape[1] - 1)
    out = torch.gather(x, 1, src[:, :, None].expand(-1, -1, x.shape[2]))
    return out * (t[None, :] < csum[:, -1:]).to(x.dtype)[:, :, None]


def forward(p, c: dict, ids, durations, drop: Dropout, train: bool):
    """-> (mel (b, max_frames, n_mels), predicted durations (b, n, 1))."""
    x = p["embedding"]["embedding"][ids]
    mask = (ids == 0).to(x.dtype)[:, None, None, :]
    h = encoder_stack(p["encoder"], x, mask, c["encoder_num_heads"], drop)
    q = p["dur_pred"]
    y = cnn_resnorm(q["conv_blocks"], h, 2, 3, torch.relu, torch.relu,
                    causal=False, norm="layer")
    dur = torch.relu(dense(q["linear"], y))
    dur = (1.0 - mask[:, 0, 0, :, None]) * dur
    mels = regulate(h, durations, c["max_frames"])
    frame_mask = (mels.abs().sum(-1) == 0).to(x.dtype)[:, None, None, :]
    q = p["decoder_prenet"]
    mels = torch.relu(dense(q["d2"], torch.relu(dense(q["d1"], mels))))
    mels = encoder_stack(p["decoder"], mels, frame_mask,
                         c["decoder_num_heads"], drop)
    mels = cnn_resnorm(p["decoder_postnet"], dense(p["out"], mels),
                       c["postnet_conv_layers"], c["postnet_kernel_size"],
                       torch.tanh, lambda v: v, causal=False, eps=BN_EPS,
                       train=train)
    return mels, dur


def masked_mae(target, pred):
    per = (target - pred).abs().mean(-1)
    return (per * (target != 0).any(-1).to(per.dtype)).sum() / per.numel()


def loss(p, c, batch, gen):
    mel, ids, durations = batch
    out, dur = forward(p, c, ids, durations, Dropout(c["dropout_rate"], gen),
                       True)
    return (3.0 * masked_mae(mel, out[:, :mel.shape[1]])
            + masked_mae(durations[..., None], dur))


def leaves(p, prefix=""):
    """(name, tensor) of every parameter of the tree, BatchNorm statistics
    left out, in a fixed order."""
    for k in sorted(p):
        v = p[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        elif k not in ("mean", "var"):
            yield prefix + k, v


class TrainReference:
    """The train step from the flat weights ``flat`` in ``dtype`` on
    ``device``: ``step(batch, seed)`` runs one Adam update at the
    config's constant learning rate and returns the loss; ``grads`` holds
    the step's gradient."""

    def __init__(self, flat: dict, c: dict, dtype, device):
        self.c = c
        self.p = tree(flat, dtype, device)
        self.names = [n for n, _ in leaves(self.p)]
        self.params = [v.requires_grad_() for _, v in leaves(self.p)]
        self.init = [v.detach().clone() for v in self.params]
        self.m = [torch.zeros_like(v) for v in self.params]
        self.v = [torch.zeros_like(v) for v in self.params]
        self.t = 0
        self.lr = float(c["learning_rate_tts_schedule"][0][1])
        self.grads = None

    def step(self, batch, seed: int) -> float:
        gen = torch.Generator(self.params[0].device).manual_seed(seed)
        value = loss(self.p, self.c, batch, gen)
        grads = torch.autograd.grad(value, self.params)
        self.grads = grads
        b1, b2, eps = 0.9, 0.98, 1e-9
        self.t += 1
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))
        return float(value.detach())
