"""WaveRNN vocoder inference (port of ``etts/models/wavernn.py``).

MelResNet conditioning + stretch/smoothing-conv upsampling, batched
generation through ``fold_with_overlap`` / ``xfade_and_unfold``, and the
sample loop of ``etts_torch.ops.kernels.wavernn_cell`` (CUDA kernel on the
card, plain version on the CPU). Module names follow the flax tree.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..ops.kernels.wavernn_cell import SampleLoopWeights, wavernn_sample_loop
from ..ops.normalizers import mu_law_decode

BN_EPS = 1e-5          # flax BatchNorm default


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(dims, dims, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(dims, eps=BN_EPS)
        self.Conv_1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm1d(dims, eps=BN_EPS)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.BatchNorm_1(self.Conv_1(y)) + x


class MelResNet(nn.Module):
    """(b, n_mels, t) -> (b, res_out_dims, t - 2*pad) (channels first)."""

    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(compute_dims, eps=BN_EPS)
        for i in range(res_blocks):
            self.add_module(f"res_{i}", ResBlock(compute_dims))
        self.n_res = res_blocks
        self.Conv_1 = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x)
        return self.Conv_1(x)


class UpsampleNetwork(nn.Module):
    """Stretch + smoothing convs for the mel; stretched MelResNet output for
    the aux features (`wavernn.py:153-184`)."""

    def __init__(self, upsample_scales: Sequence[int], res_blocks: int,
                 feat_dims: int, compute_dims: int, res_out_dims: int,
                 pad: int):
        super().__init__()
        self.scales = tuple(upsample_scales)
        self.total = int(np.prod(self.scales))
        self.indent = pad * self.total
        self.resnet = MelResNet(res_blocks, feat_dims, compute_dims,
                                res_out_dims, pad)
        for i, s in enumerate(self.scales):
            conv = nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s), bias=False)
            self.add_module(f"smooth_{i}", conv)

    def forward(self, mels):
        """mels (b, t, n_mels) -> (mels_up, aux), both (b, (t-2*pad)*hop, .)."""
        aux = self.resnet(mels.transpose(1, 2)).transpose(1, 2)
        aux = aux.repeat_interleave(self.total, dim=1)
        x = mels.transpose(1, 2)[:, None]            # (b, 1, mel, T)
        for i, s in enumerate(self.scales):
            x = getattr(self, f"smooth_{i}")(x.repeat_interleave(s, dim=3))
        x = x[:, 0].transpose(1, 2)
        return x[:, self.indent:x.shape[1] - self.indent], aux


class WaveRNN(nn.Module):
    def __init__(self, rnn_dims: int = 512, fc_dims: int = 512, bits: int = 9,
                 pad: int = 2, upsample_factors: Sequence[int] = (5, 5, 8),
                 feat_dims: int = 80, compute_dims: int = 128,
                 res_out_dims: int = 128, res_blocks: int = 10,
                 hop_length: int = 200, mode: str = "MOL"):
        super().__init__()
        if int(np.prod(upsample_factors)) != hop_length:
            raise ValueError("upsample factors must factorise hop_length")
        if mode not in ("MOL", "RAW"):
            raise ValueError(f"Unknown mode {mode!r}")
        self.mode, self.bits, self.pad = mode, bits, pad
        self.rnn_dims, self.fc_dims, self.feat_dims = rnn_dims, fc_dims, feat_dims
        self.hop_length = hop_length
        self.aux_dims = res_out_dims // 4
        self.n_classes = 2 ** bits if mode == "RAW" else 30
        d, a = rnn_dims, self.aux_dims
        self.upsample = UpsampleNetwork(upsample_factors, res_blocks,
                                        feat_dims, compute_dims,
                                        res_out_dims, pad)
        self.I = nn.Linear(feat_dims + a + 1, d)
        for name, n_in in (("rnn1", d), ("rnn2", d + a)):
            setattr(self, f"{name}_wi", nn.Parameter(torch.zeros(n_in, 3 * d)))
            setattr(self, f"{name}_wh", nn.Parameter(torch.zeros(d, 3 * d)))
            setattr(self, f"{name}_bi", nn.Parameter(torch.zeros(3 * d)))
            setattr(self, f"{name}_bh", nn.Parameter(torch.zeros(3 * d)))
        self.fc1 = nn.Linear(d + a, fc_dims)
        self.fc2 = nn.Linear(fc_dims + a, fc_dims)
        self.fc3 = nn.Linear(fc_dims, self.n_classes)

    def _aux_split(self, aux):
        a = self.aux_dims
        return [aux[..., a * i:a * (i + 1)] for i in range(4)]

    @torch.no_grad()
    def forward(self, x, mels):
        """Teacher-forced forward at inference (BatchNorm running stats):
        x (b, T) previous samples, mels (b, t_mel, n_mels) padded by ``pad``
        on both sides -> logits (b, T, n_classes)."""
        mels_up, aux = self.upsample(mels)
        a1, a2, a3, a4 = self._aux_split(aux)
        h = self.I(torch.cat([x[..., None], mels_up, a1], -1))
        res = h
        h, _ = gru_scan(self.rnn1_wi, self.rnn1_wh, self.rnn1_bi,
                        self.rnn1_bh, h)
        h = h + res
        res = h
        h, _ = gru_scan(self.rnn2_wi, self.rnn2_wh, self.rnn2_bi,
                        self.rnn2_bh, torch.cat([h, a2], -1))
        h = h + res
        h = torch.relu(self.fc1(torch.cat([h, a3], -1)))
        h = torch.relu(self.fc2(torch.cat([h, a4], -1)))
        return self.fc3(h)

    def sample_weights(self, dtype=torch.bfloat16) -> SampleLoopWeights:
        """The sample-path weights in the kernel's layout."""
        return SampleLoopWeights.from_flax_layout(
            self.I.weight.detach().T, self.I.bias.detach(),
            self.rnn1_wi.detach(), self.rnn1_wh.detach(),
            self.rnn1_bi.detach(), self.rnn1_bh.detach(),
            self.rnn2_wi.detach(), self.rnn2_wh.detach(),
            self.rnn2_bi.detach(), self.rnn2_bh.detach(),
            self.fc1.weight.detach().T, self.fc1.bias.detach(),
            self.fc2.weight.detach().T, self.fc2.bias.detach(),
            self.fc3.weight.detach().T, self.fc3.bias.detach(),
            feat=self.feat_dims, dtype=dtype, device=self.I.weight.device)


def fold_with_overlap(x, target: int, overlap: int):
    """(1, total_len, f) -> (num_folds, target + 2*overlap, f)
    (`fatchord_version.py:272-319`)."""
    _, total_len, features = x.shape
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    if remaining != 0:
        num_folds += 1
        x = F.pad(x, (0, 0, 0, target + 2 * overlap - remaining))
    idx = (torch.arange(num_folds, device=x.device)[:, None] * (target + overlap)
           + torch.arange(target + 2 * overlap, device=x.device)[None, :])
    return x[0][idx]


def xfade_and_unfold(y, overlap: int):
    """(num_folds, target + 2*overlap) -> (total_len,) with an equal-power
    crossfade (`fatchord_version.py:321-383`)."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total_len = num_folds * (target + overlap) + overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = torch.linspace(-1.0, 1.0, fade_len, dtype=y.dtype, device=y.device)
    zeros = torch.zeros(silence_len, dtype=y.dtype, device=y.device)
    fade_in = torch.cat([zeros, torch.sqrt(0.5 * (1.0 + t))])
    fade_out = torch.cat([torch.sqrt(0.5 * (1.0 - t)), zeros])
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    starts = torch.arange(num_folds, device=y.device) * (target + overlap)
    idx = (starts[:, None] + torch.arange(length, device=y.device)).reshape(-1)
    return torch.zeros(total_len, dtype=y.dtype, device=y.device).index_add_(
        0, idx, y.reshape(-1))


def _clamp_mels(mels):
    """The vocoder's input contract: mels in [0, 1] ((mel+4)/8); runaway
    decodes far outside it degrade audio, never the worker."""
    return torch.clamp(torch.nan_to_num(mels, nan=0.0, posinf=1.0,
                                        neginf=0.0), 0.0, 1.0)


def _sanitize_cond(cond):
    """NaN/Inf or huge conditioning is clamped to +-1e4: a no-op on any
    finite in-range tensor."""
    return torch.clamp(torch.nan_to_num(cond, nan=0.0, posinf=1e4,
                                        neginf=-1e4), -1e4, 1e4)


def _conditioning_streams(mels_up, aux):
    """(B, T, feat), (B, T, 4*adim) -> the sample loop's raw conditioning
    stream (T, B, feat + 4*adim) = [mels_up | a1 | a2 | a3 | a4]; the
    projections of it run inside the loop."""
    return _sanitize_cond(torch.cat([mels_up, aux], -1).transpose(0, 1)
                          ).contiguous()


def _finalize(output, batched: bool, overlap: int, mu_law: bool,
              model: WaveRNN, wave_len: int):
    """Unfold + mu-law decode + 20-hop fade-out (`wavernn.py:797-816`)."""
    output = xfade_and_unfold(output, overlap) if batched else output[0]
    if mu_law:
        output = mu_law_decode(output, model.n_classes, from_labels=False)
    N = 20 * model.hop_length
    idx = torch.arange(output.shape[0], device=output.device)
    j = (N - wave_len + idx).to(output.dtype)
    factor = torch.clamp(1.0 - j / (N - 1), 0.0, 1.0)
    return torch.where(idx < wave_len, output * factor,
                       torch.zeros_like(output))[:wave_len]


@torch.no_grad()
def generate(model: WaveRNN, mels, *, batched: bool = True,
             target: int = 11000, overlap: int = 550, mu_law: bool = True,
             seed: int = 0, weights: SampleLoopWeights | None = None):
    """upsample -> fold -> sample loop -> unfold -> mu-law (RAW) -> fade-out
    (`wavernn.py:553-631`). mels (t_mel, n_mels) or (1, t_mel, n_mels) in
    [0, 1]; returns a waveform of (t_mel - 1) * hop samples. ``weights``:
    the prepared sample-path weights (bf16 for the kernel); built from the
    model in float32 when omitted."""
    mu_law = mu_law and model.mode == "RAW"
    if mels.ndim == 2:
        mels = mels[None]
    if mels.shape[0] != 1:
        raise ValueError("generate() vocodes one utterance")
    mels = _clamp_mels(mels.float())
    t_mel = mels.shape[1]
    wave_len = (t_mel - 1) * model.hop_length
    mels = F.pad(mels, (0, 0, model.pad, model.pad))
    mels_up, aux = model.upsample(mels)
    if batched:
        mels_up = fold_with_overlap(mels_up, target, overlap)
        aux = fold_with_overlap(aux, target, overlap)
    if weights is None:
        weights = model.sample_weights(torch.float32)
    samples, _ = wavernn_sample_loop(
        _conditioning_streams(mels_up, aux), weights, mode=model.mode,
        n_classes=model.n_classes, seed=seed)
    return _finalize(samples.T, batched, overlap, mu_law, model, wave_len)
