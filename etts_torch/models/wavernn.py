"""WaveRNN vocoder (port of ``etts/models/wavernn.py``).

MelResNet conditioning + stretch/smoothing-conv upsampling, the
teacher-forced forward of training (``train=True``: BatchNorm on the
batch's statistics, the running ones moved as flax moves them, momentum
0.9) and its discretized mixture-of-logistics loss, batched generation
through ``fold_with_overlap`` / ``xfade_and_unfold``, and the sample loop
of ``etts_torch.ops.kernels.wavernn_cell`` (CUDA kernel on the card, plain
version on the CPU). Module names follow the flax tree.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import gru_scan
from ..ops.kernels.wavernn_cell import (Int8SampleLoopWeights,
                                        SampleLoopWeights,
                                        wavernn_sample_loop)
from ..ops.normalizers import mu_law_decode
from ..parallel.collectives import gather_rows, rank_world
from ..utils.seeds import fold_in
from .layers import Dense, batch_norm

BN_EPS = 1e-5          # flax BatchNorm default
BN_MOMENTUM = 0.9      # etts' BatchNorm(momentum=0.9), `wavernn.py:119`


def log_sum_exp(x):
    """log(sum(exp(x))) over the last axis, shifted by its max."""
    m = x.max(-1).values
    return m + torch.log(torch.exp(x - m[..., None]).sum(-1))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 65536,
                                  log_scale_min: float | None = None,
                                  reduce: bool = True):
    """Negative log-likelihood of y (B, T, 1) in [-1, 1] under the mixture
    of discretized logistics y_hat (B, T, 3 * nr_mix) (logits, means, log
    scales), term for term as `etts/models/wavernn.py:49-84`
    (`WaveRNN/utility/distribution.py:16-84`): the edge classes at |y| >
    0.999 take the logistic's tail; elsewhere log(cdf_delta), clamped at
    1e-12 so that the branch ``torch.where`` leaves unselected sends no
    inf * 0 = nan into the gradient, or, where cdf_delta <= 1e-5, the
    density at the bin's centre times its width."""
    if log_scale_min is None:
        log_scale_min = float(np.log(1e-14))
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[:, :, :nr_mix]
    means = y_hat[:, :, nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[:, :, 2 * nr_mix:3 * nr_mix],
                             min=log_scale_min)
    y = y.expand_as(means)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_min = torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner_inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)
    log_probs = log_probs + F.log_softmax(logit_probs, -1)
    if reduce:
        return -log_sum_exp(log_probs).mean()
    return -log_sum_exp(log_probs)[..., None]


def raw_loss(logits, y):
    """Cross-entropy of the int64 labels y (B, T) under logits (B, T,
    classes): -mean(sum(onehot * log_softmax)), whose backward scatters
    nothing."""
    logp = F.log_softmax(logits, -1)
    return -(F.one_hot(y, logits.shape[-1]).to(logp.dtype) * logp).sum(
        -1).mean()


def _bn(bn, x, train: bool):
    return batch_norm(bn, x, train, BN_MOMENTUM)


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(dims, dims, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(dims, eps=BN_EPS)
        self.Conv_1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm1d(dims, eps=BN_EPS)

    def forward(self, x, train: bool = False):
        y = torch.relu(_bn(self.BatchNorm_0, self.Conv_0(x), train))
        return _bn(self.BatchNorm_1, self.Conv_1(y), train) + x


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

    def forward(self, x, train: bool = False):
        x = torch.relu(_bn(self.BatchNorm_0, self.Conv_0(x), train))
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x, train)
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

    def forward(self, mels, train: bool = False):
        """mels (b, t, n_mels) -> (mels_up, aux), both (b, (t-2*pad)*hop, .);
        ``train``: the MelResNet's BatchNorm on the batch's statistics."""
        aux = self.resnet(mels.transpose(1, 2), train).transpose(1, 2)
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
        self.I = Dense(feat_dims + a + 1, d)
        for name, n_in in (("rnn1", d), ("rnn2", d + a)):
            setattr(self, f"{name}_wi", nn.Parameter(torch.zeros(n_in, 3 * d)))
            setattr(self, f"{name}_wh", nn.Parameter(torch.zeros(d, 3 * d)))
            setattr(self, f"{name}_bi", nn.Parameter(torch.zeros(3 * d)))
            setattr(self, f"{name}_bh", nn.Parameter(torch.zeros(3 * d)))
        self.fc1 = Dense(d + a, fc_dims)
        self.fc2 = Dense(fc_dims + a, fc_dims)
        self.fc3 = Dense(fc_dims, self.n_classes)

    def _aux_split(self, aux):
        a = self.aux_dims
        return [aux[..., a * i:a * (i + 1)] for i in range(4)]

    def forward(self, x, mels, train: bool = False):
        """Teacher-forced forward: x (b, T) previous samples, mels (b,
        t_mel, n_mels) padded by ``pad`` on both sides -> logits (b, T,
        n_classes). ``train`` (`etts/models/wavernn.py:245-260`): autograd
        runs and BatchNorm normalises on the batch's statistics, moving the
        running ones; else the running statistics, without autograd."""
        with contextlib.nullcontext() if train else torch.no_grad():
            return self._forward(x, mels, train)

    def _forward(self, x, mels, train: bool):
        mels_up, aux = self.upsample(mels, train)
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

    def _flax_layout(self):
        """The sample-path parameters as (in, out) float32 matrices and
        vectors, in the order of ``*SampleLoopWeights.from_flax_layout``."""
        return [x.detach().float() for x in (
            self.I.weight.T, self.I.bias, self.rnn1_wi, self.rnn1_wh,
            self.rnn1_bi, self.rnn1_bh, self.rnn2_wi, self.rnn2_wh,
            self.rnn2_bi, self.rnn2_bh, self.fc1.weight.T, self.fc1.bias,
            self.fc2.weight.T, self.fc2.bias, self.fc3.weight.T,
            self.fc3.bias)]

    def sample_weights(self, dtype=torch.bfloat16) -> SampleLoopWeights:
        """The sample-path weights in the bf16 (or float32) kernel's layout."""
        return SampleLoopWeights.from_flax_layout(
            *self._flax_layout(), feat=self.feat_dims, dtype=dtype,
            device=self.I.weight.device)

    def int8_sample_weights(self) -> Int8SampleLoopWeights:
        """The sample-path weights quantized from the float32 parameters in
        the int8 kernels' layout (both int8 modes take the same weights)."""
        return Int8SampleLoopWeights.from_flax_layout(
            *self._flax_layout(), feat=self.feat_dims,
            device=self.I.weight.device)


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


def _int8_dtype(int8_weights):
    """Map the int8_weights flag to the sample loop's weight_dtype
    (`wavernn.py:392-398`): True -> "int8" (dequantize before each
    product); "mxu" -> "int8_mxu" (int8 x int8 products with activations
    quantized per row on the fly); falsy -> None (bf16 weights)."""
    if int8_weights == "mxu":
        return "int8_mxu"
    return "int8" if int8_weights else None


def _default_weights(model: WaveRNN, weight_dtype):
    return (model.sample_weights(torch.float32) if weight_dtype is None
            else model.int8_sample_weights())


def _upsample_fold(model: WaveRNN, mels, batched, target, overlap):
    """Clamp, pad by ``pad`` frames, upsample and (optionally) fold one
    utterance (1, t_mel, n_mels) -> (mels_up, aux), (rows, T, .)."""
    mels = F.pad(_clamp_mels(mels.float()), (0, 0, model.pad, model.pad))
    mels_up, aux = model.upsample(mels)
    if batched:
        mels_up = fold_with_overlap(mels_up, target, overlap)
        aux = fold_with_overlap(aux, target, overlap)
    return mels_up, aux


@torch.no_grad()
def generate(model: WaveRNN, mels, *, batched: bool = True,
             target: int = 11000, overlap: int = 550, mu_law: bool = True,
             seed: int = 0, weights=None, int8_weights=False):
    """upsample -> fold -> sample loop -> unfold -> mu-law (RAW) -> fade-out
    (`wavernn.py:553-631`). mels (t_mel, n_mels) or (1, t_mel, n_mels) in
    [0, 1]; returns a waveform of (t_mel - 1) * hop samples.
    ``int8_weights``: False, True or "mxu" (``_int8_dtype``). ``weights``:
    the prepared sample-path weights of that mode (bf16 ``SampleLoopWeights``
    or ``Int8SampleLoopWeights`` for the kernels); built from the model when
    omitted (float32 for the bf16 mode)."""
    mu_law = mu_law and model.mode == "RAW"
    if mels.ndim == 2:
        mels = mels[None]
    if mels.shape[0] != 1:
        raise ValueError("generate() vocodes one utterance; see "
                         "generate_batch()")
    wave_len = (mels.shape[1] - 1) * model.hop_length
    mels_up, aux = _upsample_fold(model, mels, batched, target, overlap)
    weight_dtype = _int8_dtype(int8_weights)
    if weights is None:
        weights = _default_weights(model, weight_dtype)
    samples, _ = wavernn_sample_loop(
        _conditioning_streams(mels_up, aux), weights, mode=model.mode,
        n_classes=model.n_classes, seed=seed, weight_dtype=weight_dtype)
    return _finalize(samples.T, batched, overlap, mu_law, model, wave_len)


@torch.no_grad()
def generate_batch(model: WaveRNN, mels_list, *, target: int = 11000,
                   overlap: int = 550, mu_law: bool = True, seed: int = 0,
                   weights=None, int8_weights=False):
    """Vocode several utterances in one sample-loop launch
    (`wavernn.py:634-718`): each mel is clamped, padded, upsampled and folded
    on its own; the fold rows of all utterances (all target + 2*overlap
    long) run as one batch; the output is split per utterance and each is
    unfolded and finalized. Returns a list of waveforms of (t_i - 1) * hop
    samples. ``int8_weights`` and ``weights`` as in ``generate``.

    Not ported, as TPU-only and output-equivalent: the mel-length bucketing
    (``_bucket_len``) with the ``_live_folds`` pruning it needs, whose only
    purpose is to bound the number of XLA compiles (PyTorch compiles
    nothing per shape; zero padding leaves every sample below wave_len
    unchanged, `tests/test_wavernn.py:183-195`), and the row pad to a
    multiple of 8, the TPU sublane (rows are independent)."""
    mu_law = mu_law and model.mode == "RAW"
    ups, auxs, counts, wave_lens = [], [], [], []
    for mel in mels_list:
        mel = torch.as_tensor(mel, device=model.I.weight.device)
        mel = mel[None] if mel.ndim == 2 else mel
        wave_lens.append((mel.shape[1] - 1) * model.hop_length)
        up, aux = _upsample_fold(model, mel, True, target, overlap)
        ups.append(up)
        auxs.append(aux)
        counts.append(up.shape[0])
    weight_dtype = _int8_dtype(int8_weights)
    if weights is None:
        weights = _default_weights(model, weight_dtype)
    samples, _ = wavernn_sample_loop(
        _conditioning_streams(torch.cat(ups), torch.cat(auxs)), weights,
        mode=model.mode, n_classes=model.n_classes, seed=seed,
        weight_dtype=weight_dtype)
    rows = samples.T.split(counts)
    return [_finalize(r, True, overlap, mu_law, model, n)
            for r, n in zip(rows, wave_lens)]


@torch.no_grad()
def generate_batch_sharded(model: WaveRNN, mels_list, *, target: int = 11000,
                           overlap: int = 550, mu_law: bool = True,
                           seed: int = 0, weights=None):
    """Fold-parallel vocoding across the ranks of a process group
    (`etts/models/wavernn.py:721-794`): each utterance is upsampled and
    folded as in ``generate_batch``, the fold rows of all utterances are
    concatenated and padded with zero rows to a multiple of the world size,
    and each rank runs its equal share of them through one sample-loop
    launch (B1 on the card) seeded ``fold_in(seed, rank)``, as etts folds
    its key by the mesh index; the rows are then gathered (one all-reduce,
    exact) and every rank finalizes every utterance. Returns the list of
    waveforms on every rank. With no process group (or a group of one) it
    is ``generate_batch(..., seed=fold_in(seed, 0))``. No int8 mode, as
    etts' sharded path has none. The row pad to a multiple of 8 (the TPU
    sublane) is not ported, as in ``generate_batch``."""
    rank, world = rank_world()
    mu_law = mu_law and model.mode == "RAW"
    ups, auxs, counts, wave_lens = [], [], [], []
    for mel in mels_list:
        mel = torch.as_tensor(mel, device=model.I.weight.device)
        mel = mel[None] if mel.ndim == 2 else mel
        wave_lens.append((mel.shape[1] - 1) * model.hop_length)
        up, aux = _upsample_fold(model, mel, True, target, overlap)
        ups.append(up)
        auxs.append(aux)
        counts.append(up.shape[0])
    cond = _conditioning_streams(torch.cat(ups), torch.cat(auxs))
    rows = cond.shape[1]
    per = -(-rows // world)
    cond = F.pad(cond, (0, 0, 0, per * world - rows))
    if weights is None:
        weights = _default_weights(model, None)
    samples, _ = wavernn_sample_loop(
        cond[:, rank * per:(rank + 1) * per].contiguous(), weights,
        mode=model.mode, n_classes=model.n_classes,
        seed=fold_in(seed, rank))
    samples = gather_rows(samples, dim=1)[:, :rows]
    return [_finalize(r, True, overlap, mu_law, model, n)
            for r, n in zip(samples.T.split(counts), wave_lens)]
