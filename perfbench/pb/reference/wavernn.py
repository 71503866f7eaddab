"""Plain reference of the WaveRNN MOL vocoder's generation
(`WaveRNN/models/fatchord_version.py` of the reference monorepo): the
MelResNet and the stretch-and-smooth upsampling of the conditioning, the
fold into rows of target + 2 * overlap samples, the crossfade back, and
the sample loop.

The sample loop is stated in bf16: its conditioning stream, its matrices
and the activation of each product rounded to bf16, the products summed
exactly (float64 here), the GRU states and the residuals kept in float32
or wider. ``teacher_gap`` runs it over the program's own samples: each step
reads the sample the program fed back and draws with the program's
uniforms (worked out again from the seed, ``philox``), so every step is
checked on its own, without the feedback that lets one rounding send two
free runs apart."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .layers import batch_norm

BN_EPS = 1e-5
LOG_SCALE_MIN = math.log(1e-14)


def upsample(p, c: dict, mel):
    """mel (t, n_mels) in [0, 1] -> conditioning (T, feat + 4 * aux) of
    the (t - 1) * hop samples... before folding: the mel clamped, padded by
    ``voc_pad`` frames each side, the MelResNet's output stretched, the mel
    stretched and smoothed scale by scale."""
    pad = c["voc_pad"]
    scales = c["voc_upsample_factors"]
    total = int(np.prod(scales))
    mel = torch.clamp(torch.nan_to_num(mel, nan=0.0, posinf=1.0,
                                       neginf=0.0), 0.0, 1.0)
    mel = F.pad(mel[None], (0, 0, pad, pad)).transpose(1, 2)   # (1, c, t)
    r = p["upsample"]["resnet"]
    x = F.conv1d(mel, r["Conv_0"]["kernel"].permute(2, 1, 0))
    x = torch.relu(batch_norm(r["BatchNorm_0"], x, BN_EPS))
    for i in range(c["voc_res_blocks"]):
        q = r[f"res_{i}"]
        y = F.conv1d(x, q["Conv_0"]["kernel"].permute(2, 1, 0))
        y = torch.relu(batch_norm(q["BatchNorm_0"], y, BN_EPS))
        y = F.conv1d(y, q["Conv_1"]["kernel"].permute(2, 1, 0))
        x = batch_norm(q["BatchNorm_1"], y, BN_EPS) + x
    aux = F.conv1d(x, r["Conv_1"]["kernel"].permute(2, 1, 0),
                   r["Conv_1"]["bias"])
    aux = aux.transpose(1, 2).repeat_interleave(total, dim=1)
    x = mel[:, None]                                          # (1, 1, c, t)
    for i, s in enumerate(scales):
        w = p["upsample"][f"smooth_{i}"]["kernel"].permute(3, 2, 0, 1)
        x = F.conv2d(x.repeat_interleave(s, dim=3), w, padding=(0, s))
    x = x[:, 0].transpose(1, 2)
    indent = pad * total
    mels_up = x[:, indent:x.shape[1] - indent]
    cond = torch.cat([mels_up, aux], -1)[0]
    return torch.clamp(torch.nan_to_num(cond, nan=0.0, posinf=1e4,
                                        neginf=-1e4), -1e4, 1e4)


def fold(x, target: int, overlap: int):
    """(T, f) -> (rows, target + 2 * overlap, f), zero-padded at the end."""
    total = x.shape[0]
    n = (total - overlap) // (target + overlap)
    if total - (n * (overlap + target) + overlap) != 0:
        n += 1
        x = F.pad(x, (0, 0, 0, n * (target + overlap) + overlap - total))
    return torch.stack([x[i * (target + overlap):
                          i * (target + overlap) + target + 2 * overlap]
                        for i in range(n)])


def n_rows(wave_len: int, target: int, overlap: int) -> int:
    """Fold rows of an utterance of wave_len samples (the mel's (t - 1) *
    hop), as ``fold`` makes them of its conditioning."""
    n = (wave_len - overlap) // (target + overlap)
    return n + (wave_len - (n * (overlap + target) + overlap) != 0)


def fades(overlap: int, dtype=torch.float32):
    """The crossfade's equal-power fade-in and fade-out, each overlap long,
    with overlap // 2 samples of silence."""
    silence = overlap // 2
    t = torch.linspace(-1.0, 1.0, overlap - silence, dtype=dtype)
    zeros = torch.zeros(silence, dtype=dtype)
    return (torch.cat([zeros, torch.sqrt(0.5 * (1.0 + t))]),
            torch.cat([torch.sqrt(0.5 * (1.0 - t)), zeros]))


def observed_rows(wav: np.ndarray, rows: int, target: int, overlap: int,
                  hop: int):
    """The fold rows' samples that an utterance's waveform shows: (rows,
    L) float64 values and a mask of the samples that can be read back.
    In the second half of a row's head only the row itself is heard (its
    fade-in times the sample), in the row's body the sample itself, in the
    first half of its tail the sample times the fade-out; the last 20 hops
    are faded out to zero. A sample is read back where its weight is at
    least 1e-2."""
    L = target + 2 * overlap
    n = len(wav)
    fade_in, fade_out = fades(overlap)
    weight = np.ones(L)
    weight[:overlap] = fade_in.numpy()
    weight[-overlap:] = fade_out.numpy()
    N = 20 * hop
    idx = np.arange(n)
    tail = np.clip(1.0 - (N - n + idx).astype(np.float32) / (N - 1),
                   0.0, 1.0).astype(np.float64)
    vals = np.zeros((rows, L))
    mask = np.zeros((rows, L), bool)
    for i in range(rows):
        start = i * (target + overlap)
        pos = start + np.arange(L)
        w = weight.copy()
        inside = pos < n
        w[inside] *= tail[pos[inside]]
        # overlapped by the neighbour: the neighbour's weight is zero there
        if i > 0:
            w[:overlap // 2] = 0.0
        if i + 1 < rows:
            w[L - overlap + overlap - overlap // 2:] = 0.0
        ok = inside & (w >= 1e-2)
        vals[i, ok] = wav[pos[ok]] / w[ok]
        mask[i] = ok
    return vals, mask


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _same(x):
    return x


class SampleStep:
    """The sample loop's function of one step for rows at once, in bf16
    with exact sums, from the (in, out) parameters of the tree ``p``.
    ``bf16=False`` gives the same function on float32 weights and
    activations, as the program runs it on the CPU."""

    def __init__(self, p, c: dict, dtype=torch.float64, bf16: bool = True):
        self.rnd = _rnd = _bf16 if bf16 else _same
        feat = c["mel_channels"]
        W_I = p["I"]["kernel"]
        d = W_I.shape[1]
        self.aux = c["voc_res_out_dims"] // 4
        self.feat = feat
        w = lambda m: _rnd(m.float()).to(dtype)
        f = lambda v: v.float().to(dtype)
        self.ix, self.wic, self.bI = f(W_I[0]), w(W_I[1:]), f(p["I"]["bias"])
        self.wi1, self.wh1 = w(p["rnn1_wi"]), w(p["rnn1_wh"])
        self.bi1, self.bh1 = f(p["rnn1_bi"]), f(p["rnn1_bh"])
        wi2 = p["rnn2_wi"]
        self.w2x, self.w2a, self.wh2 = w(wi2[:d]), w(wi2[d:]), w(p["rnn2_wh"])
        self.bi2, self.bh2 = f(p["rnn2_bi"]), f(p["rnn2_bh"])
        wf1, wf2 = p["fc1"]["kernel"], p["fc2"]["kernel"]
        fc = wf2.shape[1]
        self.wf1x, self.wf1a, self.bf1 = w(wf1[:d]), w(wf1[d:]), f(p["fc1"]["bias"])
        self.wf2x, self.wf2a, self.bf2 = w(wf2[:fc]), w(wf2[fc:]), f(p["fc2"]["bias"])
        self.wf3, self.bf3 = w(p["fc3"]["kernel"]), f(p["fc3"]["bias"])
        self.d, self.dtype = d, dtype

    def split(self, cond):
        """cond (..., feat + 4 aux) rounded to bf16 -> [mel | a1], a2, a3, a4."""
        cond = self.rnd(cond.float()).to(self.dtype)
        fa, a = self.feat + self.aux, self.aux
        return (cond[..., :fa], cond[..., fa:fa + a], cond[..., fa + a:fa + 2 * a],
                cond[..., fa + 2 * a:])

    @staticmethod
    def gru(gi, gh, h):
        d = h.shape[-1]
        r = torch.sigmoid(gi[..., :d] + gh[..., :d])
        z = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
        n = torch.tanh(gi[..., 2 * d:] + r * gh[..., 2 * d:])
        return (1.0 - z) * n + z * h

    def logits(self, ma1, a2, a3, a4, x_prev, h1, h2):
        inp = self.rnd(ma1) @ self.wic + self.bI + x_prev[..., None] * self.ix
        h1 = self.gru(self.rnd(inp) @ self.wi1 + self.bi1,
                      self.rnd(h1) @ self.wh1 + self.bh1, h1)
        x = inp + h1
        h2 = self.gru(self.rnd(x) @ self.w2x + a2 @ self.w2a + self.bi2,
                      self.rnd(h2) @ self.wh2 + self.bh2, h2)
        x = x + h2
        y = torch.relu(self.rnd(x) @ self.wf1x + a3 @ self.wf1a + self.bf1)
        y = torch.relu(self.rnd(y) @ self.wf2x + a4 @ self.wf2a + self.bf2)
        return self.rnd(y) @ self.wf3 + self.bf3, h1, h2


def components(logits, u):
    """Each mixture component's sample value under the draws u, clipped to
    [-1, 1], its Gumbel-perturbed score, and how far its value moves for a
    unit change of its mean and log scale, 1 + scale * |logit(u)|:
    (values, scores, reach), each (..., nr)."""
    nr = logits.shape[-1] // 3
    scores = logits[..., :nr] - torch.log(-torch.log(u[..., :nr]))
    ls = torch.clamp(logits[..., 2 * nr:], min=LOG_SCALE_MIN)
    u2 = u[..., nr:nr + 1]
    spread = torch.exp(ls) * (torch.log(u2) - torch.log1p(-u2))
    values = torch.clamp(logits[..., nr:2 * nr] + spread, -1, 1)
    return values, scores, 1.0 + spread.abs()


def sample(logits, u):
    """MOL: the Gumbel-max pick of a mixture, then the logistic's inverse
    CDF, clipped to [-1, 1]."""
    values, scores, _ = components(logits, u)
    return values.gather(-1, scores.argmax(-1, keepdim=True))[..., 0]


def judge(logits, u, served):
    """(gap, on the clip) a step: the last is true where the served sample and the reference's sit on the
    same bound of [-1, 1], which decides them whatever the logits. The gap
    asks how far the reference's logits would have to move to give the
    served sample: over the components, the least sum of the score by
    which the component lies below the best and the distance of its value
    from the served sample in units of its reach (a near tie that rounding
    flips, and a value that rounding of the mean or scale moves, read
    small); a served sample outside [-1, 1] (beyond the 1e-5 that reading
    it back through the crossfade may add) has no component and reads
    infinite."""
    values, scores, reach = components(logits, u)
    own = values.gather(-1, scores.argmax(-1, keepdim=True))[..., 0]
    below = scores.amax(-1, keepdim=True) - scores
    gap = (below + (served[..., None] - values).abs() / reach).amin(-1)
    gap = torch.where(served.abs() > 1 + 1e-5,
                      torch.full_like(gap, float("inf")), gap)
    on_bound = (own.abs() == 1) & ((served - own).abs() <= 1e-5)
    return gap, on_bound


@torch.no_grad()
def teacher_gap(step: SampleStep, cond, served, known, uniforms,
                free_until: int, chunk: int = 1024):
    """Run the sample loop over rows at once: cond (T, B, C), the served
    samples (T, B) and where they are known (T, B, bool), the uniforms (T,
    B, draws), as tensors on one device. Steps before ``free_until`` feed
    back the reference's own samples (the served ones cannot be read
    there); from it on, each step feeds back the served sample of the step
    before. Returns ``judge``'s two readings (T, B) at the known steps
    from ``free_until`` on whose fed-back sample was known, NaN
    elsewhere."""
    T, B, _ = cond.shape
    dt = step.dtype
    h1 = torch.zeros(B, step.d, dtype=dt, device=cond.device)
    h2 = torch.zeros_like(h1)
    x = torch.zeros(B, dtype=dt, device=cond.device)
    for t in range(free_until):
        ma1, a2, a3, a4 = step.split(cond[t])
        lg, h1, h2 = step.logits(ma1, a2, a3, a4, x, h1, h2)
        x = sample(lg, uniforms[t].to(dt))
    served = served.to(dt)
    nan = float("nan")
    gap = torch.full((T, B), nan, dtype=dt, device=cond.device)
    bound = gap.clone()
    x_prev = torch.cat([x[None], served[free_until:T - 1]])
    for s in range(free_until, T, chunk):
        e = min(s + chunk, T)
        ma1, a2, a3, a4 = step.split(cond[s:e])
        xp = x_prev[s - free_until:e - free_until]
        inp = step.rnd(ma1) @ step.wic + step.bI + xp[..., None] * step.ix
        gi1 = step.rnd(inp) @ step.wi1 + step.bi1
        hs1 = []
        for t in range(e - s):
            h1 = step.gru(gi1[t], step.rnd(h1) @ step.wh1 + step.bh1, h1)
            hs1.append(h1)
        xx = inp + torch.stack(hs1)
        gi2 = step.rnd(xx) @ step.w2x + a2 @ step.w2a + step.bi2
        hs2 = []
        for t in range(e - s):
            h2 = step.gru(gi2[t], step.rnd(h2) @ step.wh2 + step.bh2, h2)
            hs2.append(h2)
        xx = xx + torch.stack(hs2)
        y = torch.relu(step.rnd(xx) @ step.wf1x + a3 @ step.wf1a + step.bf1)
        y = torch.relu(step.rnd(y) @ step.wf2x + a4 @ step.wf2a + step.bf2)
        lg = step.rnd(y) @ step.wf3 + step.bf3
        g, b = judge(lg, uniforms[s:e].to(dt), served[s:e])
        for x, v in ((gap, g), (bound, b.to(dt))):
            x[s:e] = torch.where(known[s:e], v, torch.full_like(v, nan))
    # a step whose fed-back sample could not be read is not checked
    for x in (gap, bound):
        x[free_until + 1:][~known[free_until:T - 1]] = nan
    return gap, bound
