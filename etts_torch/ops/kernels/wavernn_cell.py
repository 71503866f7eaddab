"""WaveRNN sample loop: the CUDA kernel ``csrc/wavernn_cell.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``etts/ops/pallas/wavernn_cell.py``
(``wavernn_sample_loop`` -> ``_make_kernel``, ``pallas_call`` at :351).
Bound on the H100: every step's five dependent matrix-vector products read
the ~3.8 M bf16 sample-path weights (7.6 MB at flagship width) again, so the
step time is a weight read; the arithmetic at B <= ~11 rows is small. Design:
one persistent block per fold row runs all T steps in one launch, streaming
the L2-resident weights with f32 accumulation (see the note in the source).

``wavernn_sample_loop`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields

import torch

from . import _build

LOG_SCALE_MIN = float(math.log(1e-14))
MODES = ("MOL", "RAW")


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclass
class SampleLoopWeights:
    """Sample-path weights in the kernel's layout: matrices (out, in) in
    ``dtype`` (bf16 for the kernel), vectors float32.

    wI's columns are [x_prev | mel | a1] zero-padded to a multiple of 8;
    wi2, wf1, wf2 act on the concatenations [x | a2], [x | a3], [y | a4]."""
    wI: torch.Tensor
    bI: torch.Tensor
    wi1: torch.Tensor
    wh1: torch.Tensor
    bi1: torch.Tensor
    bh1: torch.Tensor
    wi2: torch.Tensor
    wh2: torch.Tensor
    bi2: torch.Tensor
    bh2: torch.Tensor
    wf1: torch.Tensor
    bf1: torch.Tensor
    wf2: torch.Tensor
    bf2: torch.Tensor
    wf3: torch.Tensor
    bf3: torch.Tensor
    feat: int
    adim: int

    @classmethod
    def from_flax_layout(cls, W_I, b_I, wi1, wh1, bi1, bh1, wi2, wh2, bi2,
                         bh2, Wf1, bf1, Wf2, bf2, Wf3, bf3, *, feat: int,
                         dtype=torch.bfloat16, device=None):
        """Build from (in, out) matrices as the flax WaveRNN stores them:
        W_I (1 + feat + adim, d), rnn1 wi/wh (d, 3d), rnn2 wi (d + adim, 3d),
        fc1 (d + adim, fc), fc2 (fc + adim, fc), fc3 (fc, n_out)."""
        def mat(w, pad_to=None):
            w = torch.as_tensor(w, dtype=torch.float32).T
            if pad_to is not None and w.shape[1] < pad_to:
                w = torch.nn.functional.pad(w, (0, pad_to - w.shape[1]))
            return w.to(device=device, dtype=dtype).contiguous()

        def vec(b):
            return torch.as_tensor(b, dtype=torch.float32).to(device).contiguous()
        W_I = torch.as_tensor(W_I)
        adim = W_I.shape[0] - 1 - feat
        return cls(mat(W_I, _round8(W_I.shape[0])), vec(b_I), mat(wi1),
                   mat(wh1), vec(bi1), vec(bh1), mat(wi2), mat(wh2), vec(bi2),
                   vec(bh2), mat(Wf1), vec(bf1), mat(Wf2), vec(bf2), mat(Wf3),
                   vec(bf3), feat, adim)

    @property
    def d(self) -> int:
        return self.wh1.shape[1]

    @property
    def fc(self) -> int:
        return self.wf2.shape[0]

    @property
    def n_out(self) -> int:
        return self.wf3.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def n_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.tensors())


def n_draw(mode: str, n_classes: int, n_out: int) -> int:
    """Uniforms per row and step: the mixture pick plus the logistic draw
    (MOL), or one per class (RAW)."""
    return n_out // 3 + 1 if mode == "MOL" else n_classes


def _check(cond, w: SampleLoopWeights, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if cond.ndim != 3 or cond.shape[2] != w.feat + 4 * w.adim:
        raise ValueError(f"cond must be (T, B, {w.feat + 4 * w.adim}), got "
                         f"{tuple(cond.shape)}")


def init_state(B: int, d: int, device) -> dict:
    return {"h1": torch.zeros(B, d, device=device),
            "h2": torch.zeros(B, d, device=device),
            "x": torch.zeros(B, device=device), "step": 0}


@torch.no_grad()
def wavernn_sample_loop_plain(cond, w: SampleLoopWeights, *, mode="MOL",
                              n_classes=30, noise=None, generator=None,
                              state=None, teacher=None):
    """The plain PyTorch version: same arithmetic as the kernel in float32
    (matrices cast up from their stored dtype), conditioning projections
    hoisted into batched matmuls.

    cond (T, B, feat + 4*adim) = [mels_up | a1 | a2 | a3 | a4]. Uniforms come
    from ``noise`` (T, B, n_draw) or ``generator``. ``teacher`` (T, B), when
    given, replaces the fed-back sample of step t with teacher[t] (the
    kernel's own output, to check each step's function without feedback
    divergence). Returns (samples (T, B), state)."""
    _check(cond, w, mode)
    T, B, _ = cond.shape
    f = lambda x: x.float()
    d, fc, feat, adim = w.d, w.fc, w.feat, w.adim
    fa = feat + adim
    state = init_state(B, d, cond.device) if state is None else state
    h1, h2, x_prev = state["h1"].clone(), state["h2"].clone(), state["x"].clone()
    nd = n_draw(mode, n_classes, w.n_out)
    nr = w.n_out // 3
    cond = cond.float()
    wI = f(w.wI)
    i_s = cond[..., :fa] @ wI[:, 1:1 + fa].T + w.bI
    gi2_s = cond[..., fa:fa + adim] @ f(w.wi2)[:, d:].T + w.bi2
    f1_s = cond[..., fa + adim:fa + 2 * adim] @ f(w.wf1)[:, d:].T + w.bf1
    f2_s = cond[..., fa + 2 * adim:] @ f(w.wf2)[:, fc:].T + w.bf2
    wx, wi1, wh1 = wI[:, 0], f(w.wi1).T, f(w.wh1).T
    wi2x, wh2 = f(w.wi2)[:, :d].T, f(w.wh2).T
    wf1x, wf2x, wf3 = f(w.wf1)[:, :d].T, f(w.wf2)[:, :fc].T, f(w.wf3).T

    def gru(gi, gh, h):
        r = torch.sigmoid(gi[:, :d] + gh[:, :d])
        z = torch.sigmoid(gi[:, d:2 * d] + gh[:, d:2 * d])
        n = torch.tanh(gi[:, 2 * d:] + r * gh[:, 2 * d:])
        return (1.0 - z) * n + z * h

    out = cond.new_empty(T, B)
    for t in range(T):
        inp = i_s[t] + x_prev[:, None] * wx
        h1 = gru(inp @ wi1 + w.bi1, h1 @ wh1 + w.bh1, h1)
        x = inp + h1
        h2 = gru(x @ wi2x + gi2_s[t], h2 @ wh2 + w.bh2, h2)
        x = x + h2
        y = torch.relu(x @ wf1x + f1_s[t])
        y = torch.relu(y @ wf2x + f2_s[t])
        logits = y @ wf3 + w.bf3
        u = (noise[t] if noise is not None else torch.rand(
            B, nd, generator=generator, device=cond.device))
        u = u.float().clamp(1e-5, 1.0 - 1e-5)
        if mode == "MOL":
            g = logits[:, :nr] - torch.log(-torch.log(u[:, :nr]))
            k = g.argmax(-1, keepdim=True)
            mean = logits[:, nr:2 * nr].gather(1, k)[:, 0]
            ls = torch.clamp(logits[:, 2 * nr:3 * nr].gather(1, k)[:, 0],
                             min=LOG_SCALE_MIN)
            u2 = u[:, nr]
            s = torch.clamp(mean + torch.exp(ls)
                            * (torch.log(u2) - torch.log1p(-u2)), -1.0, 1.0)
        else:
            g = logits[:, :n_classes] - torch.log(-torch.log(u))
            s = 2.0 * g.argmax(-1).float() / (n_classes - 1.0) - 1.0
        out[t] = s
        x_prev = s if teacher is None else teacher[t].float()
    return out, {"h1": h1, "h2": h2, "x": x_prev, "step": state["step"] + T}


def _launch(cond, w: SampleLoopWeights, mode, n_classes, noise, seed, state):
    lib = _build.load("wavernn_cell")
    T, B, C = cond.shape
    for x in w.tensors():
        if x.device != cond.device or not x.is_contiguous():
            raise ValueError("weights must be contiguous on the cond device")
    for x in (w.wI, w.wi1, w.wh1, w.wi2, w.wh2, w.wf1, w.wf2, w.wf3):
        if x.dtype != torch.bfloat16:
            raise TypeError("the kernel takes bf16 weight matrices")
    for x in (w.bI, w.bi1, w.bh1, w.bi2, w.bh2, w.bf1, w.bf2, w.bf3):
        if x.dtype != torch.float32:
            raise TypeError("the kernel takes float32 bias vectors")
    nd = n_draw(mode, n_classes, w.n_out)
    if mode == "MOL" and w.n_out % 3:
        raise ValueError("MOL needs 3 * nr_mix outputs")
    if mode == "RAW" and w.n_out < n_classes:
        raise ValueError("RAW needs n_classes outputs")
    if noise is not None:
        if noise.shape != (T, B, nd) or noise.dtype != torch.float32:
            raise ValueError(f"noise must be float32 (T, B, {nd})")
        noise = noise.contiguous()
    cond = cond.float().contiguous()
    state = init_state(B, w.d, cond.device) if state is None else state
    h1 = state["h1"].float().contiguous().clone()
    h2 = state["h2"].float().contiguous().clone()
    x = state["x"].float().contiguous().clone()
    out = torch.empty(T, B, device=cond.device)
    ptrs = _build.ptr_array([cond, w.wI, w.bI, w.wi1, w.wh1, w.bi1, w.bh1,
                             w.wi2, w.wh2, w.bi2, w.bh2, w.wf1, w.bf1, w.wf2,
                             w.bf2, w.wf3, w.bf3, h1, h2, x, noise, out])
    ints = _build.int_array([T, B, C, w.feat, w.adim, w.d, w.fc, w.n_out,
                             w.wI.shape[1], MODES.index(mode),
                             w.n_out // 3 if mode == "MOL" else n_classes, nd])
    fn = lib.wavernn_sample_loop_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptrs, ints, LOG_SCALE_MIN, state["step"], seed & (2 ** 64 - 1),
             1024, torch.cuda.current_stream(cond.device).cuda_stream)
    _build.check(err, "wavernn_sample_loop")
    wavernn_sample_loop.launches += 1
    return out, {"h1": h1, "h2": h2, "x": x, "step": state["step"] + T}


def wavernn_sample_loop(cond, w: SampleLoopWeights, *, mode="MOL",
                        n_classes=30, noise=None, seed=0, state=None):
    """Run the sample loop: the kernel for CUDA tensors, the plain version
    (with a generator seeded from ``seed``) for CPU tensors.

    cond (T, B, feat + 4*adim); ``noise`` optional uniforms (T, B, n_draw);
    ``state`` {h1, h2, x, step} from an earlier chunk continues the same
    sequence (the kernel's Philox stream is indexed by the global step).
    Returns (samples (T, B), state)."""
    _check(cond, w, mode)
    if cond.is_cuda:
        return _launch(cond, w, mode, n_classes, noise, seed, state)
    gen = None
    if noise is None:
        gen = torch.Generator().manual_seed(seed + (state or {}).get("step", 0))
    return wavernn_sample_loop_plain(cond, w, mode=mode, n_classes=n_classes,
                                     noise=noise, generator=gen, state=state)


wavernn_sample_loop.launches = 0
