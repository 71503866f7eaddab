"""WaveRNN sample loop: the CUDA kernels ``csrc/wavernn_cell.cu`` and their
plain PyTorch versions.

Replaces the Pallas TPU kernel ``etts/ops/pallas/wavernn_cell.py``
(``wavernn_sample_loop`` -> ``_make_kernel``, ``pallas_call`` at :351) in its
three weight modes: bf16 matrices (``weight_dtype=None``), and per-column
symmetric int8 matrices, either dequantized before each product
(``"int8"``) or multiplied as int8 x int8 -> int32 against activations
quantized per row on the fly (``"int8_mxu"``).
Bound on the H100: every step's dependent products read the ~3.8 M
sample-path weights again (7.65 MB in bf16, 3.8 MB in int8 at flagship
width), so the step time is a weight read from L2; the arithmetic is small.
bf16 design: one persistent block per tile of ``TILE_ROWS`` fold rows runs
all T steps in one launch, every product on the tensor cores (``mma.sync``
m16n8k16) with the weights packed once into A-fragment tiles
(``pack_mma``), and the TPU kernel's bf16 rounding. int8 designs: the
same tile on int8 weights packed once into 16 x 32 tiles
(``pack_mma_int8``): ``int8_mxu`` quantizes the activations per row and
multiplies on ``mma.sync`` m16n8k32 s8 with exact int32 sums, ``int8``
turns the weights into bf16 in registers and multiplies on m16n8k16 (see
the note in the source).

``wavernn_sample_loop`` launches the mode's kernel for CUDA tensors and runs
the mode's plain version for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields

import torch

from . import _build

LOG_SCALE_MIN = float(math.log(1e-14))
MODES = ("MOL", "RAW")


# The matrices of the sample path in the TPU kernel's split layout, in the
# order the kernel reads them: each split of a concatenated input is its own
# product ([mel | a1] -> wic, [x | a2] -> w2x, w2a, [x | a3] -> wf1x, wf1a,
# [y | a4] -> wf2x, wf2a).
MATRICES = ("wic", "wi1", "wh1", "w2x", "w2a", "wh2", "wf1x", "wf1a", "wf2x",
            "wf2a", "wf3")


def _split_flax_layout(W_I, b_I, wi1, wh1, bi1, bh1, wi2, wh2, bi2, bh2, Wf1,
                       bf1, Wf2, bf2, Wf3, bf3, feat: int):
    """The (in, out) float32 parameters as the flax WaveRNN stores them, cut
    into the TPU kernel's splits: ({name: (in, out) matrix}, {name:
    vector}, adim)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    W_I, wi2, Wf1, Wf2 = f32(W_I), f32(wi2), f32(Wf1), f32(Wf2)
    d, fc = W_I.shape[1], Wf2.shape[1]
    mats = dict(wic=W_I[1:], wi1=f32(wi1), wh1=f32(wh1), w2x=wi2[:d],
                w2a=wi2[d:], wh2=f32(wh2), wf1x=Wf1[:d], wf1a=Wf1[d:],
                wf2x=Wf2[:fc], wf2a=Wf2[fc:], wf3=f32(Wf3))
    vecs = {k: f32(v) for k, v in (
        ("ix", W_I[0]), ("bI", b_I), ("bi1", bi1), ("bh1", bh1),
        ("bi2", bi2), ("bh2", bh2), ("bf1", bf1), ("bf2", bf2),
        ("bf3", bf3))}
    return mats, vecs, W_I.shape[0] - 1 - feat


@dataclass
class SampleLoopWeights:
    """Sample-path weights in the TPU kernel's split layout: ``ix`` is W_I's
    x_prev row, float32 (d,); ``wic`` acts on [mel | a1]; ``w2x``/``w2a``
    on [x | a2], ``wf1x``/``wf1a`` on [x | a3], ``wf2x``/``wf2a`` on
    [y | a4]. Matrices are (out, in) in ``dtype`` (bf16 for the kernel,
    float32 for the TPU kernel's float32 verify mode); biases float32.

    The kernel reads a copy packed for the tensor cores (``pack_mma``),
    built by the wrapper at the first launch and kept on the object, not as
    a field, so ``tensors()`` and ``n_bytes()`` count the weights once."""
    ix: torch.Tensor
    wic: torch.Tensor
    bI: torch.Tensor
    wi1: torch.Tensor
    wh1: torch.Tensor
    bi1: torch.Tensor
    bh1: torch.Tensor
    w2x: torch.Tensor
    w2a: torch.Tensor
    wh2: torch.Tensor
    bi2: torch.Tensor
    bh2: torch.Tensor
    wf1x: torch.Tensor
    wf1a: torch.Tensor
    bf1: torch.Tensor
    wf2x: torch.Tensor
    wf2a: torch.Tensor
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
        mats, vecs, adim = _split_flax_layout(
            W_I, b_I, wi1, wh1, bi1, bh1, wi2, wh2, bi2, bh2, Wf1, bf1, Wf2,
            bf2, Wf3, bf3, feat)
        parts = {k: v.T.to(dtype) for k, v in mats.items()} | vecs
        return cls(**{k: v.to(device).contiguous() for k, v in parts.items()},
                   feat=feat, adim=adim)

    @property
    def d(self) -> int:
        return self.ix.shape[0]

    @property
    def fc(self) -> int:
        return self.bf1.shape[0]

    @property
    def n_out(self) -> int:
        return self.bf3.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def n_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.tensors())

    def packed(self) -> list:
        """The eleven matrices packed by ``pack_mma``, in ``MATRICES``
        order; built once and kept."""
        if getattr(self, "_packed", None) is None:
            self._packed = [pack_mma(getattr(self, k)) for k in MATRICES]
        return self._packed


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _round32(n: int) -> int:
    return (n + 31) // 32 * 32


def pack_mma(w):
    """(M, K) -> (M16 / 16, K16 / 16, 32, 8): w zero-padded to multiples of
    16 and cut into 16 x 16 tiles, each in the A-fragment order of
    ``mma.m16n8k16``: lane l = 4g + t holds w[g, 2t:2t+2], w[g+8, 2t:2t+2],
    w[g, 2t+8:2t+10], w[g+8, 2t+8:2t+10] of its tile, one 16-byte load.
    Tiles of one m-tile are consecutive along k, so a warp streams a row of
    tiles front to back, 512 contiguous bytes a tile."""
    M, K = w.shape
    w = torch.nn.functional.pad(w, (0, _round16(K) - K, 0, _round16(M) - M))
    MT, KT = w.shape[0] // 16, w.shape[1] // 16
    # (mt, rh, g, kt, ch, t, e): row rh * 8 + g, column ch * 8 + 2t + e
    w = w.reshape(MT, 2, 8, KT, 2, 4, 2)
    return w.permute(0, 3, 2, 5, 4, 1, 6).reshape(MT, KT, 32, 8).contiguous()


def unpack_mma(p, M: int, K: int):
    """The inverse of ``pack_mma``: (MT, KT, 32, 8) -> (M, K)."""
    MT, KT = p.shape[:2]
    w = p.reshape(MT, KT, 8, 4, 2, 2, 2).permute(0, 5, 2, 1, 4, 3, 6)
    return w.reshape(MT * 16, KT * 16)[:M, :K]


def pack_mma_int8(q):
    """(M, K) int8 -> (M16 / 16, K32 / 32, 32, 16): q zero-padded to
    multiples of 16 rows and 32 columns and cut into 16 x 32 tiles, each in
    the A-fragment order of ``mma.m16n8k32`` s8: lane l = 4g + t holds
    q[g, 4t:4t+4], q[g+8, 4t:4t+4], q[g, 16+4t:20+4t], q[g+8, 16+4t:20+4t]
    of its tile, one 16-byte load. Tiles of one m-tile are consecutive along
    k. The int8 kernel reads the same tiles as two bf16 fragments of
    ``mma.m16n8k16`` (see ``qstream`` in the source)."""
    M, K = q.shape
    q = torch.nn.functional.pad(q, (0, _round32(K) - K, 0, _round16(M) - M))
    MT, KT = q.shape[0] // 16, q.shape[1] // 32
    # (mt, rh, g, kt, ch, t, e): row rh * 8 + g, column ch * 16 + 4t + e
    q = q.reshape(MT, 2, 8, KT, 2, 4, 4)
    return q.permute(0, 3, 2, 5, 4, 1, 6).reshape(MT, KT, 32, 16).contiguous()


def unpack_mma_int8(p, M: int, K: int):
    """The inverse of ``pack_mma_int8``: (MT, KT, 32, 16) -> (M, K)."""
    MT, KT = p.shape[:2]
    q = p.reshape(MT, KT, 8, 4, 2, 2, 4).permute(0, 5, 2, 1, 4, 3, 6)
    return q.reshape(MT * 16, KT * 32)[:M, :K]


INT8_MODES = ("int8", "int8_mxu")


def quantize_int8(w):
    """Per-column symmetric int8 of an (in, out) float32 matrix, as the TPU
    kernel's ``prep`` (`wavernn_cell.py:287-297`): s = max(max|w| over the
    input axis / 127, 1e-12), q = clip(round_half_even(w / s), -127, 127).
    Returns (q (out, in) int8, s (out,) float32)."""
    w = torch.as_tensor(w, dtype=torch.float32)
    s = torch.clamp(w.abs().amax(0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q.T.contiguous(), s


@dataclass
class Int8SampleLoopWeights:
    """Sample-path weights in the int8 kernels' layout, quantized from the
    model's float32 parameters. Each split of a concatenated input is
    quantized on its own, with its own scale row, as the TPU kernel does:
    ``wic`` acts on [mel | a1] (the x_prev row of W_I stays float32 in
    ``ix``), ``w2x``/``w2a`` on [x | a2], ``wf1x``/``wf1a`` on [x | a3],
    ``wf2x``/``wf2a`` on [y | a4]. Matrices are (out, in) int8; ``s_*``
    are the eleven (out,) float32 scale rows; biases float32.

    The kernels read a copy packed for the tensor cores
    (``pack_mma_int8``), built at the first launch and kept on the object,
    as ``SampleLoopWeights.packed``."""
    ix: torch.Tensor
    wic: torch.Tensor
    s_wic: torch.Tensor
    bI: torch.Tensor
    wi1: torch.Tensor
    s_wi1: torch.Tensor
    wh1: torch.Tensor
    s_wh1: torch.Tensor
    bi1: torch.Tensor
    bh1: torch.Tensor
    w2x: torch.Tensor
    s_w2x: torch.Tensor
    w2a: torch.Tensor
    s_w2a: torch.Tensor
    wh2: torch.Tensor
    s_wh2: torch.Tensor
    bi2: torch.Tensor
    bh2: torch.Tensor
    wf1x: torch.Tensor
    s_wf1x: torch.Tensor
    wf1a: torch.Tensor
    s_wf1a: torch.Tensor
    bf1: torch.Tensor
    wf2x: torch.Tensor
    s_wf2x: torch.Tensor
    wf2a: torch.Tensor
    s_wf2a: torch.Tensor
    bf2: torch.Tensor
    wf3: torch.Tensor
    s_wf3: torch.Tensor
    bf3: torch.Tensor
    feat: int
    adim: int

    @classmethod
    def from_flax_layout(cls, W_I, b_I, wi1, wh1, bi1, bh1, wi2, wh2, bi2,
                         bh2, Wf1, bf1, Wf2, bf2, Wf3, bf3, *, feat: int,
                         device=None):
        """Quantize (in, out) float32 matrices as the flax WaveRNN stores
        them (the arguments of ``SampleLoopWeights.from_flax_layout``)."""
        mats, parts, adim = _split_flax_layout(
            W_I, b_I, wi1, wh1, bi1, bh1, wi2, wh2, bi2, bh2, Wf1, bf1, Wf2,
            bf2, Wf3, bf3, feat)
        for name, w in mats.items():
            parts[name], parts["s_" + name] = quantize_int8(w)
        return cls(**{k: v.to(device).contiguous() for k, v in parts.items()},
                   feat=feat, adim=adim)

    @property
    def d(self) -> int:
        return self.ix.shape[0]

    @property
    def fc(self) -> int:
        return self.bf1.shape[0]

    @property
    def n_out(self) -> int:
        return self.bf3.shape[0]

    tensors = SampleLoopWeights.tensors
    n_bytes = SampleLoopWeights.n_bytes

    def packed(self) -> list:
        """The eleven matrices packed by ``pack_mma_int8``, in ``MATRICES``
        order; built once and kept."""
        if getattr(self, "_packed", None) is None:
            self._packed = [pack_mma_int8(getattr(self, k)) for k in MATRICES]
        return self._packed


def n_draw(mode: str, n_classes: int, n_out: int) -> int:
    """Uniforms per row and step: the mixture pick plus the logistic draw
    (MOL), or one per class (RAW)."""
    return n_out // 3 + 1 if mode == "MOL" else n_classes


def _check(cond, w, mode: str, weight_dtype):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if weight_dtype not in (None,) + INT8_MODES:
        raise ValueError(f"weight_dtype must be None or one of {INT8_MODES}, "
                         f"got {weight_dtype!r}")
    want = SampleLoopWeights if weight_dtype is None else Int8SampleLoopWeights
    if not isinstance(w, want):
        raise TypeError(f"weight_dtype={weight_dtype!r} takes "
                        f"{want.__name__}, got {type(w).__name__}")
    if cond.ndim != 3 or cond.shape[2] != w.feat + 4 * w.adim:
        raise ValueError(f"cond must be (T, B, {w.feat + 4 * w.adim}), got "
                         f"{tuple(cond.shape)}")


def init_state(B: int, d: int, device) -> dict:
    return {"h1": torch.zeros(B, d, device=device),
            "h2": torch.zeros(B, d, device=device),
            "x": torch.zeros(B, device=device), "step": 0}


def _gru(gi, gh, h):
    d = h.shape[1]
    r = torch.sigmoid(gi[:, :d] + gh[:, :d])
    z = torch.sigmoid(gi[:, d:2 * d] + gh[:, d:2 * d])
    n = torch.tanh(gi[:, 2 * d:] + r * gh[:, 2 * d:])
    return (1.0 - z) * n + z * h


def _step_fn(cond, w, dot):
    """One step of the TPU kernel (`wavernn_cell.py:126-165`) with the
    product ``dot(act, name)`` of each split: x_prev . W_I[0] and the
    biases in float32, the GRU and residuals in float32."""
    fa, adim = w.feat + w.adim, w.adim
    ma1, a2 = cond[..., :fa], cond[..., fa:fa + adim]
    a3, a4 = cond[..., fa + adim:fa + 2 * adim], cond[..., fa + 2 * adim:]

    def step(t, x_prev, h1, h2):
        inp = dot(ma1[t], "wic") + w.bI + x_prev[:, None] * w.ix
        h1 = _gru(dot(inp, "wi1") + w.bi1, dot(h1, "wh1") + w.bh1, h1)
        x = inp + h1
        h2 = _gru(dot(x, "w2x") + dot(a2[t], "w2a") + w.bi2,
                  dot(h2, "wh2") + w.bh2, h2)
        x = x + h2
        y = torch.relu(dot(x, "wf1x") + dot(a3[t], "wf1a") + w.bf1)
        y = torch.relu(dot(y, "wf2x") + dot(a4[t], "wf2a") + w.bf2)
        return dot(y, "wf3") + w.bf3, h1, h2
    return step


def _bf16_step(cond, w: SampleLoopWeights, acc=torch.float32):
    """One step with the TPU kernel's rounding for its weight type
    (`wavernn_cell.py:127-165`, stream type `:258`). bf16 matrices: the
    conditioning stream is rounded to bf16 and each split product takes its
    activation rounded to bf16, summed in ``acc``. float32 matrices (the
    TPU kernel's float32 verify mode): ``acc`` everywhere. ``acc``
    float64 gives the same function with exact sums, a reference that
    neither float32 sum order is nearer to by construction."""
    if w.wi1.dtype == torch.bfloat16:
        rnd = lambda x: x.to(torch.bfloat16).to(acc)
    else:
        rnd = lambda x: x.to(acc)
    mats = {k: getattr(w, k).to(acc).T for k in MATRICES}
    return _step_fn(rnd(cond), w, lambda act, name: rnd(act) @ mats[name])


def _int8_step(cond, w: Int8SampleLoopWeights, mxu: bool,
               acc=torch.float32):
    """One step of the int8 weights with the TPU kernel's rounding
    (`wavernn_cell.py:80-106, 126-165`): the conditioning stream is rounded
    to bf16; ``int8`` rounds each product's activation to bf16 and computes
    (act . q) * s_col, summed in ``acc`` (float64 gives exact sums, as
    ``_bf16_step`` does for the bf16 weights); ``int8_mxu`` quantizes each
    activation row on its own, sa = max(max|act|, 1e-9) / 127, qa =
    round_half_even(act / sa) clipped to +-127, and computes the integer
    sum (qa . q) exactly (float32 while k * 127^2 < 2^24, where every
    partial sum is an integer float32 holds, else float64) times sa *
    s_col, in float32 whatever ``acc``. Each split of a concatenated input
    is its own product; x_prev . W_I[0] and the biases stay float32."""
    mats = {}
    for name in MATRICES:
        q = getattr(w, name)
        if mxu:
            exact = (torch.float32 if q.shape[1] * 127 * 127 < 2 ** 24
                     else torch.float64)
            q = q.to(exact).T
        else:
            q = q.to(acc).T
        mats[name] = (q, getattr(w, "s_" + name))

    def dot(act, name):
        q, s = mats[name]
        if mxu:
            m = torch.clamp(act.abs().amax(-1, keepdim=True), min=1e-9)
            # a tensor divisor: CUDA divides by a Python scalar as a multiply
            # by its reciprocal, which is not the TPU kernel's division
            sa = m / torch.full_like(m, 127.0)
            qa = torch.clamp(torch.round(act / sa), -127.0, 127.0)
            return (qa.to(q.dtype) @ q).float() * sa * s
        return (act.to(torch.bfloat16).to(acc) @ q) * s

    stream = cond.to(torch.bfloat16)
    return _step_fn(stream.float() if mxu else stream.to(acc), w, dot)


def _sample(logits, u, mode: str, n_classes: int):
    """MOL: Gumbel-max mixture pick, then the logistic inverse CDF with
    log-scale >= log 1e-14, clipped to [-1, 1]; RAW: Gumbel-max class c ->
    2c / (n_classes - 1) - 1. Uniforms clipped to [1e-5, 1 - 1e-5]."""
    u = u.float().clamp(1e-5, 1.0 - 1e-5)
    if mode == "RAW":
        g = logits[:, :n_classes] - torch.log(-torch.log(u))
        c = 2.0 * g.argmax(-1).float()
        # a tensor divisor: CUDA divides by a Python scalar as a multiply by
        # its reciprocal, one ulp off the kernels' division for some classes
        return c / torch.full_like(c, n_classes - 1.0) - 1.0
    nr = logits.shape[1] // 3
    g = logits[:, :nr] - torch.log(-torch.log(u[:, :nr]))
    k = g.argmax(-1, keepdim=True)
    mean = logits[:, nr:2 * nr].gather(1, k)[:, 0]
    ls = torch.clamp(logits[:, 2 * nr:3 * nr].gather(1, k)[:, 0],
                     min=LOG_SCALE_MIN)
    u2 = u[:, nr]
    return torch.clamp(mean + torch.exp(ls)
                       * (torch.log(u2) - torch.log1p(-u2)), -1.0, 1.0)


def step_seed(seed: int, step: int) -> int:
    """The plain version's generator seed for global step ``step``: the low
    32 bits of ``seed`` above the low 32 bits of ``step``."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


@torch.no_grad()
def wavernn_sample_loop_plain(cond, w, *, mode="MOL", n_classes=30,
                              noise=None, seed=0, state=None,
                              teacher=None, weight_dtype=None):
    """The plain PyTorch version of the kernel of ``weight_dtype``, with the
    TPU kernel's rounding: for ``SampleLoopWeights`` (``weight_dtype=None``)
    a bf16 stream and bf16 activations before each split product when the
    matrices are bf16, float32 everywhere when they are float32; for
    ``Int8SampleLoopWeights`` (``"int8"``, ``"int8_mxu"``) its int8 modes.

    cond (T, B, feat + 4*adim) = [mels_up | a1 | a2 | a3 | a4]. Uniforms come
    from ``noise`` (T, B, n_draw), or else from ``seed``: the uniforms of
    global step s (``state["step"]`` + t) are drawn by a generator seeded
    with ``step_seed(seed, s)``, so a run split into chunks with carried
    state draws what one run draws. ``teacher`` (T, B), when
    given, replaces the fed-back sample of step t with teacher[t] (the
    kernel's own output, to check each step's function without feedback
    divergence). Returns (samples (T, B), state)."""
    _check(cond, w, mode, weight_dtype)
    T, B, _ = cond.shape
    state = init_state(B, w.d, cond.device) if state is None else state
    h1, h2, x_prev = state["h1"].clone(), state["h2"].clone(), state["x"].clone()
    nd = n_draw(mode, n_classes, w.n_out)
    step = (_bf16_step(cond, w) if weight_dtype is None
            else _int8_step(cond, w, weight_dtype == "int8_mxu"))
    out = torch.empty(T, B, device=cond.device)
    gen = torch.Generator(cond.device) if noise is None else None
    for t in range(T):
        logits, h1, h2 = step(t, x_prev.float(), h1, h2)
        if noise is None:
            gen.manual_seed(step_seed(seed, state["step"] + t))
            u = torch.rand(B, nd, generator=gen, device=cond.device)
        else:
            u = noise[t]
        out[t] = _sample(logits, u, mode, n_classes)
        x_prev = out[t] if teacher is None else teacher[t].float()
    return out, {"h1": h1, "h2": h2, "x": x_prev, "step": state["step"] + T}


_COUNTER = {None: "launches", "int8": "launches_int8",
            "int8_mxu": "launches_int8_mxu"}
# fold rows per block of the kernels (NR in the source), and their threads
TILE_ROWS = 8
TILE_THREADS = 512


def _check_tensors(cond, w, weight_dtype):
    mat_dt = torch.bfloat16 if weight_dtype is None else torch.int8
    for x in w.tensors():
        if x.device != cond.device or not x.is_contiguous():
            raise ValueError("weights must be contiguous on the cond device")
        if x.dtype != (mat_dt if x.dim() == 2 else torch.float32):
            raise TypeError(f"the kernel takes {mat_dt} matrices and float32 "
                            "vectors")
    if weight_dtype is None and (w.d % 16 or w.fc % 16):
        raise ValueError("the bf16 kernel needs d and fc multiples of 16")
    if weight_dtype is not None and (w.d % 32 or w.fc % 32):
        raise ValueError("the int8 kernels need d and fc multiples of 32")


def _launch(cond, w, mode, n_classes, noise, seed, state, weight_dtype):
    T, B, C = cond.shape
    _check_tensors(cond, w, weight_dtype)
    lib = _build.load("wavernn_cell")
    nd = n_draw(mode, n_classes, w.n_out)
    if mode == "MOL" and w.n_out % 3:
        raise ValueError("MOL needs 3 * nr_mix outputs")
    if mode == "RAW" and w.n_out < n_classes:
        raise ValueError("RAW needs n_classes outputs")
    if noise is not None:
        if noise.shape != (T, B, nd) or noise.dtype != torch.float32:
            raise ValueError(f"noise must be float32 (T, B, {nd})")
        noise = noise.contiguous()
    # every mode reads the TPU kernel's bf16 stream (stream_dt)
    cond = cond.to(torch.bfloat16).contiguous()
    state = init_state(B, w.d, cond.device) if state is None else state
    h1 = state["h1"].float().contiguous().clone()
    h2 = state["h2"].float().contiguous().clone()
    x = state["x"].float().contiguous().clone()
    out = torch.empty(T, B, device=cond.device)
    ints = [T, B, C, w.feat, w.adim, w.d, w.fc, w.n_out,
            w.wic.shape[1], MODES.index(mode),
            w.n_out // 3 if mode == "MOL" else n_classes, nd]
    vecs = [w.ix, w.bI, w.bi1, w.bh1, w.bi2, w.bh2, w.bf1, w.bf2, w.bf3]
    scales = ([] if weight_dtype is None
              else [getattr(w, "s_" + k) for k in MATRICES])
    ptrs = _build.ptr_array([cond, *vecs, *w.packed(), *scales, h1, h2, x,
                             noise, out])
    suffix = "" if weight_dtype is None else "_" + weight_dtype
    fn = getattr(lib, f"wavernn_sample_loop{suffix}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptrs, _build.int_array(ints), LOG_SCALE_MIN, state["step"],
             seed & (2 ** 64 - 1), TILE_THREADS,
             torch.cuda.current_stream(cond.device).cuda_stream)
    _build.check(err, f"wavernn_sample_loop{suffix}")
    counter = _COUNTER[weight_dtype]
    setattr(wavernn_sample_loop, counter,
            getattr(wavernn_sample_loop, counter) + 1)
    return out, {"h1": h1, "h2": h2, "x": x, "step": state["step"] + T}


def quant_div_mismatches(n: int, device) -> tuple:
    """On the card: of n seeded pairs (a, b) from the int8_mxu quantizer's
    domain, how many the kernel's division (``quant_div`` in the source)
    rounds otherwise than IEEE division, and how many it checked."""
    lib = _build.load("wavernn_cell")
    cnt = torch.zeros(2, dtype=torch.int64, device=device)
    fn = lib.quant_div_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(n, cnt.data_ptr(),
                    torch.cuda.current_stream(cnt.device).cuda_stream),
                 "quant_div_check")
    bad, seen = cnt.tolist()
    return bad, seen


def wavernn_sample_loop(cond, w, *, mode="MOL", n_classes=30, noise=None,
                        seed=0, state=None, weight_dtype=None):
    """Run the sample loop: the kernel of ``weight_dtype`` for CUDA tensors,
    its plain version (uniforms drawn per global step from ``seed``,
    ``step_seed``) for CPU tensors.

    ``w``: ``SampleLoopWeights`` (bf16 for the kernel) when ``weight_dtype``
    is None, ``Int8SampleLoopWeights`` for ``"int8"`` and ``"int8_mxu"``.
    cond (T, B, feat + 4*adim); ``noise`` optional uniforms (T, B, n_draw);
    ``state`` {h1, h2, x, step} from an earlier chunk continues the same
    sequence: the kernel's Philox stream and the plain version's draws are
    both indexed by the global step.
    Returns (samples (T, B), state). Each kernel counts its launches:
    ``launches`` (bf16), ``launches_int8``, ``launches_int8_mxu``."""
    _check(cond, w, mode, weight_dtype)
    if cond.is_cuda:
        return _launch(cond, w, mode, n_classes, noise, seed, state,
                       weight_dtype)
    return wavernn_sample_loop_plain(cond, w, mode=mode, n_classes=n_classes,
                                     noise=noise, seed=seed, state=state,
                                     weight_dtype=weight_dtype)


wavernn_sample_loop.launches = 0
wavernn_sample_loop.launches_int8 = 0
wavernn_sample_loop.launches_int8_mxu = 0
