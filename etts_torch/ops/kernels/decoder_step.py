"""Fused single-stream AR decode: the CUDA kernel ``csrc/decoder_step.cu``
(``decode_cluster``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``etts/ops/pallas/decoder_step.py``
(``_fused_decode_call`` -> ``_make_kernel``, ``pallas_call`` at :464).
Bound on the H100: each step depends on the last and reads all ~5.7 M bf16
decoder weights (11.4 MB at flagship width) once for one query, through a
chain of 41 dependent phases; a step costs the weight bytes over the L2
read rate of the SMs that stream them, plus one cluster barrier and one L2
round trip for each phase, and the phases set it. Design: one thread-block
cluster (a compile-time number of blocks, ``cluster_size()``) runs the whole
decode in one launch; each block streams its 1/C of every product's weight
rows from L2 and writes its slice of the output into every block's shared
memory before the cluster's hardware barrier; attention is split by key
rows and combined from partial softmaxes; activations are read from shared
memory without bank conflicts and the postnet's frames share each weight
read (see the note in the source). ``phase_split`` runs the kernel's timer
build (``-DETTS_DECODE_TIMER``), which splits a step phase by phase.

Geometry (``can_fuse``): batch 1, all-dense decoder blocks with a uniform
head count of depth a multiple of 8, d <= 512, and every width the kernel
reads as float4 (mel, prenet, d, FFN, postnet filters) a multiple of 4.
``fused_decode`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import inspect
from dataclasses import dataclass, fields
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

BN_EPS = 1e-3
# the phases of the kernel's timer build (-DETTS_DECODE_TIMER), in the
# order of its counters; the decoder-block phases are summed over blocks
PHASES = ("prenet", "QKV + cache write", "self-attention",
          "self output projection + LN", "cross query + attention",
          "cross output projection + LN", "FFN", "FinalProj", "postnet",
          "stop head, guards, feedback")
TIMER = "ETTS_DECODE_TIMER"
CLUSTER = "DECODE_CLUSTER"      # -D define of the blocks in the cluster


@dataclass
class DecodeWeights:
    """Decoder weights in the kernel's layout for one utterance: matrices
    (out, in) in ``dtype`` (bf16 for the kernel), vectors float32, per-block
    tensors stacked on a leading block axis. ``ck``/``cv`` hold the
    cross-attention K/V of this utterance's encoder output, heads
    concatenated (n_enc, d); postnet convs are (out, k * in) over a window
    of k frames."""
    pw1: torch.Tensor
    pb1: torch.Tensor
    pw2: torch.Tensor
    pb2: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wos: torch.Tensor
    bos: torch.Tensor
    wqc: torch.Tensor
    bqc: torch.Tensor
    woc: torch.Tensor
    boc: torch.Tensor
    f1: torch.Tensor
    bf1: torch.Tensor
    f2: torch.Tensor
    bf2: torch.Tensor
    lns: torch.Tensor
    lnb: torch.Tensor
    ck: torch.Tensor
    cv: torch.Tensor
    fpw: torch.Tensor
    fpb: torch.Tensor
    pc0: torch.Tensor
    pcm: torch.Tensor
    pcl: torch.Tensor
    ps: torch.Tensor
    psh: torch.Tensor
    outs: torch.Tensor
    outb: torch.Tensor
    stopw: torch.Tensor
    stopb: torch.Tensor
    pe: torch.Tensor            # positional table strided by r: (rows, d)
    r: int
    n_heads: int
    k: int
    stop_index: int
    start_value: float

    @property
    def d(self) -> int:
        return self.wqc.shape[1]

    @property
    def mel(self) -> int:
        return self.pw1.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.wqkv.shape[0]

    @property
    def n_post(self) -> int:
        return self.pcm.shape[0] + 2

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def weight_bytes(self) -> int:
        """Bytes of everything but the positional table."""
        return sum(x.numel() * x.element_size() for x in self.tensors()
                   if x is not self.pe)


def can_fuse(model) -> bool:
    """The kernel's geometry: all-dense decoder blocks with a uniform head
    count whose depth is a multiple of 8 (the attention reads 16-byte
    slices of a key row), d at most 512 (a warp holds a LayerNorm's vector
    in registers), and the widths that it reads as float4 rows and splits
    over the cluster in groups of 4 rows (mel, prenet, d, FFN, postnet
    filters) multiples of 4."""
    heads = set(model.decoder_num_heads)
    if (model.decoder_dense_blocks != len(model.decoder_num_heads)
            or len(heads) != 1):
        return False
    d = model.decoder_model_dimension
    block = model.Decoder.blocks()[0]
    widths = (model.mel_channels, model.DecoderPrenet.d1.out_features, d,
              block.ffn.d1.out_features,
              model.Postnet.conv_blocks.conv_0.out_channels)
    return (d % (8 * heads.pop()) == 0 and d <= 512
            and all(x % 4 == 0 for x in widths))


def _project(lin, e):
    """The float32 projection of the encoder output, whatever the model's
    compute dtype (the cross-attention K/V of etts' decode)."""
    return F.linear(e, lin.weight.float(), lin.bias.float())


@torch.no_grad()
def decode_weights(model, enc_output, r: int,
                   dtype=torch.bfloat16) -> DecodeWeights:
    """Gather an ``AutoregressiveTransformer``'s decoder weights for the
    kernel (port of ``build_decode_inputs``, `decoder_step.py:307-442`):
    QKV fused, BatchNorm folded to scale/shift (inference semantics, eps
    1e-3), cross-attention K/V projected from ``enc_output`` (1, n, enc)
    in float32 (a bf16 model's encoder output too, as etts' fused decode
    reads it)."""
    if not can_fuse(model):
        raise ValueError("fused decode needs all-dense decoder blocks with a "
                         "uniform head count of depth a multiple of 8, "
                         "d <= 512, and "
                         "mel, prenet, d, FFN and postnet widths that are "
                         "multiples of 4")
    if enc_output.shape[0] != 1:
        raise ValueError("fused decode runs one utterance (batch 1)")
    if not 1 <= r <= model.max_r:
        raise ValueError(f"r must be in [1, {model.max_r}]")
    mat = lambda w: w.detach().to(dtype).contiguous()
    vec = lambda b: b.detach().float().contiguous()
    blocks = model.Decoder.blocks()

    def stack(fn, cast):
        return torch.stack([cast(fn(b)) for b in blocks]).contiguous()

    def qkv(b, part):
        m = b.sarn.mha
        return torch.cat([getattr(getattr(m, n), part)
                          for n in ("wq", "wk", "wv")], 0)

    def lns(part):
        return lambda b: torch.stack([
            getattr(b.sarn.ln, part), getattr(b.sarn.last_ln, part),
            getattr(b.carn.layernorm, part), getattr(b.ffn.ln, part),
            getattr(b.ffn.last_ln, part)])

    e = enc_output[0].float()
    mel = model.mel_channels
    post = model.Postnet.conv_blocks
    n_post = post.n_layers

    def conv_w(conv):               # (out, in, k) -> (out, k * in)
        w = conv.weight.detach()
        return w.permute(0, 2, 1).reshape(w.shape[0], -1)

    def fold(conv, norm):
        s = norm.weight / torch.sqrt(norm.running_var + BN_EPS)
        return s, (conv.bias - norm.running_mean) * s + norm.bias

    convs = [getattr(post, f"conv_{i}") for i in range(n_post - 1)]
    norms = [getattr(post, f"norm_{i}") for i in range(n_post - 1)]
    convs.append(post.last_conv)
    norms.append(post.norm_last)
    folded = [fold(c, n) for c, n in zip(convs, norms)]
    pw = max(x[0].shape[0] for x in folded)
    pad = lambda v: F.pad(v.detach().float(), (0, pw - v.shape[0]))
    cf = convs[0].weight.shape[0]
    mids = [conv_w(c) for c in convs[1:-1]]
    on = post.norm_out
    s_out = on.weight / torch.sqrt(on.running_var + BN_EPS)
    return DecodeWeights(
        pw1=mat(model.DecoderPrenet.d1.weight),
        pb1=vec(model.DecoderPrenet.d1.bias),
        pw2=mat(model.DecoderPrenet.d2.weight),
        pb2=vec(model.DecoderPrenet.d2.bias),
        wqkv=stack(lambda b: qkv(b, "weight"), mat),
        bqkv=stack(lambda b: qkv(b, "bias"), vec),
        wos=stack(lambda b: b.sarn.mha.dense.weight, mat),
        bos=stack(lambda b: b.sarn.mha.dense.bias, vec),
        wqc=stack(lambda b: b.carn.mha.wq.weight, mat),
        bqc=stack(lambda b: b.carn.mha.wq.bias, vec),
        woc=stack(lambda b: b.carn.mha.dense.weight, mat),
        boc=stack(lambda b: b.carn.mha.dense.bias, vec),
        f1=stack(lambda b: b.ffn.d1.weight, mat),
        bf1=stack(lambda b: b.ffn.d1.bias, vec),
        f2=stack(lambda b: b.ffn.d2.weight, mat),
        bf2=stack(lambda b: b.ffn.d2.bias, vec),
        lns=stack(lns("weight"), vec), lnb=stack(lns("bias"), vec),
        ck=stack(lambda b: _project(b.carn.mha.wk, e), mat),
        cv=stack(lambda b: _project(b.carn.mha.wv, e), mat),
        fpw=mat(model.FinalProj.weight[:r * mel]),
        fpb=vec(model.FinalProj.bias[:r * mel]),
        pc0=mat(conv_w(convs[0])),
        pcm=(mat(torch.stack(mids)) if mids else
             torch.zeros(0, cf, cf * post.kernel_size, dtype=dtype,
                         device=e.device)),
        pcl=mat(conv_w(convs[-1])),
        ps=torch.stack([pad(s) for s, _ in folded]).contiguous(),
        psh=torch.stack([pad(sh) for _, sh in folded]).contiguous(),
        outs=vec(s_out), outb=vec(on.bias - on.running_mean * s_out),
        stopw=mat(model.Postnet.stop_linear.weight),
        stopb=vec(model.Postnet.stop_linear.bias),
        pe=model.Decoder.pos_encoding[::r].float().contiguous(),
        r=r, n_heads=model.decoder_num_heads[0], k=post.kernel_size,
        stop_index=model.stop_prob_index,
        start_value=float(model.mel_start_value))


def _guards(w: DecodeWeights, attn_stop_patience, max_frames_per_token):
    """(patience, frame cap) as the kernel takes them, -1 = off; the cap
    is static per text: max(int(n_enc * F), r)."""
    cap = (-1 if max_frames_per_token is None
           else max(int(w.ck.shape[1] * max_frames_per_token), w.r))
    return (-1 if attn_stop_patience is None else int(attn_stop_patience)), cap


@torch.no_grad()
def fused_decode_plain(w: DecodeWeights, *, max_steps: int,
                       prenet_dropout: float = 0.5, noise=None,
                       generator=None, stop_enabled: bool = True,
                       attn_stop_patience: Optional[int] = None,
                       max_frames_per_token: Optional[float] = None,
                       teacher=None):
    """The plain PyTorch version of the kernel, step for step: float32
    arithmetic on the stored weights, KV caches kept in the matrices' dtype
    (bf16 when the weights are bf16, as in the kernel). Dropout uniforms come
    from ``noise`` (max_steps, P + d) or ``generator``. ``teacher``
    (max_steps * r, mel), when given, supplies the fed-back frame of each
    step (the kernel's own output, to check each step's function without
    feedback divergence).
    Returns (mel (max_steps * r, mel), length in frames, steps run)."""
    f = lambda x: x.float()
    d, mel, r, k, nh = w.d, w.mel, w.r, w.k, w.n_heads
    P = w.pw1.shape[0]
    dev = w.pw1.device
    depth = d // nh
    cache_dt = w.wqkv.dtype
    patience, cap = _guards(w, attn_stop_patience, max_frames_per_token)
    n_enc = w.ck.shape[1]
    kc = torch.zeros(w.n_blocks, max_steps, d, dtype=cache_dt, device=dev)
    vc = torch.zeros_like(kc)
    post_w = [f(w.pc0)] + [f(x) for x in w.pcm] + [f(w.pcl)]
    widths = [mel] + [w.pc0.shape[0]] * (w.n_post - 1)
    hist = [torch.zeros(k - 1 + r, c, device=dev) for c in widths]
    out = torch.zeros(max_steps * r, mel, device=dev)
    frame = torch.full((mel,), w.start_value, device=dev)
    ln = lambda x, blk, j: F.layer_norm(x, (d,), w.lns[blk, j], w.lnb[blk, j],
                                        1e-6)

    def drop(x, u):
        if prenet_dropout == 0.0 and u is None:
            return x
        keep = 1.0 - prenet_dropout
        if u is None:
            u = torch.rand(x.shape, generator=generator, device=dev)
        return torch.where(u < keep, x / max(keep, 1e-8), torch.zeros_like(x))

    def attend(q, K, V):
        qh = q.view(nh, 1, depth)
        Kh = f(K).view(-1, nh, depth).transpose(0, 1)
        s = (qh @ Kh.transpose(1, 2))[:, 0] / depth ** 0.5   # (nh, n)
        p = torch.softmax(s, -1)
        o = (p[:, None] @ f(V).view(-1, nh, depth).transpose(0, 1))[:, 0]
        return o.reshape(d), p.sum(0)

    stopped, length, ctr, steps = False, 0, 0, 0
    for t in range(max_steps):
        u1, u2 = ((noise[t, :P], noise[t, P:P + d]) if noise is not None
                  else (None, None))
        h = drop(torch.relu(f(w.pw1) @ frame + w.pb1), u1)
        h = drop(torch.relu(f(w.pw2) @ h + w.pb2), u2)
        x = h * d ** 0.5 + w.pe[t]
        for blk in range(w.n_blocks):
            qkv = f(w.wqkv[blk]) @ x + w.bqkv[blk]
            kc[blk, t] = qkv[d:2 * d].to(cache_dt)
            vc[blk, t] = qkv[2 * d:].to(cache_dt)
            attn, _ = attend(qkv[:d], kc[blk, :t + 1], vc[blk, :t + 1])
            so = ln(f(w.wos[blk]) @ torch.cat([x, attn]) + w.bos[blk], blk, 0)
            x1 = ln(so + x, blk, 1)
            q2 = f(w.wqc[blk]) @ x1 + w.bqc[blk]
            attn2, psum = attend(q2, w.ck[blk], w.cv[blk])
            if patience >= 0 and blk == w.n_blocks - 1:
                focus = int(psum.argmax())
                ctr = ctr + 1 if focus >= n_enc - 2 else 0
            co = f(w.woc[blk]) @ torch.cat([x1, attn2]) + w.boc[blk]
            x2 = ln(co + x1, blk, 2)
            y = f(w.f2[blk]) @ (f(w.f1[blk]) @ x2 + w.bf1[blk]) + w.bf2[blk]
            x = ln(x2 + torch.relu(ln(y, blk, 3)), blk, 4)
        mlin = (f(w.fpw) @ x + w.fpb).view(r, mel)
        hist[0][k - 1:] = mlin
        for layer in range(w.n_post):
            win = hist[layer].unfold(0, k, 1).transpose(1, 2)   # (r, k, in)
            y = win.reshape(r, -1) @ post_w[layer].T
            n_o = y.shape[1]
            y = y * w.ps[layer, :n_o] + w.psh[layer, :n_o]
            if layer < w.n_post - 1:
                hist[layer + 1][k - 1:] = torch.tanh(y)
        final = (mlin + y) * w.outs + w.outb
        for hbuf in hist:
            hbuf[:k - 1] = hbuf[r:r + k - 1].clone()
        out[t * r:(t + 1) * r] = final
        steps = t + 1
        length = (t + 1) * r
        if stop_enabled:
            cls = (f(w.stopw) @ mlin.T + w.stopb[:, None]).argmax(0)
            hits = (cls == w.stop_index).nonzero()
            if len(hits):
                stopped, length = True, t * r + int(hits[0]) + 1
        if patience >= 0 and ctr >= patience and not stopped:
            stopped = True
        if cap >= 0 and (t + 1) * r >= cap and not stopped:
            stopped, length = True, min(length, cap)
        frame = final[-1] if teacher is None else teacher[(t + 1) * r - 1]
        if stopped:
            break
    return out, length, steps


def _launch(w: DecodeWeights, max_steps, prenet_dropout, noise, seed,
            stop_enabled, attn_stop_patience, max_frames_per_token,
            defines=(), timer=None):
    lib = _build.load("decoder_step", tuple(defines))
    dev = w.pw1.device
    for x in w.tensors():
        if x.device != dev or not x.is_contiguous():
            raise ValueError("decode weights must be contiguous on one device")
    mats = (w.pw1, w.pw2, w.wqkv, w.wos, w.wqc, w.woc, w.f1, w.f2, w.ck, w.cv,
            w.fpw, w.pc0, w.pcm, w.pcl, w.stopw)
    if any(x.dtype != torch.bfloat16 for x in mats):
        raise TypeError("the kernel takes bf16 weight matrices and K/V")
    if w.pe.shape[0] < max_steps:
        raise ValueError("max_steps exceeds the positional table")
    P, d = w.pw1.shape[0], w.d
    if noise is not None:
        if noise.shape != (max_steps, P + d) or noise.dtype != torch.float32:
            raise ValueError(f"noise must be float32 ({max_steps}, {P + d})")
        noise = noise.contiguous()
    patience, cap = _guards(w, attn_stop_patience, max_frames_per_token)
    kc = torch.empty(w.n_blocks, max_steps, d, dtype=torch.bfloat16,
                     device=dev)
    vc = torch.empty_like(kc)
    out = torch.zeros(max_steps * w.r, w.mel, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    pe = w.pe[:max_steps].contiguous()
    ptrs = _build.ptr_array([
        pe, w.pw1, w.pb1, w.pw2, w.pb2, w.wqkv, w.bqkv, w.wos, w.bos, w.wqc,
        w.bqc, w.woc, w.boc, w.f1, w.bf1, w.f2, w.bf2, w.lns, w.lnb, w.ck,
        w.cv, w.fpw, w.fpb, w.pc0, w.pcm if w.pcm.numel() else None, w.pcl,
        w.ps, w.psh, w.outs, w.outb, w.stopw, w.stopb, kc, vc, noise, out,
        lens])
    ints = _build.int_array([
        max_steps, w.r, d, w.n_heads, w.mel, P, w.f1.shape[1], w.ck.shape[1],
        w.n_blocks, w.k, w.n_post, w.pc0.shape[0], w.ps.shape[1],
        w.stop_index, int(stop_enabled), patience, cap])
    fn = lib.decode_cluster_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if timer is not None:
        set_timer = lib.decode_set_timer
        set_timer.argtypes = [ctypes.c_void_p]
        _build.check(set_timer(timer.data_ptr()), "fused_decode timer")
    err = fn(ptrs, ints, float(prenet_dropout), w.start_value,
             seed & (2 ** 64 - 1), torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise RuntimeError(f"fused_decode: no SM group of this card holds a "
                           f"cluster of {lib.decode_cluster_size()} blocks")
    _build.check(err, "fused_decode")
    if not defines:     # the main build's launch, not a measurement's
        fused_decode.launches += 1
    length, steps = lens.tolist()
    return out, length, steps


def fused_decode(w: DecodeWeights, *, max_steps: int,
                 prenet_dropout: float = 0.5, noise=None, seed: int = 0,
                 stop_enabled: bool = True,
                 attn_stop_patience: Optional[int] = None,
                 max_frames_per_token: Optional[float] = None):
    """Run the whole decode: the kernel when the weights are on the card,
    the plain version (generator seeded from ``seed``) on the CPU.
    Returns (mel (max_steps * r, mel), length in frames, steps run)."""
    kw = dict(stop_enabled=stop_enabled, attn_stop_patience=attn_stop_patience,
              max_frames_per_token=max_frames_per_token)
    if w.pw1.is_cuda:
        return _launch(w, max_steps, prenet_dropout, noise, seed, **kw)
    gen = None if noise is not None else torch.Generator().manual_seed(seed)
    return fused_decode_plain(w, max_steps=max_steps,
                              prenet_dropout=prenet_dropout, noise=noise,
                              generator=gen, **kw)


fused_decode.launches = 0


def cluster_size() -> int:
    """Blocks in the kernel's cluster, a compile-time constant (the
    library is built first if needed)."""
    return int(_build.load("decoder_step").decode_cluster_size())


def _measure(w: DecodeWeights, defines, timer=None, **kw):
    """``fused_decode``'s launch, with its options and their defaults, on
    the kernel built with extra ``-D`` ``defines``: not a launch of the main
    build, so not counted in ``fused_decode.launches``."""
    opts = inspect.signature(fused_decode).bind(w, **kw)
    opts.apply_defaults()
    if not w.pw1.is_cuda:
        raise ValueError("a measurement build runs on CUDA weights only")
    return _launch(**opts.arguments, defines=defines, timer=timer)


def launch_cluster(w: DecodeWeights, blocks: int, **kw):
    """``fused_decode`` (same options and result) on the kernel built with a
    cluster of ``blocks`` blocks, to time and check the size not chosen."""
    return _measure(w, (f"{CLUSTER}={blocks}",), **kw)


def phase_split(w: DecodeWeights, **kw):
    """One decode (``fused_decode``'s options) on the kernel's timer build:
    thread 0 of the first block reads clock64() at each phase boundary.
    Returns (cycles per phase summed over the steps, keyed by PHASES; the
    kernel's total cycles; steps run)."""
    buf = torch.zeros(len(PHASES) + 2, dtype=torch.int64,
                      device=w.pw1.device)
    _measure(w, (TIMER,), timer=buf, **kw)
    c = buf.tolist()
    return dict(zip(PHASES, c)), c[len(PHASES)], c[len(PHASES) + 1]
