#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``etts_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build both CUDA kernels (one
     nvcc per source, started together);
  2. fused AR decode kernel against its plain version at flagship width on
     the 14k-step export (r = 10): dropout 0, dropout 0.5 with shared
     uniforms, and three cases that must stop early, on copies of the
     weights where needed: a frame cap inside a group, the
     attention-completion stop, and the stop class first firing inside a
     group;
  3. WaveRNN sample-loop kernel against its plain version on conditioning
     from the 26k-step export, B in {1, 5, 11}, T >= 2000, with shared
     uniforms; a chunked run with state carry against a one-shot run;
  4. the main path text + reference wav -> wav through TTSSynthesizer and
     VocoderSynthesizer, with both kernels' launch counts read around it;
  5. times (CUDA events), bounds, the plain versions' times, decode ms per
     step and the end-to-end real-time factor, each beside the card; the
     sample loop is also held against its plain version at the main path's
     shapes there, on the run that times the plain version.

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TTS_W = ROOT / "artifacts/soak/ar_best_14k_params_fp16.npz"
VOC_W = ROOT / "artifacts/soak/voc_gta26k_params_fp16.npz"
CONFIG = ROOT / "configs/default"
SENTENCE = ("Scientists at the CERN laboratory say they have discovered "
            "a new particle.")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, and the bf16 rate,
# the type of both functions' products (bf16 weights, and activations cast
# to bf16 before each product in the TPU kernels), whatever cores the port
# computes them on.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
DECODE_TOL = 5e-3          # max |mel| difference, kernel vs plain
STEP_TOL = 1e-3            # per-step sample difference, kernel vs plain
STEP_AGREE = 0.999         # share of steps within STEP_TOL


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def say(card_line, msg):
    print(f"[{card_line}] {msg}", flush=True)


def cuda_ms(fn, reps, warm=True):
    """Mean CUDA-event time in ms of ``reps`` calls of fn (after one
    warm-up call when ``warm``), and the last call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def bound(n_bytes, n_ops):
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_BF16 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ref_wav(seed=0, seconds=2.0, sr=16000):
    """Seeded vowel-like reference: a gliding harmonic tone plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 12))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t) ** 2)
    wav = wav + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


def random_sample_weights(like, n_out, dev, seed=0):
    """Sample-path weights of the flagship widths drawn from a seed
    (normal, 1/sqrt(fan-in)), for a kernel check whose samples spread over
    (-1, 1) and, in RAW mode, over 512 classes."""
    import torch
    from etts_torch.ops.kernels.wavernn_cell import SampleLoopWeights
    g = torch.Generator().manual_seed(seed)
    d, fc, feat, adim = like.d, like.fc, like.feat, like.adim

    def w(n_in, n_o):
        return torch.randn(n_in, n_o, generator=g) / n_in ** 0.5

    def b(n):
        return 0.1 * torch.randn(n, generator=g)
    # small logits; for MOL (n_out = 30) log-scales near -3, so that most
    # samples fall inside (-1, 1) rather than on the clip
    bf3 = b(n_out)
    if n_out == 30:
        bf3[20:] -= 3.0
    return SampleLoopWeights.from_flax_layout(
        w(1 + feat + adim, d), b(d), w(d, 3 * d), w(d, 3 * d), b(3 * d),
        b(3 * d), w(d + adim, 3 * d), w(d, 3 * d), b(3 * d), b(3 * d),
        w(d + adim, fc), b(fc), w(fc + adim, fc), b(fc),
        0.1 * w(fc, n_out), bf3, feat=feat, dtype=torch.bfloat16,
        device=dev)


def attention_at_end(w):
    """A copy of the decode weights whose last block's cross-attention
    looks at the last encoder row from the first step on: its query is a
    bias of ones alone, and only that row's key answers it, with a score of
    4 in every head. So the attention-completion stop must fire."""
    import dataclasses
    last = w.n_blocks - 1
    depth = w.d // w.n_heads
    wqc, bqc, ck = w.wqc.clone(), w.bqc.clone(), w.ck.clone()
    wqc[last] = 0
    bqc[last] = 1
    ck[last] = 0
    ck[last, -1] = 4 / depth ** 0.5
    return dataclasses.replace(w, wqc=wqc, bqc=bqc, ck=ck)


def interior_stop_weights(w, max_steps):
    """A copy of the decode weights whose stop class first fires inside an
    r-frame group after the first steps, and the length it must stop at.

    The postnet's last layer and the output norm are made neutral, so the
    kernel's output frames are the pre-postnet frames that the stop head
    reads; one run without the stop gives them. The stop head is then
    rebuilt: the other classes' logits are 0, and the stop logit is a.x -
    thr, with a solved (least norm) so that a.x is one higher on the
    target frame than on each frame before it, and thr halfway between
    that frame's a.x and the largest before it. Target frames are the
    middle of a group from the fourth step on, with fewer frames before
    them than mel channels; the first whose gap survives a's bf16 rounding
    is taken."""
    import dataclasses
    import torch
    from etts_torch.ops.kernels import decoder_step as dstep
    psh = w.psh.clone()
    psh[-1] = 0
    nw = dataclasses.replace(w, pcl=torch.zeros_like(w.pcl), psh=psh,
                             outs=torch.ones_like(w.outs),
                             outb=torch.zeros_like(w.outb))
    mlin, _, _ = dstep.fused_decode(nw, max_steps=max_steps,
                                    prenet_dropout=0.0, stop_enabled=False)
    x = mlin.double().cpu()
    r, s = w.r, w.stop_index
    for i in range(3 * r + r // 2, min(w.mel, max_steps * r), r):
        a = torch.linalg.pinv(x[i] - x[:i]) @ torch.ones(i, dtype=x.dtype)
        a = a.to(w.stopw.dtype)
        score = x[:i + 1] @ a.double()
        below = float(score[:i].max())
        gap = float(score[i]) - below
        if gap > 1e-2 and gap > 1e-3 * float(score.abs().max()):
            stopw = torch.zeros_like(w.stopw)
            stopw[s] = a.to(stopw.device)
            stopb = torch.zeros_like(w.stopb)
            stopb[s] = -(below + float(score[i])) / 2
            return dataclasses.replace(nw, stopw=stopw, stopb=stopb), i + 1
    raise RuntimeError("no target frame's stop score stands apart from the "
                       "frames before it")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "etts_torch").is_dir() or not TTS_W.exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card, build ----
    cl = card()
    print(cl, flush=True)
    from etts_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.build("decoder_step", "wavernn_cell")
    say(cl, f"built both kernels in {time.perf_counter() - t0:.1f} s")
    for name in ("decoder_step", "wavernn_cell"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(cl, f"{name}: {line.strip()}")

    from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
    from etts_torch.models.wavernn import (_clamp_mels, _conditioning_streams,
                                           fold_with_overlap)
    from etts_torch.ops.kernels import decoder_step as dstep
    from etts_torch.ops.kernels import wavernn_cell as wcell
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tts = TTSSynthesizer(CONFIG, TTS_W, "cuda", step=14000,
                         phonemizer_backend="grapheme")
    voc = VocoderSynthesizer(CONFIG, VOC_W, "cuda")
    if tts.r != 10 or tts.prenet_dropout != 0.0:
        raise RuntimeError(f"schedules at 14k: r={tts.r}, "
                           f"dropout={tts.prenet_dropout}")
    wav_ref = ref_wav()
    ref_mel = tts.mel_from_wav(wav_ref)
    rng = np.random.default_rng(0)
    spk = rng.standard_normal(256).astype(np.float32)
    spk /= np.linalg.norm(spk)
    max_length = 1000
    max_steps = max_length // tts.r + 1

    # ---- 2. fused decode kernel vs plain ----
    m = tts.model
    with torch.no_grad():
        ids = torch.from_numpy(tts.encode_text(SENTENCE))[None].to(dev)
        ref = m.encode_ref(torch.from_numpy(ref_mel).to(dev), tts.r)
        enc, _ = m.encode(ids, ref, torch.from_numpy(spk).to(dev)[None, None])
    w = dstep.decode_weights(m, enc, tts.r, torch.bfloat16)
    P, d = w.pw1.shape[0], w.d
    gen = torch.Generator(dev).manual_seed(1)
    noise = torch.rand(max_steps, P + d, device=dev, generator=gen)
    full = max_steps * tts.r
    cap = 377                   # a frame cap that lands inside a group
    stop_w, stop_at = interior_stop_weights(w, max_steps)
    failures = []       # comparisons that failed; reported at the end
    dec_err = 0.0
    # (label, weights, options, the length the case must stop at or None)
    cases = (
        ("dropout 0", w, dict(prenet_dropout=0.0), None),
        ("dropout 0.5, shared uniforms", w,
         dict(prenet_dropout=0.5, noise=noise), None),
        (f"frame cap at {cap} frames", w,
         dict(prenet_dropout=0.0,
              max_frames_per_token=(cap + 0.5) / w.ck.shape[1]), cap),
        ("attention-completion stop, patience 3", attention_at_end(w),
         dict(prenet_dropout=0.0, attn_stop_patience=3, stop_enabled=False),
         3 * tts.r),
        (f"stop class first firing at frame {stop_at - 1}", stop_w,
         dict(prenet_dropout=0.0), stop_at))
    for label, cw, kw, want in cases:
        k_mel, k_len, k_steps = dstep.fused_decode(cw, max_steps=max_steps,
                                                   **kw)
        # the same history: the plain version is fed the kernel's frames,
        # so float32 rounding cannot grow through the feedback loop
        p_mel, p_len, p_steps = dstep.fused_decode_plain(
            cw, max_steps=max_steps, teacher=k_mel, **kw)
        f_mel, f_len, _ = dstep.fused_decode_plain(cw, max_steps=max_steps,
                                                   **kw)
        torch.cuda.synchronize()
        n = max(k_len, p_len)
        err = float((k_mel[:n] - p_mel[:n]).abs().max())
        nf = max(k_len, f_len)
        free = float((k_mel[:nf] - f_mel[:nf]).abs().max())
        ok = (k_len == p_len and k_steps == p_steps and err <= DECODE_TOL
              and bool(torch.isfinite(k_mel).all()))
        if want is not None:        # a guard case must stop, and there
            ok = ok and k_len == want < full
        say(cl, f"fused_decode vs plain ({label}): length {k_len} vs "
                f"{p_len}" + (f" (want {want} < {full})" if want else "")
                + f", steps {k_steps} vs {p_steps}, max |dmel| "
                f"{err:.3e} (tol {DECODE_TOL}); free-running: length "
                f"{f_len}, max |dmel| {free:.3e}")
        if not ok:
            failures.append(f"fused_decode vs plain ({label})")
        dec_err = max(dec_err, err)

    # ---- 3. sample-loop kernel vs plain ----
    # conditioning: the 26k vocoder's upsample network on the reference
    # wav's mel, folded into rows of 2000 + 2 * 100 samples
    with torch.no_grad():
        vm = _clamp_mels((torch.from_numpy(ref_mel).to(dev) + 4.0) / 8.0)
        while vm.shape[0] < 130:          # enough frames for 11 folds
            vm = torch.cat([vm, vm], 0)
        vm = F.pad(vm[None], (0, 0, voc.model.pad, voc.model.pad))
        up, aux = voc.model.upsample(vm)
        cond_all = _conditioning_streams(fold_with_overlap(up, 2000, 100),
                                         fold_with_overlap(aux, 2000, 100))
    T = cond_all.shape[0]
    ww = voc.weights
    voc_err = 0.0
    rand_mol = random_sample_weights(ww, 30, dev)
    weight_sets = [("26k export, MOL", ww, "MOL", 30),
                   ("seeded random weights, MOL", rand_mol, "MOL", 30),
                   ("seeded random weights, RAW 512 classes",
                    random_sample_weights(ww, 512, dev), "RAW", 512)]
    for label, wts, mode, n_cls in weight_sets:
        for B in (1, 5, 11):
            cond = cond_all[:, :B].contiguous()
            nd = wcell.n_draw(mode, n_cls, wts.n_out)
            g = torch.Generator(dev).manual_seed(B)
            u = torch.rand(T, B, nd, device=dev, generator=g)
            kw = dict(mode=mode, n_classes=n_cls, noise=u)
            k_out, _ = wcell.wavernn_sample_loop(cond, wts, **kw)
            # the same history: the plain version is fed the kernel's
            # samples, so a rare Gumbel-argmax tie broken the other way by
            # float32 rounding stays one differing step
            t_out, _ = wcell.wavernn_sample_loop_plain(cond, wts,
                                                       teacher=k_out, **kw)
            f_out, _ = wcell.wavernn_sample_loop_plain(cond, wts, **kw)
            torch.cuda.synchronize()
            diff = (k_out - t_out).abs()
            agree = float((diff <= STEP_TOL).float().mean())
            err = float(diff.max())
            free = float((k_out - f_out).abs().max())
            voc_err = max(voc_err, err)
            inside = float((k_out.abs() < 1).float().mean())
            say(cl, f"wavernn_sample_loop vs plain ({label}), B={B} T={T}: "
                    f"per-step (same history) max |d| {err:.3e}, "
                    f"{agree:.6f} of steps within {STEP_TOL}; free-running "
                    f"max |d| {free:.3e}; samples mean "
                    f"{float(k_out.mean()):.4f}, std "
                    f"{float(k_out.std()):.4f}, {inside:.4f} inside (-1, 1)")
            if agree < STEP_AGREE or not bool(torch.isfinite(k_out).all()):
                failures.append(f"wavernn_sample_loop vs plain ({label}, "
                                f"B={B})")
    cond = cond_all[:, :5].contiguous()
    one, st1 = wcell.wavernn_sample_loop(cond, ww, seed=7)
    a, st = wcell.wavernn_sample_loop(cond[:1000], ww, seed=7)
    b, st2 = wcell.wavernn_sample_loop(cond[1000:], ww, seed=7, state=st)
    chunk_err = float((torch.cat([a, b]) - one).abs().max())
    state_err = float((st1["h1"] - st2["h1"]).abs().max())
    say(cl, f"wavernn_sample_loop chunked (1000 + {T - 1000}) vs one-shot: "
            f"max |d| {chunk_err:.3e}, final h1 max |d| {state_err:.3e} "
            f"(tol 0)")
    if chunk_err != 0.0 or state_err != 0.0:
        failures.append("wavernn_sample_loop chunked state carry")

    # ---- 4. the main path ----
    dstep.fused_decode.launches = 0
    wcell.wavernn_sample_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tts.predict(SENTENCE, ref_mel, spk, max_length=max_length, seed=0)
    mel = out["mel"]
    wav = voc.generate((mel + 4.0) / 8.0, seed=0)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {"fused_decode": dstep.fused_decode.launches,
                "wavernn_sample_loop": wcell.wavernn_sample_loop.launches}
    audio_s = wav.shape[0] / tts.config["sampling_rate"]
    say(cl, f"main path: {len(tts.encode_text(SENTENCE))} tokens -> "
            f"{mel.shape[0]} frames in {out['steps']} steps -> "
            f"{wav.shape[0]} samples; launches {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if wav.shape[0] != (mel.shape[0] - 1) * tts.config["hop_length"]:
        raise RuntimeError("wav length is not (t_mel - 1) * hop")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise RuntimeError("wav not finite or outside [-1, 1]")
    if not np.isfinite(mel).all():
        raise RuntimeError("mel not finite")

    # ---- 5. times and bounds at the main path's shapes ----
    # phase 2's decode weights are the main path's: same text, reference
    # and speaker
    steps = out["steps"]
    kw = dict(max_steps=max_steps, prenet_dropout=tts.prenet_dropout)
    dec_ms, _ = cuda_ms(lambda: dstep.fused_decode(w, **kw), 5)
    dec_plain_ms, _ = cuda_ms(lambda: dstep.fused_decode_plain(w, **kw), 1)
    n_enc = w.ck.shape[1]
    # multiply-adds per step: the prenet, blocks and FinalProj once; the
    # postnet convs and the stop head once for each of the r new frames;
    # attention over t + 1 cached rows and n_enc encoder rows
    per_step = sum(x.numel() for x in (w.pw1, w.pw2, w.wqkv, w.wos, w.wqc,
                                        w.woc, w.f1, w.f2, w.fpw))
    per_frame = sum(x.numel() for x in (w.pc0, w.pcm, w.pcl, w.stopw))
    dec_ops = sum(2 * (per_step + tts.r * per_frame)
                  + 4 * d * w.n_blocks * (t + 1 + n_enc)
                  for t in range(steps))
    dec_bytes = (w.weight_bytes() + steps * d * 4
                 + steps * tts.r * w.mel * 4)
    dec_bound, dec_by = bound(dec_bytes, dec_ops)

    # the sample loop at the main path's conditioning (folded as
    # VocoderSynthesizer.generate folds it), on the seeded sample-path
    # weights (the 26k export's samples all clip at +1) and one shared noise
    # tensor: the kernel timed, the plain version timed on the same inputs
    # and fed the kernel's samples, and each step compared
    target = voc.config.get("voc_target", 11000)
    overlap = voc.config.get("voc_overlap", 550)
    with torch.no_grad():
        vm = _clamp_mels(torch.from_numpy((mel + 4.0) / 8.0).to(dev))
        vm = F.pad(vm[None], (0, 0, voc.model.pad, voc.model.pad))
        up, aux = voc.model.upsample(vm)
        cond = _conditioning_streams(fold_with_overlap(up, target, overlap),
                                     fold_with_overlap(aux, target, overlap))
    T, B, _ = cond.shape
    mode, n_cls = voc.model.mode, voc.model.n_classes
    nd = wcell.n_draw(mode, n_cls, ww.n_out)
    u = torch.rand(T, B, nd, device=dev,
                   generator=torch.Generator(dev).manual_seed(2))
    kw = dict(mode=mode, n_classes=n_cls, noise=u)
    wcell.wavernn_sample_loop(cond, rand_mol, **kw)          # warm-up
    voc_ms, (k_out, _) = cuda_ms(
        lambda: wcell.wavernn_sample_loop(cond, rand_mol, **kw), 3,
        warm=False)
    voc_plain_ms, (t_out, _) = cuda_ms(
        lambda: wcell.wavernn_sample_loop_plain(cond, rand_mol, teacher=k_out,
                                                **kw), 1, warm=False)
    diff = (k_out - t_out).abs()
    agree = float((diff <= STEP_TOL).float().mean())
    voc_err = max(voc_err, float(diff.max()))
    say(cl, f"wavernn_sample_loop vs plain (seeded random weights, {mode}, "
            f"main path's shapes), B={B} T={T}: per-step (same history) max "
            f"|d| {float(diff.max()):.3e}, {agree:.6f} of steps within "
            f"{STEP_TOL}; {float((k_out.abs() < 1).float().mean()):.4f} of "
            f"samples inside (-1, 1)")
    if agree < STEP_AGREE or not bool(torch.isfinite(k_out).all()):
        failures.append("wavernn_sample_loop vs plain (main path's shapes)")
    w_elems = sum(x.numel() for x in (ww.wI, ww.wi1, ww.wh1, ww.wi2, ww.wh2,
                                      ww.wf1, ww.wf2, ww.wf3))
    voc_ops = 2 * w_elems * T * B
    # inputs read once: bf16 weights, the conditioning at the function's
    # bf16 width, the uniforms; output: one float32 sample per step and row
    voc_bytes = (rand_mol.n_bytes() + cond.numel() * 2 + u.numel() * 4
                 + T * B * 4)
    voc_bound, voc_by = bound(voc_bytes, voc_ops)

    say(cl, f"fused_decode: {dec_ms:.3f} ms per decode of {steps} steps "
            f"({dec_ms / steps:.4f} ms/step), plain {dec_plain_ms:.1f} ms, "
            f"bound {dec_bound:.4f} ms by {dec_by}, launches "
            f"{launches['fused_decode']}")
    say(cl, f"wavernn_sample_loop: {voc_ms:.2f} ms for T={T} x B={B} "
            f"({voc_ms / T * 1e3:.2f} us/step), plain {voc_plain_ms:.1f} ms, "
            f"bound {voc_bound:.4f} ms by {voc_by}, launches "
            f"{launches['wavernn_sample_loop']}")
    say(cl, f"end to end: {e2e:.3f} s for {audio_s:.3f} s of audio, "
            f"RTF {e2e / audio_s:.4f}")
    kernels = [
        {"name": "fused_decode", "route": "cuda",
         "source": "etts_torch/csrc/decoder_step.cu",
         "replaces": "etts/ops/pallas/decoder_step.py:464",
         "launches": launches["fused_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None},
        {"name": "wavernn_sample_loop", "route": "cuda",
         "source": "etts_torch/csrc/wavernn_cell.cu",
         "replaces": "etts/ops/pallas/wavernn_cell.py:351",
         "launches": launches["wavernn_sample_loop"], "max_abs_err": voc_err,
         "ms": voc_ms, "plain_ms": voc_plain_ms, "bound_ms": voc_bound,
         "bound_by": voc_by, "library_ms": None},
    ]
    for kern in kernels:
        if not all(math.isfinite(kern[k]) for k in
                   ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            raise RuntimeError(f"non-finite measurement: {kern}")
    if failures:
        raise RuntimeError(f"failed: {failures}")
    print(cl, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
