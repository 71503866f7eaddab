"""Bulk synthesis in a closed loop, one batch in flight: each batch is
``texts`` texts through ``TTSSynthesizer.predict_many`` (one reference mel
and one speaker vector for the batch), then one
``VocoderSynthesizer.generate_many`` of their (mel + 4) / 8.

Every batch has the same set of text lengths (``tokens``, spread evenly),
in an order and with letters drawn from the seed, so every seed does the
same work. The window runs whole batches until ``--seconds`` have passed;
its length is from its start to the last batch's waveforms on the host.

The check takes a sample drawn from the seed of the window's utterances,
the longest among them: the served mel against the reference decoder run
over the served frames, its length against the length the traffic sets,
and every readable sample of the served waveform against the reference
sample loop run over the served samples."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import stats
from ..counts import (PEAKS, ar_decode_ops, ar_encode_ops, conditioning_ops,
                      sample_loop)
from ..params import ar_spec, draw, to_host, wavernn_spec
from ..reference import ar as ref_ar
from ..reference import wavernn as ref_voc
from ..reference.layers import tree
from ..reference.philox import philox_uniforms, torch_uniforms
from .base import (Clock, alphabet, derive, free_cuda, merged,
                   random_text, rng, span, spread_lengths, write_config_dir)


class Synthesis:
    """What the bulk and stream drivers share: the weights, the two
    synthesizers, the per-request conditioning and the reference."""

    def __init__(self, traffic: dict, config: dict, seed: int, device,
                 work):
        self.t, self.cfg, self.seed = traffic, config, seed
        self.device = torch.device(device)
        self.alphabet = alphabet()
        self.c_ar = merged(config, "autoregressive")
        self.c_voc = merged(config, "wavernn")
        self.cfg_dir = write_config_dir(config, work)
        self.clock = Clock(self.device)
        self.control = None

    def build(self):
        from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
        over = self.cfg.get("overrides", {})
        self.w_ar = draw(ar_spec(self.c_ar, self.alphabet),
                         derive(self.seed, "ar"), self.device,
                         over.get("autoregressive", []))
        self.w_voc = draw(wavernn_spec(self.c_voc), derive(self.seed, "voc"),
                          self.device, over.get("wavernn", []))
        self.tts = TTSSynthesizer(self.cfg_dir, to_host(self.w_ar),
                                  self.device, step=0,
                                  phonemizer_backend="grapheme")
        self.voc = VocoderSynthesizer(self.cfg_dir, to_host(self.w_voc),
                                      self.device)
        self.r = self.tts.r
        self.hop = self.c_voc["hop_length"]
        self.sr = self.c_voc["sampling_rate"]

    def conditioning(self, *key):
        """A seeded reference mel (ref_frames, n_mels) in [-4, 4] and a
        unit speaker vector (speaker_embed_dim,)."""
        g = rng(self.seed, "cond", *key)
        n_mels = self.c_ar["mel_channels"]
        mel = np.clip(g.normal(-1.0, 1.5, (self.t["ref_frames"], n_mels)),
                      -4, 4).astype(np.float32)
        spk = g.normal(0, 1, self.c_ar["speaker_embed_dim"])
        return mel, (spk / np.linalg.norm(spk)).astype(np.float32)

    def free_program(self):
        for name in ("tts", "voc"):
            if hasattr(self, name):
                delattr(self, name)
        free_cuda()

    # -- the reference ------------------------------------------------------

    def ref_strided(self, ref_mel, dtype):
        x = torch.as_tensor(ref_mel, dtype=dtype, device=self.device)
        return x[:-1][::self.r][None]

    def uniforms(self, seed, steps, rows, n_rows):
        if self.device.type == "cuda":
            u = philox_uniforms(seed, steps, rows, 11)
        else:
            u = torch_uniforms(seed, steps, rows, 11, n_rows)
        return torch.as_tensor(u, device=self.device)

    def vocoder_gap(self, step, mel, wav, seed, first_row, n_rows_launch,
                    batched: bool):
        """``judge``'s (gap, on the clip) of every checked sample of one
        utterance: ``mel`` the vocoder's input (t, n_mels) in [0, 1],
        ``wav`` the served waveform, ``first_row`` its first fold row in
        the launch of ``n_rows_launch`` rows seeded ``seed``."""
        c = self.c_voc
        if not hasattr(self, "p_voc64"):
            self.p_voc64 = tree(self.w_voc, torch.float64, self.device)
        cond = ref_voc.upsample(self.p_voc64, c, torch.as_tensor(
            mel, dtype=torch.float64, device=self.device))
        if batched:
            target, overlap = c["voc_target"], c["voc_overlap"]
            cond = ref_voc.fold(cond, target, overlap).transpose(0, 1)
            rows = cond.shape[1]
            vals, known = ref_voc.observed_rows(
                np.asarray(wav, np.float64), rows, target, overlap, self.hop)
            free_until = int(np.argmax(known[0]))
            settle = overlap
        else:
            rows, cond = 1, cond[:len(wav)][:, None]
            vals = np.asarray(wav, np.float64)[None]
            known = np.ones_like(vals, bool)
            free_until, settle = 0, 0
        T = cond.shape[0]
        u = self.uniforms(seed, range(T), range(first_row, first_row + rows),
                          n_rows_launch)
        gap, clip = ref_voc.teacher_gap(
            step, cond, torch.as_tensor(vals.T, device=self.device),
            torch.as_tensor(known.T, device=self.device), u, free_until)
        return gap[settle:].flatten(), clip[settle:].flatten()

    def fold_rows(self, frames: int) -> int:
        """The fold rows of a mel of ``frames`` frames."""
        return ref_voc.n_rows(frames * self.hop, self.c_voc["voc_target"],
                              self.c_voc["voc_overlap"])

    def mel_gap(self, p, ids, ref_mel, spk, served: list, dtype):
        """The widest |served - reference| frame value: the reference (or,
        for the control, the reference in TF32) run over the served
        histories."""
        ref = ref_ar.teacher_frames(p, self.c_ar, ids,
                                    self.ref_strided(ref_mel, dtype), spk,
                                    served, self.r)
        if self.control is None:
            other = [torch.as_tensor(m, dtype=dtype, device=self.device)
                     for m in served]
        else:
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                p32 = tree(self.w_ar, torch.float32, self.device)
                other = [x.to(dtype) for x in ref_ar.teacher_frames(
                    p32, self.c_ar, ids,
                    self.ref_strided(ref_mel, torch.float32),
                    spk.float(), served, self.r)]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
        return [float((a - b).abs().max()) for a, b in zip(other, ref)]


def gap_numbers(gaps) -> dict:
    """The vocoder's readings over every checked sample that the clip at
    +-1 does not decide (``reference.wavernn.judge``'s gap reads 0 where
    the served sample and the reference's both sit on the same bound): how
    many, and the 99.9th percentile of the gap."""
    gap = torch.cat([g[~torch.isnan(g)] for g, _ in gaps])
    clip = torch.cat([c[~torch.isnan(c)] for _, c in gaps]).bool()
    gap = gap[~clip]
    if gap.numel() == 0:
        return {"samples_checked": 0}
    q = torch.quantile(gap[torch.isfinite(gap)][:16_000_000].double(), 0.999)
    return {"samples_checked": gap.numel(), "sample_gap_p999": float(q)}


class Driver(Synthesis):
    def setup(self):
        self.build()
        self.lengths = spread_lengths(*self.t["tokens"], self.t["texts"])
        self.batches = []
        self.run_batch(-1)                     # warm-up: the same shapes

    def batch_inputs(self, k: int):
        g = rng(self.seed, "batch", k)
        order = g.permutation(len(self.lengths))
        texts = [random_text(g, self.lengths[i]) for i in order]
        return texts, *self.conditioning("batch", k)

    def run_batch(self, k: int):
        texts, ref_mel, spk = self.batch_inputs(k)
        t = self.t
        tts_seed, voc_seed = derive(self.seed, "tts", k), derive(self.seed,
                                                                "voc", k)
        t0 = time.perf_counter()
        with span("predict_many"):
            mels = self.tts.predict_many(
                texts, ref_mel, spk, max_length=t["max_length"],
                seed=tts_seed, max_frames_per_token=t["max_frames_per_token"])
        t1 = time.perf_counter()
        voc_in = [(m + 4.0) / 8.0 for m in mels]
        with span("generate_many"):
            wavs = self.voc.generate_many(voc_in, seed=voc_seed,
                                          int8_weights=self.control)
        t2 = time.perf_counter()
        return {"k": k, "texts": texts, "ref_mel": ref_mel, "spk": spk,
                "mels": mels, "wavs": wavs, "voc_seed": voc_seed,
                "predict_s": t1 - t0, "generate_s": t2 - t1, "done": t2}

    def run(self, seconds: float, units=None):
        """Whole batches until ``seconds`` have passed, or ``units``
        batches (the traced window)."""
        self.clock.sync()
        start = time.perf_counter()
        k = 0
        with span("window"):
            while True:
                with span("batch"):
                    self.batches.append(self.run_batch(k))
                k += 1
                if (k == units if units else
                        time.perf_counter() - start >= seconds):
                    break
        self.window_s = self.batches[-1]["done"] - start

    def attempted(self) -> int:
        return sum(len(b["texts"]) for b in self.batches)

    def failed(self) -> int:
        return 0

    def describe(self) -> str:
        secs = [b["predict_s"] + b["generate_s"] for b in self.batches]
        return (f"batches in the window: {len(self.batches)}, "
                f"{self.attempted()} utterances; seconds a batch: "
                + " ".join(f"{x:.3f}" for x in secs))

    def end_to_end(self) -> dict:
        audio = sum(len(w) for b in self.batches for w in b["wavs"]) / self.sr
        return {"audio_s_per_s": stats.rate(audio, self.window_s)}

    def layer_context(self) -> dict:
        """Counts and host spans of the window for the per-layer readers."""
        c, r = self.c_ar, self.r
        steps = ops_dec = ops_voc = ops_b1 = 0.0
        rows_steps = []
        for b in self.batches:
            n_ids = [len(x) + 2 for x in b["texts"]]
            n_enc = max(n_ids)
            lens = [len(m) for m in b["mels"]]
            steps += math.ceil(max(lens) / r)
            for n, L in zip(n_ids, lens):
                ops_dec += ar_encode_ops(c, n, self.t["ref_frames"] // r)
                ops_dec += ar_decode_ops(c, math.ceil(L / r), n_enc, r)
                ops_voc += conditioning_ops(self.c_voc, L)
            rows = sum(self.fold_rows(L) for L in lens)
            T = self.c_voc["voc_target"] + 2 * self.c_voc["voc_overlap"]
            rows_steps.append((rows, T))
            ops_b1 += sample_loop(self.c_voc, T, rows)["ops"]
        return {
            "decode_steps": steps,
            "predict_s": sum(b["predict_s"] for b in self.batches),
            "generate_s": sum(b["generate_s"] for b in self.batches),
            "batches": len(self.batches),
            "b1_launches": rows_steps,
            "b1_bound_s": sum(sample_loop(self.c_voc, T, n)["bound_s"]
                              for n, T in rows_steps),
            "peak_s": (ops_b1 / PEAKS["bf16_ops_per_s"]
                       + (ops_dec + ops_voc) / PEAKS["fp32_ops_per_s"]),
            "window_s": self.window_s}

    # -- correctness --------------------------------------------------------

    def sample(self):
        """(batch, index) pairs drawn from the seed: the longest utterance
        of a drawn batch, and ``check_utterances`` - 1 more."""
        g = rng(self.seed, "check")
        n = self.t["check"]["utterances"]
        picks = []
        b = int(g.integers(len(self.batches)))
        lens = [len(m) for m in self.batches[b]["mels"]]
        picks.append((b, int(np.argmax(lens))))
        while len(picks) < n:
            b = int(g.integers(len(self.batches)))
            i = int(g.integers(len(self.batches[b]["mels"])))
            if (b, i) not in picks:
                picks.append((b, i))
        return picks

    def expected_length(self, n_ids: int) -> int:
        t, r = self.t, self.r
        cap = max(int(n_ids * t["max_frames_per_token"]), r)
        return min(cap, (t["max_length"] // r + 1) * r)

    @torch.no_grad()
    def check(self, dtype=torch.float64) -> dict:
        p_ar = tree(self.w_ar, dtype, self.device)
        step = ref_voc.SampleStep(
            tree(self.w_voc, torch.float32, self.device), self.c_voc,
            bf16=self.device.type == "cuda")
        mel_gaps, len_off, gaps = [], 0, []
        for b, i in self.sample():
            B = self.batches[b]
            ids_all = [ref_ar.text_ids(x, self.alphabet) for x in B["texts"]]
            n_max = max(len(x) for x in ids_all)
            ids = torch.zeros(1, n_max, dtype=torch.long, device=self.device)
            ids[0, :len(ids_all[i])] = torch.as_tensor(ids_all[i])
            spk = torch.as_tensor(B["spk"], dtype=dtype,
                                  device=self.device)[None, None]
            mel = B["mels"][i]
            len_off += len(mel) != self.expected_length(len(ids_all[i]))
            mel_gaps += self.mel_gap(p_ar, ids, B["ref_mel"], spk, [mel],
                                     dtype)
            rows = [self.fold_rows(len(m)) for m in B["mels"]]
            gaps.append(self.vocoder_gap(
                step, (mel + 4.0) / 8.0, B["wavs"][i], B["voc_seed"],
                sum(rows[:i]), sum(rows), True))
        return {"mel_gap": max(mel_gaps), "length_off": len_off,
                **gap_numbers(gaps)}
