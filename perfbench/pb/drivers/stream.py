"""Streamed synthesis, one listener at a time in a closed loop: each stream
is ``TTSSynthesizer.stream`` of one text with ``mel_chunk`` decode steps a
chunk, its ``max_length`` taken in turn from ``max_lengths`` (the stream
applies no stop and no per-token cap, so that is the utterance's length),
its letters, reference mel and speaker vector drawn from the seed.

A gap is the time from one chunk's delivery on the host to the next's; a
stream's first gap runs from its request. The window runs whole streams
until ``--seconds`` have passed; the tail is over every gap of them.

The check takes the longest stream of the window and ``check.streams`` -
1 more drawn from the seed: the reference decodes the text greedily, and
runs the sample loop over the served samples on the conditioning of that
mel, one row whose state runs across the chunks."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import stats
from ..counts import PEAKS, ar_decode_ops, ar_encode_ops, conditioning_ops, sample_loop
from ..reference import ar as ref_ar
from ..reference import wavernn as ref_voc
from ..reference.layers import tree
from .base import derive, random_text, rng, span
from .bulk import Synthesis, gap_numbers


class Driver(Synthesis):
    def setup(self):
        self.build()
        self.streams = []
        self.run_stream(-1, min(self.t["max_lengths"]))     # warm-up

    def stream_inputs(self, k: int):
        g = rng(self.seed, "stream", k)
        lengths = self.t["tokens"]
        text = random_text(g, lengths[k % len(lengths)])
        return text, *self.conditioning("stream", k)

    def run_stream(self, k: int, max_length: int):
        text, ref_mel, spk = self.stream_inputs(k)
        seed = derive(self.seed, "stream", k)
        chunks, gaps = [], []
        t_req = last = time.perf_counter()
        with span("stream"):
            for wav in self.tts.stream(text, self.voc, ref_mel, spk,
                                       mel_chunk=self.t["mel_chunk"],
                                       max_length=max_length, seed=seed,
                                       int8_weights=self.control):
                now = time.perf_counter()
                gaps.append(now - last)
                last = now
                chunks.append(wav)
        return {"k": k, "text": text, "ref_mel": ref_mel, "spk": spk,
                "seed": seed, "max_length": max_length, "gaps": gaps,
                "wav": np.concatenate(chunks), "request": t_req,
                "done": last}

    def run(self, seconds: float, units=None):
        self.clock.sync()
        start = time.perf_counter()
        lengths = self.t["max_lengths"]
        k = 0
        with span("window"):
            while True:
                self.streams.append(self.run_stream(k, lengths[k % len(lengths)]))
                k += 1
                if (k == units if units else
                        time.perf_counter() - start >= seconds):
                    break
        self.window_s = self.streams[-1]["done"] - start

    def attempted(self) -> int:
        return len(self.streams)

    def failed(self) -> int:
        return 0

    def gaps(self) -> list:
        return [g for s in self.streams for g in s["gaps"]]

    def end_to_end(self) -> dict:
        return {"chunk_gap_p90_s": stats.percentile(self.gaps(), 90)}

    def describe(self) -> str:
        g = self.gaps()
        return (f"chunk gaps: {len(g)} in {len(self.streams)} streams, "
                f"{stats.beyond(g, 90)} beyond the 90th percentile")

    def layer_context(self) -> dict:
        c, r = self.c_ar, self.r
        ops_dec = ops_voc = ops_b1 = bound = 0.0
        chunk_samples = self.t["mel_chunk"] * r * self.hop
        launches = []
        for s in self.streams:
            steps = s["max_length"] // r + 1
            n = len(s["text"]) + 2
            ops_dec += ar_encode_ops(c, n, self.t["ref_frames"] // r)
            ops_dec += ar_decode_ops(c, steps, n, r)
            ops_voc += conditioning_ops(self.c_voc, steps * r)
            total = len(s["wav"])
            for a in range(0, total, chunk_samples):
                T = min(chunk_samples, total - a)
                loop = sample_loop(self.c_voc, T, 1)
                launches.append((1, T))
                ops_b1 += loop["ops"]
                bound += loop["bound_s"]
        return {"first_gaps": [s["gaps"][0] for s in self.streams],
                "b1_launches": launches, "b1_bound_s": bound,
                "peak_s": (ops_b1 / PEAKS["bf16_ops_per_s"]
                           + (ops_dec + ops_voc) / PEAKS["fp32_ops_per_s"]),
                "window_s": self.window_s}

    def sample(self):
        g = rng(self.seed, "check")
        n = min(self.t["check"]["streams"], len(self.streams))
        longest = int(np.argmax([len(s["wav"]) for s in self.streams]))
        rest = [i for i in range(len(self.streams)) if i != longest]
        return [longest] + [int(i) for i in g.permutation(rest)[:n - 1]]

    @torch.no_grad()
    def check(self, dtype=torch.float64) -> dict:
        p_ar = tree(self.w_ar, dtype, self.device)
        step = ref_voc.SampleStep(
            tree(self.w_voc, torch.float32, self.device), self.c_voc,
            bf16=self.device.type == "cuda")
        gaps, len_off = [], 0
        for i in self.sample():
            s = self.streams[i]
            ids = torch.as_tensor([ref_ar.text_ids(s["text"], self.alphabet)],
                                  device=self.device)
            spk = torch.as_tensor(s["spk"], dtype=dtype,
                                  device=self.device)[None, None]
            steps = s["max_length"] // self.r + 1
            mel = ref_ar.greedy(p_ar, self.c_ar, ids,
                                self.ref_strided(s["ref_mel"], dtype), spk,
                                steps, self.r)[0]
            len_off += len(s["wav"]) != steps * self.r * self.hop
            wav = s["wav"][:steps * self.r * self.hop]
            gaps.append(self.vocoder_gap(
                step, ((mel + 4.0) / 8.0).cpu().numpy(), wav, s["seed"] + 1,
                0, 1, False))
        return {"length_off": len_off,
                **gap_numbers(gaps)}
