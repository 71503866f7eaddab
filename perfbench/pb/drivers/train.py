"""The forward model's train step (``train/steps.py::
make_forward_train_step`` on a ``train/state.py::TrainState``) at batch
``batch`` in a closed loop.

A pool of ``pool`` utterances is made on the device from the seed: each
has a whole number of frames from ``frames`` (spread evenly, the same set
for every seed) cut into tokens of 2-12 frames, token ids, and a target
mel in [-4, 4], zero past its frames and padded to the ``max_frames``
bucket. Step j takes the rows of a seeded permutation of the pool, batch
after batch, and draws its dropout from a generator seeded from (seed, j).

Set-up builds one train state and runs its first ``setup_steps`` steps
through the same step and feed as the window, which then runs on that
state. The check runs the plain reference from the same weights over the
set-up's steps and the window's first three, and compares, for the first
three steps and again for the window's first three, the losses (of the
window, its first step's: on some seeds the two sides part faster over the
next two) and each parameter's change over the three steps, by norms leaf
by leaf, and the first step's gradient (as Adam's first moment holds it
after that step)."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import stats
from ..counts import PEAKS, forward_train_ops
from ..params import draw, forward_spec, to_host
from ..reference.forward import TrainReference
from .base import (Clock, alphabet, derive, free_cuda, merged, rng, span,
                   spread_lengths, write_config_dir)

BETA1 = 0.9
CHECKED = 3                     # steps compared at the start and the window's


class Driver:
    def __init__(self, traffic: dict, config: dict, seed: int, device, work):
        self.t, self.cfg, self.seed = traffic, config, seed
        self.device = torch.device(device)
        self.alphabet = alphabet()
        self.c = merged(config, "forward")
        self.cfg_dir = write_config_dir(config, work)
        self.clock = Clock(self.device)
        self.fault = None
        self.control = None

    # -- the traffic --------------------------------------------------------

    def make_pool(self):
        """(mels (P, max_frames, n_mels), ids (P, n_max), durations (P,
        n_max), frames (P,), tokens (P,)) on the device."""
        t, c = self.t, self.c
        g = rng(self.seed, "pool")
        frames = spread_lengths(*t["frames"], t["pool"])
        lo, hi = t["token_frames"]
        durs = []
        for f in frames:
            d = []
            while sum(d) < f:
                d.append(int(g.integers(lo, hi + 1)))
            d[-1] -= sum(d) - f
            if d[-1] < lo:                  # fold a short last token back
                d[-2] += d.pop()
            durs.append(d)
        n_max = max(len(d) for d in durs)
        P = len(frames)
        dur = np.zeros((P, n_max), np.float32)
        ids = np.zeros((P, n_max), np.int64)
        vocab = len(self.alphabet)
        for i, d in enumerate(durs):
            dur[i, :len(d)] = d
            ids[i, :len(d)] = g.integers(1, vocab + 1, len(d))
        gen = torch.Generator(self.device).manual_seed(derive(self.seed, "mel"))
        mel = torch.randn(P, c["max_frames"], c["mel_channels"],
                          generator=gen, device=self.device)
        mel = torch.clamp(mel * 1.5 - 1.0, -4.0, 4.0)
        keep = (torch.arange(c["max_frames"], device=self.device)[None]
                < torch.as_tensor(frames, device=self.device)[:, None])
        mel = mel * keep[..., None]
        self.frames = np.asarray(frames)
        self.tokens = np.asarray([len(d) for d in durs])
        self.pool = (mel, torch.as_tensor(ids, device=self.device),
                     torch.as_tensor(dur, device=self.device))
        self.order = rng(self.seed, "order").permutation(P)

    def rows(self, j: int) -> np.ndarray:
        b = self.t["batch"]
        P = len(self.order)
        start = (j * b) % P
        return self.order[np.arange(start, start + b) % P]

    def batch(self, j: int):
        r = torch.as_tensor(self.rows(j), device=self.device)
        mel, ids, dur = (x[r] for x in self.pool)
        n = int(self.tokens[self.rows(j)].max())
        return mel, ids[:, :n].contiguous(), dur[:, :n].contiguous()

    def step_seed(self, j: int) -> int:
        return derive(self.seed, "step", j)

    # -- set-up and the window ----------------------------------------------

    def setup(self):
        from etts_torch.convert import load_into
        from etts_torch.text import default_tokenizer
        from etts_torch.train.state import TrainState
        from etts_torch.train.steps import make_forward_train_step
        from etts_torch.utils.config import build_forward
        from etts_torch.utils.precision import pin_float32
        pin_float32()                   # as the program's entry points do
        if self.control:                # the control: TF32 products
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        self.make_pool()
        self.w = draw(forward_spec(self.c, self.alphabet),
                      derive(self.seed, "forward"), self.device)
        self.model = load_into(build_forward(
            self.c, default_tokenizer(False).vocab_size,
            dropout_rate=self.c["dropout_rate"]), to_host(self.w)).to(
                self.device)
        self.state = TrainState(self.model, self.c["learning_rate_tts_schedule"])
        self.step = make_forward_train_step(self.model, self.c["max_frames"])
        self.names = list(self.state.names)
        self.j = 0
        self.start = self.record(self.snapshot(), self.t["setup_steps"],
                                 grad=True)

    def first_grad(self) -> list:
        """After the first step, the gradient that Adam's first moment
        holds."""
        opt = self.state.optimizer
        return [opt.state[p]["exp_avg"].detach() / (1 - BETA1)
                if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                for p in self.state.params]

    def params(self) -> list:
        return [p.detach().clone() for p in self.state.params]

    def snapshot(self) -> dict:
        """The state before the steps that ``record`` runs."""
        return {"first": self.j, "p0": self.params(), "losses": []}

    def record(self, rec: dict, steps: int, stop=None,
               grad: bool = False) -> dict:
        """Run ``steps`` steps, or until ``stop(steps run)`` and at least
        ``CHECKED``; keep in ``rec`` what the check reads of the first
        ``CHECKED``: the losses (on the device, read after the window),
        each parameter's change and, with ``grad``, the first gradient."""
        n = 0
        while True:
            m = self.run_step()
            n += 1
            if n <= CHECKED:
                rec["losses"].append(m["loss"])
            if grad and n == 1:
                rec["g"] = self.first_grad()
            if n == CHECKED:
                rec["p3"] = self.params()
            if n >= CHECKED and (n >= steps if stop is None else stop(n)):
                return rec

    def run_step(self):
        batch = self.batch(self.j)
        if self.fault == "half_batch":
            batch = tuple(x[:len(x) // 2] for x in batch)
        with span("train_step"):
            m = self.step(self.state, batch, self.step_seed(self.j))
        self.j += 1
        return m

    def run(self, seconds: float, units=None):
        rec = self.snapshot()
        self.clock.sync()
        start = time.perf_counter()
        first = self.j
        with span("window"):
            self.window = self.record(rec, units, None if units else (
                lambda n: time.perf_counter() - start >= seconds))
            self.clock.sync()
        self.window_s = time.perf_counter() - start
        self.window_steps = range(first, self.j)

    def end_to_end(self) -> dict:
        frames = sum(int(self.frames[self.rows(j)].sum())
                     for j in self.window_steps)
        return {"train_frames_per_s": stats.rate(frames, self.window_s)}

    def attempted(self) -> int:
        return len(self.window_steps)

    def failed(self) -> int:
        return 0

    def describe(self) -> str:
        return f"train steps in the window: {len(self.window_steps)}"

    def layer_context(self) -> dict:
        ops = 0.0
        for j in self.window_steps:
            r = self.rows(j)
            ops += sum(forward_train_ops(self.c, int(n), int(f))
                       for n, f in zip(self.tokens[r], self.frames[r]))
        return {"peak_s": ops / PEAKS["fp32_ops_per_s"],
                "steps": len(self.window_steps),
                "window_s": self.window_s}

    # -- correctness --------------------------------------------------------

    def free_program(self):
        for name in ("model", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        free_cuda()

    def check(self, dtype=torch.float64) -> dict:
        ref = TrainReference(self.w, {**self.c}, dtype, self.device)
        index = {n: i for i, n in enumerate(ref.names)}
        pick = [index[self.leaf(n, index)] for n in self.names]
        out = {}
        for prefix, rec, n_loss in (("", self.start, CHECKED),
                                    ("window_", self.window, 1)):
            while ref.t < rec["first"]:
                ref.step(self.ref_batch(ref.t, dtype), self.step_seed(ref.t))
            p0 = [ref.params[i].detach().clone() for i in pick]
            losses = []
            for j in range(rec["first"], rec["first"] + CHECKED):
                losses.append(ref.step(self.ref_batch(j, dtype),
                                       self.step_seed(j)))
                if j == rec["first"]:
                    g_ref = [ref.grads[i] for i in pick]
            g_norm = torch.stack([x.norm() for x in g_ref])
            moved = (g_norm >= 1e-3 * g_norm.median()).tolist()
            served = [float(x) for x in rec["losses"][:n_loss]]
            out.update({
                prefix + "loss_gap": max(abs(a - b) / abs(b)
                                         for a, b in zip(served, losses)),
                prefix + "change_gap": worst(
                    [b - a for a, b, m in zip(rec["p0"], rec["p3"], moved)
                     if m],
                    [ref.params[i].detach() - a
                     for i, a, m in zip(pick, p0, moved) if m]),
                prefix + "leaves_left_out": moved.count(False)})
            if "g" in rec:
                out[prefix + "grad_gap"] = worst(rec["g"], g_ref)
        return out

    def ref_batch(self, j: int, dtype):
        mel, ids, dur = self.batch(j)
        return mel.to(dtype), ids, dur.to(dtype)

    @staticmethod
    def leaf(torch_name: str, index: dict) -> str:
        """The reference's leaf of a program parameter: the module path,
        and its kernel, scale or embedding for a ``weight``."""
        path, _, leaf = torch_name.rpartition(".")
        base = path.replace(".", "/") + "/" if path else ""
        if leaf != "weight":
            return base + leaf
        for cand in ("kernel", "scale", "embedding"):
            if base + cand in index:
                return base + cand
        raise KeyError(torch_name)


def worst(program: list, reference: list) -> float:
    """The largest gap between the two norms of a leaf, over the larger of
    that leaf's reference norm and the median leaf's."""
    a = torch.stack([x.double().norm() for x in program])
    b = torch.stack([x.double().norm() for x in reference])
    scale = torch.maximum(b, b.median())
    return float(((a - b).abs() / scale).max())
