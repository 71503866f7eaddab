"""The sample loop's uniforms, worked out again from the seed.

On the card the WaveRNN sample loop draws its uniforms from Philox4x32-10
(Salmon et al., SC'11) with the counter (low 32 bits of the global step,
high 32 bits of it, fold row, draw // 4) and the key (low, high 32 bits of
the seed), taking word draw % 4 and its top 24 bits: u = ((v >> 8) + 0.5)
/ 2**24. Here that is computed with numpy's wrapping uint64 arithmetic.

On the CPU the program's plain sample loop draws its uniforms of step s
from a torch generator seeded with (seed mod 2**32) << 32 | s, (rows,
draws) at once; ``torch_uniforms`` repeats that for the CPU tests.
Either way the uniforms are clipped to [1e-5, 1 - 1e-5].
"""
from __future__ import annotations

import numpy as np
import torch

M32 = np.uint64(0xFFFFFFFF)
CLIP = 1e-5


def _mulhilo(a: int, b):
    p = np.uint64(a) * b
    return p >> np.uint64(32), p & M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds of Philox4x32 on uint64 arrays holding 32-bit words."""
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + np.uint64(0x9E3779B9)) & M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & M32
    return c0, c1, c2, c3


def philox_uniforms(seed: int, steps, rows, n_draw: int) -> np.ndarray:
    """Uniforms (len(steps), len(rows), n_draw), float32, clipped, of the
    given global steps and fold rows."""
    seed &= (1 << 64) - 1
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    s = np.asarray(steps, np.uint64)[:, None, None]
    b = np.asarray(rows, np.uint64)[None, :, None]
    j = np.arange(n_draw, dtype=np.uint64)[None, None, :]
    shape = (s.shape[0], b.shape[1], n_draw)
    words = philox4x32(np.broadcast_to(s & M32, shape),
                       np.broadcast_to(s >> np.uint64(32), shape),
                       np.broadcast_to(b, shape),
                       np.broadcast_to(j >> np.uint64(2), shape), k0, k1)
    pick = (j & np.uint64(3)).astype(np.int64)
    v = np.choose(np.broadcast_to(pick, shape), words)
    u = ((v >> np.uint64(8)).astype(np.float64) + 0.5) / 16777216.0
    return np.clip(u.astype(np.float32), CLIP, 1.0 - CLIP)


def torch_uniforms(seed: int, steps, rows, n_draw: int,
                   n_rows: int) -> np.ndarray:
    """The CPU plain loop's uniforms of the given steps and rows, its
    launch holding ``n_rows`` rows."""
    gen = torch.Generator()
    out = np.empty((len(steps), len(rows), n_draw), np.float32)
    for i, s in enumerate(steps):
        gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (int(s) & 0xFFFFFFFF))
        out[i] = torch.rand(n_rows, n_draw, generator=gen).numpy()[rows]
    return np.clip(out, CLIP, 1.0 - CLIP)
