"""What the drivers share: the configuration written out as the program
reads it, the seeded draws, the spans, the window's clock and the
comparison with the limits."""
from __future__ import annotations

import hashlib
import time
from pathlib import Path

import numpy as np
import torch
import yaml
from torch.profiler import record_function

ALPHABET_FILE = Path(__file__).resolve().parent.parent / "reference" / "alphabet.txt"
TEXT_CHARS = "abcdefghijklmnopqrstuvwxyz "


def alphabet() -> str:
    """The TTS models' sorted phoneme and punctuation alphabet."""
    return ALPHABET_FILE.read_text(encoding="utf-8").rstrip("\n")


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` and ``parts``."""
    h = hashlib.blake2b(repr((seed, *parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *parts))


def span(name: str):
    """A span of the benchmark's own, seen in the device trace."""
    return record_function("pb." + name)


def write_config_dir(config: dict, work: Path) -> Path:
    """The configuration's YAML files, as the program's ``load_config``
    reads a directory."""
    work.mkdir(parents=True, exist_ok=True)
    for name, body in config["files"].items():
        (work / name).write_text(yaml.safe_dump(body))
    return work


def merged(config: dict, kind: str) -> dict:
    """The model file ``<kind>_config.yaml`` under the data file, as the
    program merges them."""
    f = config["files"]
    return {**f[f"{kind}_config.yaml"], **f["data_config.yaml"]}


def random_text(g: np.random.Generator, n_ids: int) -> str:
    """A text of lowercase letters and spaces that the AR model reads as
    n_ids ids (its start and end tokens included)."""
    idx = g.integers(0, len(TEXT_CHARS), n_ids - 2)
    return "".join(TEXT_CHARS[i] for i in idx)


def spread_lengths(lo: int, hi: int, n: int) -> list:
    """n whole lengths spread evenly over [lo, hi]: the same set for every
    seed; the seed only orders them."""
    if n == 1:
        return [hi]
    return [int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)]


class Clock:
    """The host clock, synchronised with the card before it is read."""

    def __init__(self, device: torch.device):
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        self.sync()
        return time.perf_counter()


def compare(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}): every number at or under its
    limit. A number that is NaN, or missing, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = [v, limit]
        ok = ok and (v == v) and v <= limit
    return ok, out


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
