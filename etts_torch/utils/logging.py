"""Training observability: ``ValueWindow`` (`etts/utils/display.py`) and
``ScalarLog``, the scalar part of etts' ``SummaryManager``
(`etts/utils/logging.py:75-90`). The scalars go under etts' tags
(``train/loss``, ``meta/reduction_factor``, ``mi/MINE_0`` ...) as JSON
lines, ``{"tag", "value", "step"}``, in ``log_dir/scalars.jsonl``; a
predicted mel, and the values of a histogram, go to ``log_dir`` as
``.npy``, and so does an image's array (a Tacotron's alignment). No
TensorBoard writer: the
card's machine has none."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["ValueWindow", "ScalarLog", "read_scalars"]


class ValueWindow:
    """Rolling average over the last ``window_size`` values."""

    def __init__(self, window_size=100):
        self._window_size = window_size
        self._values = []

    def append(self, x):
        self._values = self._values[-(self._window_size - 1):] + [x]

    @property
    def sum(self):
        return sum(self._values)

    @property
    def count(self):
        return len(self._values)

    @property
    def average(self):
        return self.sum / max(1, self.count)

    def reset(self):
        self._values = []


class ScalarLog:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "scalars.jsonl"

    def add_scalar(self, tag: str, value, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")

    def _save(self, values, tag: str, step: int) -> Path:
        path = self.log_dir / f"{tag.replace('/', '_')}_{step}.npy"
        np.save(path, np.asarray(values, np.float32))
        return path

    def save_mel(self, mel, tag: str, step: int) -> Path:
        """The mel (t, n_mels) as ``{tag with / as _}_{step}.npy``."""
        return self._save(mel, tag, step)

    def add_image(self, tag: str, values, step: int) -> Path:
        """The array etts' ``SummaryManager.add_image`` draws (an
        alignment (decoder steps, encoder steps)), kept as ``{tag with /
        as _}_{step}.npy``."""
        return self._save(values, tag, step)

    def add_histogram(self, tag: str, values, step: int) -> Path:
        """The values whose histogram etts' ``SummaryManager`` writes
        (`etts/utils/logging.py:111-115`), kept whole as
        ``{tag with / as _}_{step}.npy``: any histogram can be drawn from
        them."""
        return self._save(values, tag, step)


def read_scalars(log_dir) -> dict:
    """{tag: {step: value}} of ``log_dir``'s scalars, later lines winning."""
    out = {}
    with open(Path(log_dir) / "scalars.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out
