"""Training observability: ``ValueWindow`` (`etts/utils/display.py`) and
``ScalarLog``, the scalar part of etts' ``SummaryManager``
(`etts/utils/logging.py:75-90`). The scalars go under etts' tags
(``train/loss``, ``meta/reduction_factor``, ``mi/MINE_0`` ...) as JSON
lines, ``{"tag", "value", "step"}``, in ``log_dir/scalars.jsonl``; a
predicted mel, and the values of a histogram, go to ``log_dir`` as
``.npy``, and so does an image's array (a Tacotron's alignment); audio
goes there as ``.wav``. No TensorBoard writer: the card's machine has
none. ``StepTrace`` is the ``torch.profiler`` trace of a range of training
steps that etts' drivers take with ``jax.profiler``. Under a process group
only rank 0 writes (`etts/utils/logging.py:44-50`): elsewhere a
``ScalarLog`` makes nothing and each of its calls does nothing, so the
drivers log unconditionally."""
from __future__ import annotations

import contextlib
import functools
import json
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import is_primary

__all__ = ["ValueWindow", "ScalarLog", "StepTrace", "read_scalars"]


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


def _primary_only(method):
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        return method(self, *args, **kwargs) if self.primary else None
    return wrapped


class ScalarLog:
    """The scalars, arrays and audio of a run under ``log_dir``, written
    by the primary process only (``primary``; its calls return None
    elsewhere)."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.primary = is_primary()
        if self.primary:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "scalars.jsonl"

    @_primary_only
    def add_scalar(self, tag: str, value, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")

    @_primary_only
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

    @_primary_only
    def add_audio(self, tag: str, wav, sample_rate: int, step: int) -> Path:
        """The waveform as ``{tag with / as _}_{step}.wav`` at
        ``sample_rate`` (``data.audio_io.save_wav``: 16-bit, scaled down
        where it peaks above 1), as etts' ``SummaryManager.add_audio``
        logs it. A waveform that is not finite raises, rather than being
        written as 16-bit noise."""
        from ..data.audio_io import save_wav
        wav = np.asarray(wav, np.float32).reshape(-1)
        if not np.isfinite(wav).all():
            raise ValueError(f"{tag} at step {step}: the waveform is not "
                             "finite")
        path = self.log_dir / f"{tag.replace('/', '_')}_{step}.wav"
        save_wav(wav, path, int(sample_rate))
        return path

    def add_histogram(self, tag: str, values, step: int) -> Path:
        """The values whose histogram etts' ``SummaryManager`` writes
        (`etts/utils/logging.py:111-115`), kept whole as
        ``{tag with / as _}_{step}.npy``: any histogram can be drawn from
        them."""
        return self._save(values, tag, step)


class StepTrace:
    """A ``torch.profiler`` trace (CPU, and CUDA on the card) of training
    steps ``first`` to ``last``, written as the Chrome trace
    ``trace_steps_{first}-{last}.json`` into ``directory``; each step's
    update is the span ``step {n}`` (``span``). The driver calls
    ``span(step)`` around each step and ``end_step(step)`` after it, and
    ``close()`` when the run ends; a run that ends before ``last`` writes
    the steps it ran."""

    def __init__(self, directory, first: int, last: int, device):
        self.dir = Path(directory)
        self.first, self.last = first, last
        self.cuda = torch.device(device).type == "cuda"
        self.prof, self.step = None, None
        self.path = None

    def span(self, step: int):
        if step == self.first and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        if self.prof is None:
            return contextlib.nullcontext()
        self.step = step
        return torch.profiler.record_function(f"step {step}")

    def end_step(self, step: int):
        if step == self.last:
            self.close()

    def close(self):
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"trace_steps_{self.first}-{self.step}.json"
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        print(f"wrote the profiler trace of steps {self.first}-{self.step} "
              f"to {self.path}")


def read_scalars(log_dir) -> dict:
    """{tag: {step: value}} of ``log_dir``'s scalars, later lines winning."""
    out = {}
    with open(Path(log_dir) / "scalars.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out
