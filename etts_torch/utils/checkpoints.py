"""Checkpoints in the session layout of ``etts/utils/checkpoints.py``: one
file a step in a directory, ``ckpt-{step}.pt``, written by ``torch.save``
(the port reads no orbax). A train state saves its model's ``state_dict``
(parameters and BatchNorm statistics), its optimizer's and its step
(``TrainState.state_dict``); the driver adds what else it carries.
``max_to_keep`` keeps the newest files. Under a process group rank 0
writes and every rank waits for the file (a barrier), so that each can
restore it.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from ..parallel.mesh import barrier, is_primary

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"ckpt-(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory, max_to_keep: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        return sorted(int(m[1]) for p in self.directory.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}.pt"

    def save(self, step: int, tree: dict):
        """Write ``tree`` (tensors, numbers, dicts and lists of them) as
        step ``step``: to a temporary file, then renamed, so that a run cut
        while saving leaves the last checkpoint whole; then drop the oldest
        beyond ``max_to_keep``. Under a process group rank 0 writes, and
        every rank returns once the file is whole."""
        if is_primary():
            tmp = self.directory / f".ckpt-{step}.pt.tmp"
            torch.save(tree, tmp)
            os.replace(tmp, self.path(step))
            if self.max_to_keep:
                for old in self.steps()[:-self.max_to_keep]:
                    self.path(old).unlink()
        barrier()

    def restore(self, step: Optional[int] = None, map_location=None):
        """(tree, step) of ``step`` or of the latest, or (None, None) where
        there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True), step
