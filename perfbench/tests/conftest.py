"""The benchmark's tests: run from the root of the checkout with
``python -m pytest perfbench/tests``. Tests that need the card carry the
``card`` marker and skip, inside their fixture, where there is none."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH / "tests"))
sys.path.insert(1, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    monkeypatch.chdir(BENCH.parent)
