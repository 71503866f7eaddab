"""On the card: the control of each cell, at the cell's own size, has to
come out as not correct: the int8 sample loop and the TF32 reference for
the synthesis cells, the train step in TF32. Run on the card with
``python -m pytest perfbench/tests -m card``."""
from __future__ import annotations

import time

import pytest

import run
from pb import spec

BENCH = spec.load_benchmark(spec.HERE.parent)


def _control(driver):
    driver.control = True


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(name, card):
    out = run.run_cell(BENCH, spec.cell(BENCH, name), 2 ** 31 + 5, 0.0, 0,
                       card, time.perf_counter(), prepare=_control)
    assert not out["correct"], out["compared"]
