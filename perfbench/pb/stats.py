"""The window's arithmetic: rates over the whole window, percentiles over
every sample."""
from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """Work completed in the window over the window's length."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return work / seconds


def percentile(values, q: int) -> float:
    """The q-th percentile (1..99) of all the values, by
    ``statistics.quantiles(..., n=100, method="inclusive")``."""
    values = list(values)
    if len(values) < 2:
        raise ValueError(f"a percentile needs two samples, got {len(values)}")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def beyond(values, q: int) -> int:
    """How many samples lie above the q-th percentile."""
    cut = percentile(values, q)
    return sum(v > cut for v in values)
