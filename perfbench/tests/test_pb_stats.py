"""The window's arithmetic."""
from __future__ import annotations

import pytest

from pb import stats


def test_rate_is_over_the_whole_window():
    assert stats.rate(300.0, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_tail_is_over_every_gap():
    gaps = [0.3] * 100 + [1.0] * 20
    p90 = stats.percentile(gaps, 90)
    assert p90 == pytest.approx(1.0)
    assert stats.beyond(list(range(1, 101)), 90) == 10

