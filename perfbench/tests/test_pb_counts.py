"""Operations and bytes counted from shapes, against the bounds that
PERF.md §6 gives for kernel B1."""
from __future__ import annotations

import json

import pytest

from pb import counts, spec
from pb.drivers.base import merged

CFG = merged(json.loads((spec.HERE / "configs" / "ar_gst_wavernn.json")
                        .read_text()), "wavernn")


@pytest.mark.parametrize("rows,ms", [(144, 13.4763), (18, 1.6845)])
def test_b1_bound_matches_the_kernel_table(rows, ms):
    loop = counts.sample_loop(CFG, 12100, rows)
    assert loop["bound_s"] * 1e3 == pytest.approx(ms, abs=5e-5)
    # the operations bound it, not the bytes
    assert loop["ops"] / counts.PEAKS["bf16_ops_per_s"] == loop["bound_s"]


def test_sample_loop_weights_are_the_kernel_s():
    assert counts.sample_loop_matrices(CFG) == 3_824_640


def test_forward_train_counts_real_frames_only():
    fwd = merged(json.loads((spec.HERE / "configs" / "forward_tts.json")
                            .read_text()), "forward")
    a = counts.forward_train_ops(fwd, 100, 700)
    b = counts.forward_train_ops(fwd, 100, 1400)
    assert 1.9 < b / a < 2.6        # attention grows with the square
    assert a == 3 * counts.forward_model_ops(fwd, 100, 700)
