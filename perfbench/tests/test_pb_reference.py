"""The plain references against the port on the CPU at tiny sizes: a
whole run of each cell, its check reading near zero; the references'
parameter names and shapes are the port's; the Philox uniforms are
Philox4x32-10's."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import run
import tiny
from pb import params, spec
from pb.drivers.base import alphabet, merged
from pb.reference.philox import philox4x32, philox_uniforms

BENCH = spec.load_benchmark(spec.HERE.parent)
CELLS = {"ar_bulk_b64": (tiny.bulk_traffic, tiny.ar_config),
         "ar_stream_c2": (tiny.stream_traffic, tiny.ar_config),
         "fwd_train_b16": (tiny.train_traffic, tiny.fwd_config)}


def tiny_run(name, seed=2 ** 31 + 77, prepare=None, trace=0):
    torch.set_num_threads(2)
    traffic, config = (f() for f in CELLS[name])
    return run.run_cell(BENCH, spec.cell(BENCH, name), seed, 0.01, trace,
                        "cpu", time.perf_counter(), prepare=prepare,
                        traffic=traffic, config=config)


@pytest.mark.parametrize("name", list(CELLS))
def test_a_tiny_run_is_correct(name):
    out = tiny_run(name)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "compared"


def test_a_traced_run_reads_its_layers():
    out = tiny_run("ar_bulk_b64", trace=1)
    assert out["correct"]
    assert "vocode_s_per_batch.bulk" in out["metrics"]
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert "audio_s_per_s" not in out["metrics"]


@pytest.mark.parametrize("which", ["ar", "voc", "fwd"])
def test_parameter_names_and_shapes_are_the_port_s(which):
    from etts_torch.convert import export_flat
    from etts_torch.text import default_tokenizer
    from etts_torch.utils.config import build_forward, build_tts, build_vocoder
    a = alphabet()
    if which == "fwd":
        c = merged(tiny.fwd_config(), "forward")
        s = params.forward_spec(c, a)
        m = build_forward(c, default_tokenizer(False).vocab_size)
    else:
        c = merged(tiny.ar_config(), "autoregressive" if which == "ar"
                   else "wavernn")
        s = params.ar_spec(c, a) if which == "ar" else params.wavernn_spec(c)
        m = (build_tts(c, default_tokenizer(True).vocab_size)
             if which == "ar" else build_vocoder(c))
    port = {k: v.shape for k, v in export_flat(m).items()}
    ours = {k: shape for k, (shape, _) in s.entries.items()}
    assert ours == port


def test_philox_known_answer():
    # Salmon et al.'s known-answer vector: counter and key all zero
    z = np.zeros(1, np.uint64)
    words = philox4x32(z, z, z, z, 0, 0)
    assert [int(w[0]) for w in words] == [0x6627E8D5, 0xE169C58D,
                                          0xBC57AC4C, 0x9B00DBD8]


def test_philox_uniforms_are_clipped_and_indexed_by_step_and_row():
    u = philox_uniforms(2 ** 40 + 3, range(4), range(3), 11)
    assert u.shape == (4, 3, 11) and u.min() >= 1e-5 and u.max() <= 1 - 1e-5
    again = philox_uniforms(2 ** 40 + 3, [2], [1], 11)
    assert np.array_equal(u[2, 1], again[0, 0])
