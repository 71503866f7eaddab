"""A run drives the program with its timed path broken underneath, and
sees ``correct`` come out false: for each fault a cell can have."""
from __future__ import annotations

import pytest
import torch

import tiny
from test_pb_reference import tiny_run


def _alter_samples(monkeypatch):
    """Every 50th step of the sample loop's output moved by 0.5."""
    import etts_torch.models.wavernn as wr
    import etts_torch.streaming as st
    real = wr.wavernn_sample_loop

    def broken(cond, *a, **kw):
        samples, state = real(cond, *a, **kw)
        samples = samples.clone()
        samples[::50] = torch.where(samples[::50] > 0, samples[::50] - 0.5,
                                    samples[::50] + 0.5)
        return samples, state
    monkeypatch.setattr(wr, "wavernn_sample_loop", broken)
    monkeypatch.setattr(st, "wavernn_sample_loop", broken)


def _alter_stream_frame(monkeypatch):
    """One mel frame of the streamed decode's first chunk moved by 4."""
    import etts_torch.streaming as st
    real = st._mel_chunks

    def broken(*a, **kw):
        for i, mel in enumerate(real(*a, **kw)):
            if i == 0:
                mel = mel.clone()
                mel[5] += 4.0
            yield mel
    monkeypatch.setattr(st, "_mel_chunks", broken)


def _alter_one_frame(monkeypatch):
    import etts_torch.api as api
    real = api.autoregressive_predict

    def broken(*a, **kw):
        out = real(*a, **kw)
        out["mel"] = out["mel"].clone()
        out["mel"][:, 12] += 0.5
        return out
    monkeypatch.setattr(api, "autoregressive_predict", broken)


@pytest.mark.parametrize("name", ["ar_bulk_b64", "ar_stream_c2"])
def test_samples_altered_where_they_are_made(name, monkeypatch):
    _alter_samples(monkeypatch)
    out = tiny_run(name)
    assert not out["correct"]


def test_a_streamed_mel_frame_altered_where_it_is_made(monkeypatch):
    _alter_stream_frame(monkeypatch)
    out = tiny_run("ar_stream_c2")
    assert not out["correct"]


def test_a_mel_frame_altered_where_it_is_made(monkeypatch):
    _alter_one_frame(monkeypatch)
    out = tiny_run("ar_bulk_b64")
    assert not out["correct"]
    assert out["compared"]["mel_gap"][0] > out["compared"]["mel_gap"][1]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from etts_torch.train.state import TrainState
    monkeypatch.setattr(TrainState, "apply_gradients",
                        lambda self, grads: None)
    out = tiny_run("fwd_train_b16")
    assert not out["correct"]
    assert out["compared"]["change_gap"][0] == pytest.approx(1.0)
    assert out["compared"]["window_change_gap"][0] == pytest.approx(1.0)


def test_a_step_that_breaks_only_after_the_set_up(monkeypatch):
    """A step that leaves the state unchanged from the window's first step
    on: the set-up's steps read sound, the window's fail."""
    from etts_torch.train.state import TrainState
    real = TrainState.apply_gradients
    after = tiny.train_traffic()["setup_steps"]

    def broken(self, grads):
        if self.step < after:
            real(self, grads)
    monkeypatch.setattr(TrainState, "apply_gradients", broken)
    out = tiny_run("fwd_train_b16")
    c = out["compared"]
    assert not out["correct"]
    assert all(v <= lim for k, (v, lim) in c.items()
               if not k.startswith("window_")), c
    assert c["window_change_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out():
    def half(driver):
        driver.fault = "half_batch"
    out = tiny_run("fwd_train_b16", prepare=half)
    assert not out["correct"]
