"""The train step's loss options against etts' on the same weights and
batch (dropout 0, no head drop): the style-consistency loss and GTA decoder
inputs. Each holds every gradient, the BatchNorm statistics and the metrics
as test_torch_train_step.py does."""
import numpy as np
import pytest

from etts_torch.convert import load_into
from etts_torch.train.steps import make_autoregressive_train_step
from torch_parity import (ar_train_batch, assert_step_close, capture_state,
                          flatten, step_pair, to_torch, train_pair)


@pytest.fixture(scope="module")
def pair():
    return train_pair(dropout_rate=0.0)


def plain_loss(pair, batch, r):
    """The port's plain step's loss on these weights."""
    _, v, tm = pair
    load_into(tm, flatten(v))
    met, _ = make_autoregressive_train_step(tm, stop_scaling=8.0)(
        capture_state(tm), to_torch(batch), 0.0, 0, r=r, prenet_dropout=0.0)
    return float(met["loss"])


def test_style_loss(pair):
    """The predicted mel re-encoded through the style encoder in train
    mode, whose BatchNorm statistics are thrown away on both sides."""
    j, p = step_pair(pair, ar_train_batch(0), r=3, use_style_loss=True)
    assert float(p[1]["style_loss"]) > 0
    assert_step_close(j, p)


def test_gta_inputs(pair):
    """A fifth tensor, a GTA mel: the decoder reads it (its GO frame the
    true start), the targets and the style reference stay the batch's."""
    batch = ar_train_batch(0)
    gta = batch[0] + np.random.default_rng(9).normal(
        0, 0.3, batch[0].shape).astype(np.float32) * (batch[0] != 0)
    j, p = step_pair(pair, batch + (gta,), r=3, gta_inputs=True)
    assert float(p[1]["loss"]) != plain_loss(pair, batch, 3)
    assert_step_close(j, p)
