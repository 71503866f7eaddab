"""One train step of the port against etts' on the same weights and batch
(speaker_style_text, padded rows, dropout 0, no head drop: the randomness
of the two frameworks cannot match): every gradient, read exactly on both
sides (etts' through ``capture_tx``), the BatchNorm statistics after the
step and the metrics; at r = 1 and 3, with the MI hinge, and scheduled
sampling at rate 0 against the plain step, bit for bit."""
import numpy as np
import pytest
import torch

from etts_torch.convert import export_flat, load_into
from etts_torch.train.steps import make_autoregressive_train_step
from torch_parity import (ar_train_batch, assert_step_close, capture_state,
                          flatten, step_pair, to_torch, train_pair)


@pytest.fixture(scope="module")
def pair():
    return train_pair(dropout_rate=0.0)


@pytest.mark.parametrize("r", [1, 3])
def test_plain_step_matches_etts(pair, r):
    """Gradients within 1e-4 relative L2 each (1e-7 absolute for the ones
    zero in exact arithmetic), BatchNorm statistics within 1e-6, metrics
    within 1e-5 relative."""
    assert_step_close(*step_pair(pair, ar_train_batch(0), r=r))


def test_mi_hinge_moves_the_loss_not_the_gradients(pair):
    """The previous step's MI is a constant under the tape: the total moves
    by weight * max(0, mi) on both sides, the gradients stay the plain
    step's, bit for bit in the port."""
    batch = ar_train_batch(0)
    j, p = step_pair(pair, batch, r=1, mi=0.7)
    assert_step_close(j, p)
    _, plain = step_pair(pair, batch, r=1)
    assert float(p[1]["loss"] - plain[1]["loss"]) == pytest.approx(
        0.07, rel=1e-5)
    assert all(torch.equal(p[0].grads[k], plain[0].grads[k])
               for k in plain[0].grads)
    _, neg = step_pair(pair, batch, r=1, mi=-3.0)    # the hinge at 0
    assert float(neg[1]["loss"]) == float(plain[1]["loss"])


def test_scheduled_sampling_at_rate_zero_is_the_plain_step(pair):
    """ss_rate 0: the mix never picks a prediction, and the no-grad first
    pass (train flags off) moves no BatchNorm statistic: gradients,
    statistics and metrics equal the plain step's bit for bit."""
    jm, v, tm = pair
    batch = to_torch(ar_train_batch(0))
    out = []
    for ss in (False, True):
        load_into(tm, flatten(v))
        cs = capture_state(tm)
        met, _ = make_autoregressive_train_step(
            tm, stop_scaling=8.0, scheduled_sampling=ss)(
            cs, batch, 0.0, 0, r=3, prenet_dropout=0.0, ss_rate=0.0)
        out.append((cs.grads, met, export_flat(tm)))
    (g0, m0, s0), (g1, m1, s1) = out
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(np.array_equal(s0[k], s1[k]) for k in s0)
    assert float(m0["loss"]) == float(m1["loss"])


def test_freeze_mask_leaves_the_text_encoder(pair):
    """use_pretrained: the port leaves TextEncoder and TextEmbedding out of
    the optimizer, where etts' driver masks their updates to zero
    (``optax.masked(set_to_zero)``): the port's trainable gradients are
    exactly etts' unmasked ones (held as the plain step's), etts' masked
    ones are zero, and a real update moves every parameter but those."""
    import jax
    import optax
    from etts_torch.train.state import FROZEN_PRETRAINED, TrainState
    from torch_parity import assert_grads_close, torch_grads
    jm, v, tm = pair
    batch = ar_train_batch(0)
    (jst, _), _ = step_pair(pair, batch, r=1)
    mask = {k: jax.tree.map(lambda _: k in FROZEN_PRETRAINED, sub)
            for k, sub in jst.opt_state.items()}
    masked, _ = optax.masked(optax.set_to_zero(), mask).update(
        jst.opt_state, optax.masked(optax.set_to_zero(), mask).init(
            jst.opt_state))
    want = torch_grads(masked)
    load_into(tm, flatten(v))
    cs = capture_state(tm, frozen=FROZEN_PRETRAINED)
    make_autoregressive_train_step(tm, stop_scaling=8.0)(
        cs, to_torch(batch), 0.0, 0, r=1, prenet_dropout=0.0)
    frozen = {k for k in want if k.split(".")[0] in FROZEN_PRETRAINED}
    assert frozen and all(not want[k].any() for k in frozen)
    assert_grads_close({k: w for k, w in want.items() if k not in frozen},
                       cs.grads, 1e-4, 1e-7)
    load_into(tm, flatten(v))
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state = TrainState(tm, [[0, 1e-3]], frozen=FROZEN_PRETRAINED)
    make_autoregressive_train_step(tm, stop_scaling=8.0)(
        state, to_torch(batch), 0.0, 0, r=1, prenet_dropout=0.0)
    for k, p in tm.named_parameters():
        assert torch.equal(p, before[k]) == (k in frozen), k
