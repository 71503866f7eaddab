"""The port's losses, schedules and initialisers against etts: the loss
golden values of the reference suite, each loss on padded random batches,
the schedules step by step, and each initialiser's statistics."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models import layers as jl
from etts.train.state import interp_schedule as j_interp
from etts.utils import losses as jloss
from etts.utils.scheduling import piecewise_linear_schedule as j_pw
from etts.utils.scheduling import reduction_schedule as j_step
from etts_torch.models import layers as tl
from etts_torch.models.init import init_flax
from etts_torch.train.state import interp_schedule
from etts_torch.utils import losses as tloss
from etts_torch.utils.config import piecewise_linear_schedule, step_schedule
from torch_parity import flatten

TARGETS = [[0, 1, 2]]
LOGITS = [[[.3, .2, .1], [.3, .2, .1], [.3, .2, .1]]]


# (loss, targets, predictions, the reference suite's value); tolerance 1e-5
GOLDEN = [
    (tloss.new_scaled_crossentropy(index=2, scaling=5), TARGETS, LOGITS,
     2.3705523014068604),
    (tloss.new_scaled_crossentropy(index=2, scaling=1), TARGETS, LOGITS,
     0.7679619193077087),
    (tloss.masked_crossentropy, TARGETS, LOGITS, 0.7679619193077087),
    # the second frame is padding; Keras divides by both frames
    (tloss.masked_mean_absolute_error, [[[1., 1.], [0., 0.]]],
     [[[2., 2.], [9., 9.]]], 0.5),
    (tloss.masked_mean_squared_error, [[[1., 1.], [0., 0.]]],
     [[[3., 3.], [9., 9.]]], 2.0),
]


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_golden_values(case):
    fn, targets, logits, want = GOLDEN[case]
    assert abs(float(fn(torch.tensor(targets), torch.tensor(logits)))
               - want) < 1e-5


def test_weighted_sum():
    total, vals = tloss.weighted_sum_losses(
        (torch.ones(3), torch.ones(3)), (torch.zeros(3), torch.ones(3)),
        (tloss.l2_loss, tloss.l2_loss), (2.0, 1.0))
    assert float(total) == 2.0 and float(vals[0]) == 1.0


@pytest.mark.parametrize("name", ["masked_mean_absolute_error",
                                  "masked_mean_squared_error", "l1_loss",
                                  "l2_loss", "masked_crossentropy",
                                  "stop_ce"])
def test_losses_match_etts_on_padded_batches(name):
    """Random (b, t, c) batches whose rows end in zero padding; relative
    tolerance 1e-6 (float32 sums in another order)."""
    rng = np.random.default_rng(3)
    t_ = rng.normal(size=(3, 11, 5)).astype(np.float32)
    t_[1, 7:] = 0.0
    t_[2, 4:] = 0.0
    p = rng.normal(size=(3, 11, 5)).astype(np.float32)
    if name in ("masked_crossentropy", "stop_ce"):
        t_ = rng.integers(0, 3, (3, 11)).astype(np.int32)
        p = rng.normal(size=(3, 11, 3)).astype(np.float32)
        mk = lambda m: m.new_scaled_crossentropy(index=2, scaling=8.0)
        jf = mk(jloss) if name == "stop_ce" else jloss.masked_crossentropy
        tf = mk(tloss) if name == "stop_ce" else tloss.masked_crossentropy
        tt = torch.from_numpy(t_).long()
    else:
        jf, tf = getattr(jloss, name), getattr(tloss, name)
        tt = torch.from_numpy(t_)
    want = float(jf(jnp.asarray(t_), jnp.asarray(p)))
    got = float(tf(tt, torch.from_numpy(p)))
    assert got == pytest.approx(want, rel=1e-6)


SCHEDULES = ([[0, 0.0], [10, 1.0], [20, 1.0]], [[0, 1e-4], [50, 3e-4]],
             [[0, 10], [80000, 1]], [[0, 0], [15000, 1]])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_etts(schedule):
    """Exact, at each breakpoint, between them and past the last."""
    end = int(schedule[-1][0])
    for step in sorted({0, 1, 5, 9, 10, 15, 19, 20, 49, 50, 51, end - 1,
                        end, end + 7}):
        assert piecewise_linear_schedule(step, schedule) == j_pw(step,
                                                                 schedule)
        assert step_schedule(step, schedule) == j_step(step, schedule)
        # the optimizer's schedule is float32 (etts: jnp.interp)
        assert interp_schedule(schedule)(step) == float(
            j_interp(schedule)(step))


def _stats_close(name, a, b):
    """std within 10 %; means within a tenth of the std; zeros and
    constants (norm scales) equal. A tensor of a few draws is held only to
    be non-zero where flax's is."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, name
    if not b.any() or (b.std() == 0 and b.size > 1):
        assert np.array_equal(a, b), name
        return
    if b.size < 1000:
        assert a.all(), name
        return
    assert abs(a.std() / b.std() - 1) < 0.1, (name, a.std(), b.std())
    assert abs(a.mean() - b.mean()) < 0.1 * b.std(), (name, a.mean(),
                                                      b.mean())


# (flax module, its input, the port module): each large enough that the
# statistics of one draw settle
INIT_CASES = {
    "dense": (lambda: fnn.Dense(384), (1, 512), lambda: torch.nn.Linear(
        512, 384)),
    "conv1d": (lambda: fnn.Conv(96, (5,)), (1, 9, 80),
               lambda: torch.nn.Conv1d(80, 96, 5)),
    "embed": (lambda: fnn.Embed(400, 256), None,
              lambda: torch.nn.Embedding(400, 256)),
    "gst": (lambda: jl.ReferenceEncoderGST(
        kernel_size=3, strides=2, conv_filters=(8, 64),
        gru_cell_units=64, gst_style_embed_dim=256, multi_num_heads=4,
        gst_heads=300), (1, 12, 16),
        lambda: tl.ReferenceEncoderGST(16, 3, 2, (8, 64), 64, 256, 4, 300)),
    "linear_critic": (lambda: jl.MineNetLinear((256,)), (2, 1, 512),
                      lambda: tl.MineNetLinear(512, (256,))),
    "linear_q_critic": (lambda: jl.MineNetLinearQ((128,)), (2, 1, 256),
                        lambda: tl.MineNetLinearQ(256, (128,))),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_statistics_match_flax(case):
    """Every tensor of the port's init against flax's init of the same
    module (seeded, large draws): std within 10 %, mean within 0.1 std."""
    from etts_torch.convert import export_flat
    make_j, shape, make_t = INIT_CASES[case]
    jm = make_j()
    x = (jnp.zeros((1, 3), jnp.int32) if shape is None
         else jnp.ones(shape))
    want = flatten(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), x)))
    got = export_flat(init_flax(make_t(), torch.Generator().manual_seed(0)))
    got = {k: v for k, v in got.items() if k in want}
    assert set(got) == set(want)
    for k in want:
        _stats_close(k, got[k], want[k])
