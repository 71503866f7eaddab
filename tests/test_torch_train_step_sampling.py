"""Scheduled sampling at rate 1 against etts (the Bernoulli certain on both
sides, so the decoder reads the first pass's predictions everywhere), held
as test_torch_train_step.py holds a step; and Adam over three updates on a
schedule that changes the learning rate between them: parameters and both
moments against optax's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etts.models import layers as jl
from etts.train import make_optimizer
from etts_torch.convert import _to_torch_layout, _torch_name, load_into
from etts_torch.models import layers as tl
from etts_torch.train.state import TrainState
from etts_torch.train.steps import make_autoregressive_train_step
from torch_parity import (ar_train_batch, assert_step_close, capture_state,
                          flatten, step_pair, to_torch, train_pair)


def test_scheduled_sampling_at_rate_one():
    pair = train_pair(dropout_rate=0.0)
    batch = ar_train_batch(0)
    j, p = step_pair(pair, batch, r=3, ss_rate=1.0, scheduled_sampling=True)
    _, v, tm = pair
    load_into(tm, flatten(v))
    plain, _ = make_autoregressive_train_step(tm, stop_scaling=8.0)(
        capture_state(tm), to_torch(batch), 0.0, 0, r=3, prenet_dropout=0.0)
    assert float(p[1]["loss"]) != float(plain["loss"])
    assert_step_close(j, p)


def test_adam_three_updates_match_optax():
    """The learning rate 1e-3, 2e-3, 3e-3 at updates 0, 1, 2 (optax's
    count); gradients of mixed scale fed to both. Parameters within 1e-6
    absolute, ``exp_avg`` / ``exp_avg_sq`` against ``mu`` / ``nu`` within
    1e-6 of each tensor's largest value (torch's ``lerp`` and optax's
    weighted sum round a cancelling sum differently), after each update."""
    schedule = [[0, 1e-3], [2, 3e-3]]
    jm = jl.MineNetFirstOrder((16, 8))
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((2, 20)))["params"]
    net = load_into(tl.MineNetFirstOrder(20, (16, 8)),
                    flatten({"params": params}))
    state = TrainState(net, schedule)
    tx = make_optimizer(schedule)
    opt = tx.init(params)
    rng = np.random.default_rng(0)
    for k in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(
            size=p.shape).astype(np.float32) * 10.0 ** rng.integers(-4, 2)),
            params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        flat_g = {_torch_name(key): torch.from_numpy(np.array(
            _to_torch_layout(key, g))) for key, g in flatten(
            {"params": grads}).items()}
        state.apply_gradients([flat_g[n] for n in state.names])
        adam = [s for s in jax.tree_util.tree_leaves(
            opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        assert int(adam.count) == k + 1 == state.step
        named = dict(net.named_parameters())
        for tree, get in ((params, lambda n: named[n].detach()),
                          (adam.mu, lambda n: state.optimizer.state[
                              named[n]]["exp_avg"]),
                          (adam.nu, lambda n: state.optimizer.state[
                              named[n]]["exp_avg_sq"])):
            for key, want in flatten({"params": tree}).items():
                got = get(_torch_name(key)).numpy()
                want = _to_torch_layout(key, want)
                if tree is params:
                    np.testing.assert_allclose(got, want, atol=1e-6)
                else:
                    np.testing.assert_allclose(
                        got, want, rtol=0, atol=1e-6 * np.abs(want).max())
