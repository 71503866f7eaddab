"""The WaveRNN vocoder's training of the port against etts' on the CPU,
at VOC_TINY's widths: the discretized mixture-of-logistics loss and its
gradient through every branch, the RAW cross-entropy, the train-mode
forward and the BatchNorm statistics it moves (flax's momentum 0.9), one
``make_wavernn_train_step`` step's gradients (read exactly on etts' side
through ``torch_parity.capture_tx``), and WaveRNN's initialisers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.wavernn import discretized_mix_logistic_loss as j_mol
from etts.train import TrainState as JState
from etts.train import make_wavernn_train_step as j_step
from etts_torch.convert import export_flat
from etts_torch.models.init import init_flax
from etts_torch.models.wavernn import WaveRNN as TW
from etts_torch.models.wavernn import discretized_mix_logistic_loss, raw_loss
from etts_torch.train.steps import make_wavernn_train_step
from torch_parity import (VOC_TINY, assert_grads_close, capture_state,
                          capture_tx, flatten, t, torch_grads,
                          voc_train_pair)

TOL = 1e-6


def _mol_inputs(seed=0, b=2, n=64, nr_mix=10):
    """Logits, means and log scales from tiny (down to e^-20: cdf_delta 0
    away from the mean, where log(cdf_delta) is -inf unclamped) to wide
    (cdf_delta <= 1e-5 at the mean: the density branch); targets in [-1,
    1] with exact -1 and 1 (the tail branches) and values at the means."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (b, n, nr_mix))
    means = rng.uniform(-1, 1, (b, n, nr_mix))
    log_scales = rng.uniform(-20, 2, (b, n, nr_mix))
    y = rng.uniform(-1, 1, (b, n, 1))
    y[:, :8, 0] = -1.0
    y[:, 8:16, 0] = 1.0
    y[:, 16:24, 0] = means[:, 16:24, 0]
    y_hat = np.concatenate([logits, means, log_scales], -1)
    return y_hat.astype(np.float32), y.astype(np.float32)


def test_mol_loss_and_gradient_match_etts():
    """In float64 (both sides), the loss, each row's and the gradient
    within TOL; in
    float32 the loss within TOL and a finite gradient. The float32
    gradient is not compared: where cdf_delta is near its 1e-5 switch,
    sigmoid(a) - sigmoid(b) keeps 2 or 3 digits in float32, and 1 /
    cdf_delta carries the two frameworks' last-bit sigmoids to 5e-5."""
    y_hat, y = _mol_inputs()
    with jax.enable_x64(True):
        a, b = jnp.asarray(y_hat, jnp.float64), jnp.asarray(y, jnp.float64)
        jl, jg = jax.jit(jax.value_and_grad(j_mol))(a, b)
        jl, jg = float(jl), np.asarray(jg)
        j_rows = np.asarray(jax.jit(lambda a, b: j_mol(a, b, reduce=False))(
            a, b))
    x = t(y_hat, np.float64).requires_grad_(True)
    loss = discretized_mix_logistic_loss(x, t(y, np.float64))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=TOL)
    np.testing.assert_allclose(g.numpy(), jg, atol=TOL)
    x = t(y_hat).requires_grad_(True)
    loss = discretized_mix_logistic_loss(x, t(y))
    (g,) = torch.autograd.grad(loss, x)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax.jit(j_mol)(jnp.asarray(y_hat),
                                                    jnp.asarray(y))),
                               rtol=TOL)
    # every branch taken: the tails, log(cdf_delta), the density, and
    # cdf_delta 0 (log(0) in the branch not taken)
    delta = _cdf_delta(y_hat.astype(np.float64), y.astype(np.float64))
    assert (delta > 1e-5).any() and (delta <= 1e-5).any()
    assert (delta == 0).any()
    rows = discretized_mix_logistic_loss(t(y_hat, np.float64),
                                         t(y, np.float64), reduce=False)
    assert rows.shape == y.shape
    np.testing.assert_allclose(rows.numpy(), j_rows, rtol=TOL, atol=TOL)


def _cdf_delta(y_hat, y, num_classes=65536):
    m = y_hat[..., 10:20]
    inv = np.exp(-np.maximum(y_hat[..., 20:], np.log(1e-14)))
    sig = lambda v: 0.5 * (1 + np.tanh(0.5 * v))
    c = y - m
    return (sig(inv * (c + 1 / (num_classes - 1)))
            - sig(inv * (c - 1 / (num_classes - 1))))


def test_raw_loss_matches_etts():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 30, 16)).astype(np.float32)
    y = rng.integers(0, 16, (2, 30))

    def j_raw(a):
        logp = jax.nn.log_softmax(a, axis=-1)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(y, 16) * logp, axis=-1))
    jl, jg = jax.jit(jax.value_and_grad(j_raw))(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    loss = raw_loss(x, torch.from_numpy(y))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=TOL)


def _batch(mode, seed=2, b=3, n=50):
    """x (b, n) in [-1, 1], y (floats for MOL, 4-bit labels for RAW),
    mels (b, n // hop + 2 * pad, 8) in [0, 1], as collate_vocoder makes
    them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    y = (rng.uniform(-1, 1, (b, n)).astype(np.float32) if mode == "MOL"
         else rng.integers(0, 16, (b, n)))
    mels = rng.uniform(0, 1, (b, n // 10 + 4, 8)).astype(np.float32)
    return x, y, mels


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_train_forward_and_batch_stats_match_etts(mode):
    jm, v, tm = voc_train_pair(mode)
    x, _, mels = _batch(mode)
    want, mut = jax.jit(lambda v, x, m: jm.apply(
        v, x, m, True, mutable=["batch_stats"]))(v, jnp.asarray(x),
                                                 jnp.asarray(mels))
    got = tm(t(x), t(mels), train=True)
    assert got.requires_grad
    # the logits within TOL of their largest |value| (float32 sums of the
    # GRUs and batch statistics in another order: 2.4e-6 of 5.1), the
    # statistics within TOL
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=TOL * np.abs(want).max())
    want_stats = flatten({"params": {}, "batch_stats": mut["batch_stats"]})
    got_flat = export_flat(tm)
    before = flatten(v)
    for k, w in want_stats.items():
        assert not np.allclose(w, before[k]), k
        np.testing.assert_allclose(got_flat[k], w, atol=TOL, err_msg=k)
    # inference keeps the running statistics and runs no autograd
    with torch.no_grad():
        stats = {k: b.clone() for k, b in tm.named_buffers()}
    out = tm(t(x), t(mels))
    assert not out.requires_grad
    assert all(torch.equal(b, stats[k]) for k, b in tm.named_buffers())


@pytest.mark.parametrize("mode, dtype", [("MOL", np.float64),
                                         ("RAW", np.float32)])
def test_train_step_gradients_match_etts(mode, dtype):
    """One step from the same weights: every gradient (rtol 1e-4, atol
    1e-6), the loss and the BatchNorm statistics after it (1e-6). MOL
    runs in float64 on both sides (etts' flax model at dtype float64, its
    GRU products kept in float32 as etts writes them): the float32 MoL
    gradient is 1.4e-3 (relative) from the float64 one on both sides
    (test_mol_loss_and_gradient_match_etts), so no float32 pair can meet
    1e-4; in float64 the worst gradient reads 2e-7."""
    jm, v, tm = voc_train_pair(mode, seed=3)
    batch = tuple(a if a.dtype == np.int64 else a.astype(dtype)
                  for a in _batch(mode, seed=4))
    with jax.enable_x64(dtype == np.float64):
        if dtype == np.float64:
            jm = jm.clone(dtype=jnp.float64)
            v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        jst, jmet = j_step(jm, capture_tx())(
            JState.create(v, capture_tx()),
            tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))
        want_grads = torch_grads(jst.opt_state)
        want = flatten({"params": {}, "batch_stats": jst.batch_stats})
        j_loss = float(jmet["loss"])
    tm = tm.to(torch.float64 if dtype == np.float64 else torch.float32)
    cs = capture_state(tm)
    met = make_wavernn_train_step(tm)(cs, tuple(torch.from_numpy(a)
                                                for a in batch))
    assert cs.step == 1 and set(met) == {"loss"}
    assert_grads_close(want_grads, cs.grads, 1e-4, 1e-6)
    np.testing.assert_allclose(float(met["loss"]), j_loss, rtol=TOL)
    got = export_flat(tm)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=TOL, err_msg=k)


def test_wavernn_init():
    """init_flax on a WaveRNN: the smoothing kernels the constant 1 / k,
    no bias made for the bias-free convs, lecun-normal GRU input kernels,
    orthogonal recurrent kernels (orthonormal rows), zero GRU and dense
    biases, BatchNorm at scale 1, mean 0, variance 1; the same seed draws
    the same weights."""
    a, b = (init_flax(TW(mode="MOL", **VOC_TINY),
                      torch.Generator().manual_seed(5)) for _ in range(2))
    for k, x in a.state_dict().items():
        assert torch.equal(x, b.state_dict()[k]), k
    for i, s in enumerate(VOC_TINY["upsample_factors"]):
        w = getattr(a.upsample, f"smooth_{i}").weight
        assert torch.equal(w, torch.full_like(w, 1.0 / (2 * s + 1)))
        assert getattr(a.upsample, f"smooth_{i}").bias is None
    for conv in (a.upsample.resnet.Conv_0, a.upsample.resnet.res_0.Conv_1):
        assert conv.bias is None
    assert not a.upsample.resnet.Conv_1.bias.any()
    d = VOC_TINY["rnn_dims"]
    for name in ("rnn1", "rnn2"):
        wh = getattr(a, f"{name}_wh").detach()
        torch.testing.assert_close(wh @ wh.T, torch.eye(d), atol=1e-5,
                                   rtol=0)
        wi = getattr(a, f"{name}_wi").detach()
        assert abs(float(wi.std()) * wi.shape[0] ** 0.5 - 1.0) < 0.15
        assert not getattr(a, f"{name}_bi").any()
        assert not getattr(a, f"{name}_bh").any()
    assert not a.I.bias.any() and not a.fc3.bias.any()
    bn = a.upsample.resnet.BatchNorm_0
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all()
                and (bn.running_mean == 0).all())
