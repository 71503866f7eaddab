"""Train mode of the port's layers against etts: HeadDrop on injected
scores, dropout's keep share and scale, BatchNorm on batch statistics with
flax's running-statistics update, the teacher-forced model forward (dense
and conv blocks, r = 1 and 3, train flags off and on at dropout 0), and the
validation step."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models import layers as jl
from etts.train import TrainState as JState
from etts.train import make_autoregressive_val_step as j_val_step
from etts_torch.convert import export_flat, load_into
from etts_torch.models import layers as tl
from etts_torch.train.steps import make_autoregressive_val_step
from torch_parity import (ar_train_batch, flatten, t, to_jax, to_torch,
                          train_pair)


@pytest.mark.parametrize("drop_n", [0, 1, 2, 3])
def test_head_drop_matches_etts_on_injected_scores(drop_n):
    """etts' HeadDrop draws its scores from its key; the port takes them
    as an argument: given etts' draw, the two agree exactly."""
    key = jax.random.PRNGKey(drop_n)
    x = jax.random.normal(key, (5, 4, 3, 2))
    want = jl.head_drop(x, drop_n, jax.random.PRNGKey(7))
    scores = jax.random.uniform(jax.random.PRNGKey(7), (5, 4))
    got = tl.head_drop(t(x), drop_n, t(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = (got.abs().sum((2, 3)) > 0).sum(1)
    assert (kept == 4 - drop_n).all()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_share_and_scale(rate):
    """Over 10^6 draws the kept share is 1 - rate within 5 standard errors,
    each kept value scaled by exactly 1 / (1 - rate); off in eval mode."""
    x = torch.ones(1000, 1000)
    y = tl.dropout(x, rate, True, torch.Generator().manual_seed(0))
    kept = y != 0
    se = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * se
    assert torch.equal(y[kept], torch.full_like(y[kept],
                                                np.float32(1 / (1 - rate))))
    assert tl.dropout(x, rate, False) is x


def test_attention_softmax_matches_jax():
    """The attention's softmax, renormalised by its float64 row sums, on
    1280 keys with a masked tail, against ``jax.nn.softmax`` (etts'): the
    weights within 1e-6 relative, each row summing to one within 1e-6;
    the backward against jax's vjp within 1e-5 of the gradient's scale;
    float64 gradcheck."""
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.standard_normal((2, 4, 8, 1280))).astype(np.float32)
    logits[1, ..., 900:] += np.float32(-1e9)
    cot = rng.standard_normal(logits.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.nn.softmax(x, -1), jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    w = tl._RenormSoftmax.apply(x)
    w.backward(t(cot))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-12)
    assert (w.detach().double().sum(-1) - 1).abs().max() <= 1e-6
    g_want = np.asarray(vjp(jnp.asarray(cot))[0])
    assert (np.abs(x.grad.numpy() - g_want).max()
            <= 1e-5 * np.abs(g_want).max())
    x64 = torch.randn(2, 3, 9, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tl._RenormSoftmax.apply, (x64,))


@pytest.mark.parametrize("shape", [(4, 6, 10), (3, 5, 7, 4)])
def test_batch_norm_train_matches_flax(shape):
    """Normalisation by the batch and flax's update of the running
    statistics (momentum 0.99, biased variance), 1e-5; eval mode reads the
    running statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    c = shape[1]
    bn = (torch.nn.BatchNorm1d if len(shape) == 3 else torch.nn.BatchNorm2d)(
        c, eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(1, .2, c).astype(
            np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, .2, c).astype(
            np.float32)))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    xj = jnp.moveaxis(jnp.asarray(x), 1, -1)       # flax: features last
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3)
    v = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                    "bias": jnp.asarray(bn.bias.detach().numpy())},
         "batch_stats": {"mean": jnp.full(c, 0.3), "var": jnp.full(c, 2.0)}}
    want, mut = jbn.apply(v, xj, mutable=["batch_stats"])
    got = tl.batch_norm(bn, torch.from_numpy(x), True)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-5)
    for ours, theirs in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(mut["batch_stats"][theirs]),
                                   rtol=1e-5)
    ev = tl.batch_norm(bn, torch.from_numpy(x), False)
    jev = fnn.BatchNorm(use_running_average=True, momentum=0.99,
                        epsilon=1e-3).apply(
        {"params": v["params"], "batch_stats": mut["batch_stats"]}, xj)
    np.testing.assert_allclose(ev.detach().numpy(),
                               np.moveaxis(np.asarray(jev), -1, 1),
                               atol=1e-5)


OUT_KEYS = ("final_output", "mel_linear", "stop_prob", "decoder_output",
            "gst_output", "text_enc_output")


@pytest.mark.parametrize("blocks, r", [(2, 1), (1, 3)])
def test_teacher_forced_forward_matches_etts(blocks, r):
    """``forward`` with the train flags off and on (dropout 0, so BatchNorm
    on batch statistics is the only train-mode change): every output within
    5e-5, etts' attention keys, and the BatchNorm statistics after the pass
    within 1e-6. blocks 1: one dense and one conv block in each stack."""
    jm, v, tm = train_pair(dropout_rate=0.0, encoder_dense_blocks=blocks,
                          decoder_dense_blocks=blocks,
                          encoder_attention_conv_filters=24,
                          decoder_attention_conv_filters=20)
    mel, phon, stop, spk = ar_train_batch(1)
    tar = mel[:, :-1][:, ::r]
    apply = jax.jit(lambda v, train: jm.apply(
        v, jnp.asarray(phon), jnp.asarray(tar), jnp.asarray(spk)[:, None],
        train, train, train, r=r, prenet_dropout=0.0,
        rngs={"dropout": jax.random.PRNGKey(0),
              "prenet": jax.random.PRNGKey(1)}, mutable=["batch_stats"]),
        static_argnums=1)
    for train in (False, True):
        out, mut = apply(v, train)
        load_into(tm, flatten(v))
        with torch.no_grad():
            got = tm(t(phon).long(), t(tar), t(spk)[:, None], train, train,
                     train, r=r, prenet_dropout=0.0)
        for k in OUT_KEYS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(out[k]),
                                       atol=5e-5, err_msg=f"{k} {train}")
        # (a jitted dict comes back with its keys sorted)
        for k in ("decoder_attention", "text_encoder_attention"):
            assert sorted(got[k]) == sorted(out[k])
        want_bn = flatten({"params": v["params"],
                           "batch_stats": mut["batch_stats"]})
        got_bn = export_flat(tm)
        for k in (k for k in want_bn if k.startswith("batch_stats")):
            np.testing.assert_allclose(got_bn[k], want_bn[k], atol=1e-6,
                                       err_msg=k)


def test_val_step_matches_etts(monkeypatch):
    """The validation step with both packages' prenet dropout replaced by
    the identity (etts fixes it at 0.5; patched here only): tts_loss and
    each loss within 1e-5 relative, outputs within 5e-5."""
    monkeypatch.setattr(jl, "variable_rate_dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tl, "variable_rate_dropout",
                        lambda x, rate, generator=None: x)
    jm, v, tm = train_pair(dropout_rate=0.0)
    batch = ar_train_batch(2)
    want = j_val_step(jm)(JState(v["params"], None, v["batch_stats"], 0),
                          to_jax(batch), jax.random.PRNGKey(0), r=3)
    got = make_autoregressive_val_step(tm)(to_torch(batch), 0, r=3)
    assert float(got["tts_loss"]) == pytest.approx(float(want["tts_loss"]),
                                                   rel=1e-5)
    for k in ("output", "stop_prob", "mel_linear"):
        assert float(got["losses"][k]) == pytest.approx(
            float(want["losses"][k]), rel=1e-5)
    np.testing.assert_allclose(got["final_output"].numpy(),
                               np.asarray(want["final_output"]), atol=5e-5)
    np.testing.assert_array_equal(got["reduced_target"].numpy(),
                                  np.asarray(want["reduced_target"]))
