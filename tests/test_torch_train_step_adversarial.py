"""The adversarial MINE step against etts': the zoo's MI on the step's own
embeddings inside the tape (the critics held constant), the port given the
pair indices etts' keys draw. Every TTS gradient, the BatchNorm statistics
and the metrics (mi_live included) are held as test_torch_train_step.py
holds a step; no critic gets a gradient."""
import jax
import jax.numpy as jnp
import numpy as np

from etts.models import mine as jmine
from etts_torch.convert import load_into
from etts_torch.models import mine as tmine
from etts_torch.train import steps as tsteps
from torch_parity import (AR_TINY, SPK_DIM, ar_train_batch,
                          assert_step_close, flatten, step_pair, t,
                          train_pair)


def _draws(key, b, n):
    k_char, k_text, k_spk = jax.random.split(key, 3)
    return tmine.PairDraws(
        t(jax.random.randint(k_char, (), 0, n))[None].long(),
        t(jax.random.permutation(k_text, b)).long(),
        t(jax.random.permutation(k_spk, b)).long())


def test_adversarial_zoo_matches_etts(monkeypatch):
    pair = train_pair(dropout_rate=0.0)
    batch = ar_train_batch(0)
    b, n = batch[1].shape
    text, style = AR_TINY["encoder_model_dimension"], AR_TINY[
        "gst_style_embed_dim"]
    dims = dict(text_dim=text, style_dim=style, spk_dim=SPK_DIM)
    jnets = [("MINE", jmine.MINE("style_text", dense_hidden_units=(16, 8))),
             ("CLUB", jmine.CLUB("text_speaker", dense_hidden_units=(16,),
                                 out_dim=SPK_DIM)),
             ("MINE", jmine.MINE("style_speaker", divergence_type="reyni",
                                 dense_hidden_units=(16,)))]
    tnets = [("MINE", tmine.MINE("style_text", **dims,
                                 dense_hidden_units=(16, 8))),
             ("CLUB", tmine.CLUB("text_speaker", **dims,
                                 dense_hidden_units=(16,), out_dim=SPK_DIM)),
             ("MINE", tmine.MINE("style_speaker", **dims,
                                 divergence_type="reyni",
                                 dense_hidden_units=(16,)))]
    smoothing = 0.9
    state = jmine.MIState.create(3, smoothing_factor=smoothing)
    args = (jnp.zeros((b, n, text)), jnp.zeros((b, 1, style)),
            jnp.zeros((b, 1, SPK_DIM)))
    params = []
    for i, ((_, jn), (_, tn)) in enumerate(zip(jnets, tnets)):
        k = jax.random.PRNGKey(20 + i)
        params.append(jn.init(k, *args, state, k)["params"])
        load_into(tn, flatten({"params": params[-1]}))
    key = 3
    draws = [_draws(jax.random.fold_in(jax.random.PRNGKey(key), 101 + i),
                    b, n) for i in range(3)]
    monkeypatch.setattr(tsteps, "pair_draws", lambda b, n, g: draws.pop(0))
    tstate = tmine.MIState.create(3, smoothing_factor=smoothing)
    j, p = step_pair(pair, batch, r=3, mi=tstate, jax_mi=(params, state),
                     key=key, adversarial_mine=(jnets, tnets))
    assert float(p[1]["mi_live"]) != 0.0
    # mi_live sums three estimates of exp and log terms that cancel (it
    # reads -0.72): 1e-4 absolute on the metrics
    assert_step_close(j, p, metric_atol=1e-4)
    assert all(q.grad is None for _, net in tnets for q in net.parameters())
