"""The port's MINE/CLUB against etts: ``measure_mi`` (KL and Rényi-β, each
β branch, smoothing below 1), ``build_pairs`` for every pair type on the
indices etts' own key splits draw, every critic, the MINE and CLUB modules,
and the zoo update's gradients (etts' read through a transformation that
keeps them), MIs and carried terms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models import layers as jl
from etts.models import mine as jmine
from etts.train import TrainState as JState
from etts.train import make_mine_zoo_update as j_zoo
from etts_torch.convert import load_into
from etts_torch.models import layers as tl
from etts_torch.models import mine as tmine
from etts_torch.train import steps as tsteps
from torch_parity import (assert_grads_close, capture_state, capture_tx,
                          flatten, t, torch_grads)

B, N, TEXT, STYLE, SPK = 8, 6, 12, 10, 7


def _embeds(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, TEXT)).astype(np.float32),
            rng.normal(size=(B, 1, STYLE)).astype(np.float32),
            rng.normal(size=(B, 1, SPK)).astype(np.float32))


def etts_draws(key, b=B, n=N):
    """The port's PairDraws of etts' key: its split into three, randint
    and the two permutations, as etts' build_pairs draws them."""
    k_char, k_text, k_spk = jax.random.split(key, 3)
    return tmine.PairDraws(
        t(jax.random.randint(k_char, (), 0, n))[None].long(),
        t(jax.random.permutation(k_text, b)).long(),
        t(jax.random.permutation(k_spk, b)).long())


@pytest.mark.parametrize("div, betas", [("KL", ()), ("reyni", (0.0,)),
                                        ("reyni", (0.5,)), ("reyni", (1.0,)),
                                        ("reyni", (0.0, 0.5, 1.0))])
def test_measure_mi_matches_etts(div, betas):
    """Smoothing 0.7 against carried terms: mi and new terms within 1e-5
    relative."""
    rng = np.random.default_rng(1)
    joint = rng.normal(1.0, 1.0, (32, 1, 1)).astype(np.float32)
    marg = rng.normal(0.0, 1.0, (32, 1, 1)).astype(np.float32)
    terms = rng.uniform(0.5, 2.0, (max(len(betas), 1), 2)).astype(np.float32)
    want_mi, want_terms = jmine.measure_mi(
        jnp.asarray(joint), jnp.asarray(marg), jnp.asarray(terms), 0.7, div,
        betas)
    mi, new = tmine.measure_mi(t(joint), t(marg), t(terms), 0.7, div, betas)
    assert float(mi) == pytest.approx(float(want_mi), rel=1e-5)
    np.testing.assert_allclose(new.numpy(), np.asarray(want_terms),
                               rtol=1e-5)


@pytest.mark.parametrize("pair", tmine.PAIR_TYPES)
def test_build_pairs_on_etts_draws(pair):
    """Bit for bit, with the port given the indices etts' key draws."""
    text, style, spk = _embeds()
    key = jax.random.PRNGKey(5)
    want = jmine.build_pairs(pair, jnp.asarray(text), jnp.asarray(style),
                             jnp.asarray(spk), key)
    got = tmine.build_pairs(pair, t(text), t(style), t(spk), etts_draws(key))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CRITICS = {
    "first_order": (lambda: jl.MineNetFirstOrder((16, 8)), (5, 1, 20),
                    lambda: tl.MineNetFirstOrder(20, (16, 8))),
    "second_order": (lambda: jl.MineNetSecondOrder((3, 4), 3, (16,)),
                     (5, 9, 20),
                     lambda: tl.MineNetSecondOrder(20, 9, (3, 4), 3, (16,))),
    "linear": (lambda: jl.MineNetLinear((16,)), (5, 1, 20),
               lambda: tl.MineNetLinear(20, (16,))),
    "linear_q": (lambda: jl.MineNetLinearQ((16,)), (5, 1, 20),
                 lambda: tl.MineNetLinearQ(20, (16,))),
    "club_mu": (lambda: jl.CLUBNet((16,), False, out_dim=12), (5, 1, 20),
                lambda: tl.CLUBNet(20, (16,), False, 12)),
    "club_log_var": (lambda: jl.CLUBNet((16,), True, out_dim=12),
                     (5, 1, 20), lambda: tl.CLUBNet(20, (16,), True, 12)),
}


@pytest.mark.parametrize("name", sorted(CRITICS))
def test_critics_match_etts(name):
    """etts' weights carried across by name; outputs within 1e-5."""
    make_j, shape, make_t = CRITICS[name]
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    jm = make_j()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    net = load_into(make_t(), flatten(v))
    np.testing.assert_allclose(net(t(x)).detach().numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=1e-5)


def _zoo():
    """(etts nets, port nets): a KL MINE, a CLUB and a Rényi MINE, the last
    net a MINE so that its exp_terms are carried."""
    dims = dict(text_dim=TEXT, style_dim=STYLE, spk_dim=SPK)
    j = [("MINE", jmine.MINE("style_text", dense_hidden_units=(16, 8))),
         ("CLUB", jmine.CLUB("style_speaker", dense_hidden_units=(16,),
                             out_dim=SPK)),
         ("MINE", jmine.MINE("text_speaker", divergence_type="reyni",
                             dense_hidden_units=(16,)))]
    p = [("MINE", tmine.MINE("style_text", **dims, dense_hidden_units=(16, 8))),
         ("CLUB", tmine.CLUB("style_speaker", **dims, dense_hidden_units=(16,),
                             out_dim=SPK)),
         ("MINE", tmine.MINE("text_speaker", **dims, divergence_type="reyni",
                             dense_hidden_units=(16,)))]
    return j, p


@pytest.mark.parametrize("i", range(3))
def test_mine_and_club_modules_match_etts(i):
    text, style, spk = _embeds(1)
    (kind, jnet), (_, tnet) = _zoo()[0][i], _zoo()[1][i]
    state = jmine.MIState.create(3, smoothing_factor=0.6)
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(text), jnp.asarray(style), jnp.asarray(spk))
    v = jnet.init(key, *args, state, key)
    load_into(tnet, flatten(v))
    want = jnet.apply(v, *args, state, key)
    got = tnet(t(text), t(style), t(spk),
               tmine.MIState.create(3, smoothing_factor=0.6),
               etts_draws(key))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def test_zoo_update_matches_etts(monkeypatch):
    """One zoo update: each net's gradients (relative L2 1e-5, plus 1e-6
    for those zero in exact arithmetic: the MINE bound does not move when
    its critic's output shifts, so the output bias's gradient is rounding
    noise), the MIs within 1e-5 relative, and the carried exp_terms: the
    last net's."""
    text, style, spk = _embeds(2)
    jnets, tnets = _zoo()
    state = jmine.MIState(jnp.asarray(np.random.default_rng(4).uniform(
        0.5, 2, (3, 2)).astype(np.float32)), jnp.zeros(()),
        smoothing_factor=0.8)
    args = (jnp.asarray(text), jnp.asarray(style), jnp.asarray(spk))
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    jstates, tstates = [], []
    for (_, jn), (_, tn), k in zip(jnets, tnets, keys):
        v = jn.init(k, *args, state, k)
        jstates.append(JState.create(v, capture_tx()))
        tstates.append(capture_state(load_into(tn, flatten(v))))
    new, want_mis, want_terms = j_zoo(jnets, capture_tx())(
        jstates, *args, state, tuple(keys))
    draws = [etts_draws(k) for k in keys]
    monkeypatch.setattr(tsteps, "pair_draws", lambda b, n, g: draws.pop(0))
    tstate = tmine.MIState(t(state.exp_terms), torch.zeros(()), 0.8)
    mis, terms = tsteps.make_mine_zoo_update(tnets)(
        tstates, t(text), t(style), t(spk), tstate, range(3))
    np.testing.assert_allclose(mis.numpy(), np.asarray(want_mis), rtol=1e-5)
    np.testing.assert_allclose(terms.numpy(), np.asarray(want_terms),
                               rtol=1e-5)
    for js, ts in zip(new, tstates):
        assert_grads_close(torch_grads(js.opt_state), ts.grads, 1e-5, 1e-6)
