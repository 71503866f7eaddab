"""GST-Tacotron's training of the port against etts' on the CPU, at
TACO_TINY's widths: the teacher-forced forward in train mode (BatchNorm on
batch statistics, the reference encoder's statistics moved twice, zoneout's
training masks) and in the GTA mode (``train=False``, a reference mel of
its own), ``tacotron_loss``, Noam's rate, the clipping and the whole
optimizer of the driver against optax's, one ``make_tacotron_train_step``
step's gradients (read exactly on etts' side through
``torch_parity.capture_tx``) and the Tacotron's initialisers.

Randomness: etts' prenet dropout is replaced in this process by dropout
that keeps every unit, the port fed uniforms of 0; etts' zoneout uniforms
by a constant U, injected into its ``jax.random.uniform`` (the port fed the
same U): U = 0 zones every unit out (the LSTMs' carries never move), U =
0.5 none. The port's own draw keeps 90 % of the units, tested by count.
Tolerances: outputs and losses 1e-5 (float32 on both sides, values of unit
scale), BatchNorm statistics 1e-6, each gradient within 1e-4 of its norm
(1e-6 absolute for the conv biases under a BatchNorm, zero in exact
arithmetic)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import etts.models.tacotron as jtaco
from etts.train import TrainState as JState
from etts.train import make_optimizer
from etts.train import make_tacotron_train_step as j_step
from etts_torch.convert import export_flat
from etts_torch.models import tacotron as ttaco
from etts_torch.models.init import init_flax
from etts_torch.train.state import clip_by_global_norm
from etts_torch.train.steps import make_tacotron_train_step
from etts_torch.train_tacotron import train_state
from torch_parity import (TACO_TINY, assert_grads_close, capture_state,
                          capture_tx, flatten, taco_pair, torch_grads)

TOL = 1e-5
STATS_TOL = 1e-6
KEY = jax.random.PRNGKey(0)
RNGS = {n: KEY for n in ("prenet", "zoneout", "dropout", "style")}
R = TACO_TINY["outputs_per_step"]


@pytest.fixture
def zoneout_at(monkeypatch):
    """etts with keep-all prenet dropout; ``set_u(u)`` makes every zoneout
    uniform it draws the constant u."""
    monkeypatch.setattr(jtaco, "variable_rate_dropout",
                        lambda x, rate, rng: x / (1.0 - rate))

    def set_u(u):
        fake = types.SimpleNamespace(**{
            **vars(jax.random),
            "uniform": lambda key, shape, *a, **k: jnp.full(shape, u,
                                                             jnp.float32)})
        monkeypatch.setattr(jtaco, "jax", types.SimpleNamespace(
            **{**vars(jax), "random": fake}))
    return set_u


def _batch(seed=0, b=2, n=7, t_mel=12):
    """ids zero-padded after each length, mels and linears in [0, 1]
    zero-padded after each row's frames, as the driver's batches are."""
    rng = np.random.default_rng(seed)
    lengths = np.array([n, n - 2])
    ids = rng.integers(1, TACO_TINY["vocab_size"], (b, n))
    ids[1, n - 2:] = 0
    mel = rng.uniform(0, 1, (b, t_mel, TACO_TINY["num_mels"]))
    lin = rng.uniform(0, 1, (b, t_mel, TACO_TINY["num_freq"]))
    mel[1, t_mel - 3:] = lin[1, t_mel - 3:] = 0.0
    return ids, lengths, mel.astype(np.float32), lin.astype(np.float32)


def _uniforms(tm, u, b=2, n=7, t_mel=12):
    """The port's uniforms of a forward: prenets 0 (every unit kept),
    zoneout the constant u."""
    draw = tm.draw_uniforms(b, n, t_mel // R, zoneout=True)
    return {k: torch.full_like(v, u if k == "zoneout" else 0.0)
            for k, v in draw.items()}


def _torch_batch(batch):
    return tuple(torch.from_numpy(a).long() if a.dtype.kind == "i"
                 else torch.from_numpy(a) for a in batch)


def _stats(flat: dict) -> dict:
    return {k: v for k, v in flat.items() if k.startswith("batch_stats")}


def test_teacher_forced_forward_matches_etts(zoneout_at):
    """U = 0: every LSTM unit zoned out. The six outputs within TOL; the
    BatchNorm statistics after the pass (the reference encoder's moved by
    the target and then by the prediction) within STATS_TOL, each moved."""
    zoneout_at(0.0)
    jm, v, tm = taco_pair()
    ids, lengths, mel, _ = _batch()
    want, mut = jax.jit(lambda v_, i, n, m: jm.apply(
        v_, i, n, m, train=True, rngs=RNGS, mutable=["batch_stats"]))(
            v, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(mel))
    before = _stats(export_flat(tm))
    got = tm(*_torch_batch((ids, lengths, mel)), _uniforms(tm, 0.0))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    assert got["alignments"].shape == (2, 12 // R, 7)
    after = _stats(export_flat(tm))
    want_stats = flatten({"params": {}, "batch_stats": mut["batch_stats"]})
    assert set(after) == set(want_stats)
    for k, w in want_stats.items():
        assert not np.array_equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k], w, rtol=0, atol=STATS_TOL,
                                   err_msg=k)


def test_train_step_matches_etts(zoneout_at):
    """U = 0.5: no unit zoned out. One step from the same weights: every
    gradient, the loss and its parts, the alignments, and the BatchNorm
    statistics after it."""
    zoneout_at(0.5)
    jm, v, tm = taco_pair(seed=1)
    batch = _batch(seed=2)
    jst, jmet = j_step(jm, capture_tx())(
        JState.create(v, capture_tx()), tuple(jnp.asarray(a) for a in batch),
        KEY)
    cs = capture_state(tm)
    u = _uniforms(tm, 0.5)
    tm.draw_uniforms = lambda *a, **k: u
    met = make_tacotron_train_step(tm)(cs, _torch_batch(batch), 0)
    assert cs.step == 1
    assert set(met) == {"loss", "mel_loss", "linear_loss", "ref_enc_loss",
                        "alignments"}
    for k in ("loss", "mel_loss", "linear_loss", "ref_enc_loss",
              "alignments"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert_grads_close(torch_grads(jst.opt_state), cs.grads, 1e-4, 1e-6)
    got = _stats(export_flat(tm))
    for k, w in flatten({"params": {},
                         "batch_stats": jst.batch_stats}).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=STATS_TOL,
                                   err_msg=k)


def test_gta_forward_matches_etts(zoneout_at):
    """``train=False`` with a reference mel of its own (the GTA pass): the
    running statistics, moved first by a training pass on both sides, and
    the inference zoneout mix. The six outputs within TOL; no statistic
    moves."""
    zoneout_at(0.0)
    jm, v, tm = taco_pair(seed=3)
    ids, lengths, mel, _ = _batch(seed=4)
    ref = _batch(seed=5, t_mel=16)[2]
    ids_j, len_j, mel_j = (jnp.asarray(a) for a in (ids, lengths, mel))
    _, mut = jax.jit(lambda v_, i, n, m: jm.apply(
        v_, i, n, m, train=True, rngs=RNGS, mutable=["batch_stats"]))(
            v, ids_j, len_j, mel_j)
    tm(*_torch_batch((ids, lengths, mel)), _uniforms(tm, 0.0))
    want = jax.jit(lambda v_, i, n, m, r: jm.apply(
        v_, i, n, m, r, train=False, rngs=RNGS))(
            {**v, "batch_stats": mut["batch_stats"]}, ids_j, len_j, mel_j,
            jnp.asarray(ref))
    before = _stats(export_flat(tm))
    with torch.no_grad():
        got = tm(*_torch_batch((ids, lengths, mel)), _uniforms(tm, 0.0),
                 reference_mel=torch.from_numpy(ref), train=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    after = _stats(export_flat(tm))
    for k, w in before.items():
        np.testing.assert_array_equal(after[k], w, err_msg=k)


def test_zoneout_draw_updates_ninety_percent():
    """On ``draw_uniforms``' own zoneout draws, one decoder step keeps the
    new c and h where floor(0.9 + U) is 1 and the old elsewhere: the new
    on 90 % of the units (within 4 standard deviations)."""
    torch.manual_seed(0)
    _, _, tm = taco_pair()
    cell, b, rd = tm.decoder_cell, 64, TACO_TINY["rnn_depth"]
    n, enc = 5, tm.memory_proj.in_features
    r = lambda *s: torch.randn(*s)
    carry = (r(b, TACO_TINY["attention_depth"]), (r(b, rd), r(b, rd)),
             (r(b, rd), r(b, rd)), r(b, enc))
    args = (r(b, TACO_TINY["prenet_depths"][-1]),
            r(b, n, TACO_TINY["attention_depth"]), r(b, n, enc),
            torch.ones(b, n, dtype=torch.bool), cell.stacked())
    zu = tm.draw_uniforms(b, 3, 1, seed=4, zoneout=True)["zoneout"][0]
    with torch.no_grad():
        new = cell.step(carry, *args, torch.full_like(zu, 0.5))[0]
        got = cell.step(carry, *args, zu)[0]
    kept, total = 0, 0
    for i in (1, 2):                          # the two LSTMs' (c, h)
        for j in (0, 1):
            is_new = got[i][j] == new[i][j]
            assert torch.equal(got[i][j][~is_new], carry[i][j][~is_new])
            assert torch.equal(is_new, torch.floor(0.9 + zu[i - 1, j]) == 1)
            kept += int(is_new.sum())
            total += is_new.numel()
    assert abs(kept / total - 0.9) < 4 * (0.09 / total) ** 0.5


def test_tacotron_loss_matches_etts():
    rng = np.random.default_rng(3)
    out = {"mel_outputs": rng.normal(size=(2, 8, 10)),
           "linear_outputs": rng.normal(size=(2, 8, 33)),
           "refnet_outputs": rng.normal(size=(2, 128)),
           "refnet_outputs2": rng.normal(size=(2, 128))}
    mel, lin = rng.uniform(size=(2, 8, 10)), rng.uniform(size=(2, 8, 33))
    f32 = lambda x: np.asarray(x, np.float32)
    jl, jparts = jtaco.tacotron_loss({k: jnp.asarray(f32(v))
                                      for k, v in out.items()},
                                     jnp.asarray(f32(mel)),
                                     jnp.asarray(f32(lin)))
    tl, tparts = ttaco.tacotron_loss(
        {k: torch.from_numpy(f32(v)) for k, v in out.items()},
        torch.from_numpy(f32(mel)), torch.from_numpy(f32(lin)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 3999, 4000, 100_000])
def test_noam_matches_etts(step):
    """Bit for bit at optax's update count (an int32 under jit)."""
    want = jax.jit(lambda s: jtaco.noam_learning_rate(2e-3, s))(
        jnp.asarray(step, jnp.int32))
    assert ttaco.noam_learning_rate(2e-3, step) == float(want)


@pytest.mark.parametrize("scale", [0.3, 4.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    """Below the bound the gradients come back unchanged; above it each
    within 1e-6 of optax's (one rounding of the norm's sum apart)."""
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 5))]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))
    grads = [g * np.float32(scale / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for g, w, x in zip(got, want, grads):
        if scale < 1:
            assert np.array_equal(g.numpy(), x)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_driver_optimizer_matches_etts():
    """The driver's train state against etts' driver's optimizer
    (`scripts/train_tacotron.py:89-97`: clip 1.0, Adam 0.9 / 0.999, eps
    1e-8, Noam from 2e-3) over 6 updates of gradients below and above the
    bound: the parameters within 1e-6 of their scale."""
    rng = np.random.default_rng(6)
    shapes = ((5, 3), (3,), (2, 4))
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    module = torch.nn.Module()
    for i, p in enumerate(params):
        module.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    config = {"adam_beta1": 0.9, "adam_beta2": 0.999,
              "initial_learning_rate": 2e-3}
    state = train_state(module, config)
    tx = make_optimizer(lr_schedule=lambda s: jtaco.noam_learning_rate(
        2e-3, s), b1=0.9, b2=0.999, eps=1e-8, clip_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    opt = tx.init(jp)
    update = jax.jit(tx.update)
    for k in range(6):
        grads = [rng.normal(0, 0.2 if k % 2 else 3.0, s).astype(np.float32)
                 for s in shapes]
        u, opt = update([jnp.asarray(g) for g in grads], opt, jp)
        jp = [p + d for p, d in zip(jp, u)]
        state.apply_gradients([torch.from_numpy(g) for g in grads])
    assert state.step == 6
    for p, w in zip(state.params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6 * float(
                                       np.abs(np.asarray(w)).max()))


def _flax_init(module, prefix, key, *args, **kwargs) -> dict:
    """``module.init``'s parameters as flat keys under ``prefix``."""
    params = module.init({"params": key, "prenet": key}, *args,
                         **kwargs)["params"]
    return {prefix + jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _etts_draws(init, n=12) -> dict:
    """{flat key: (n, ...) array} of ``init(key)`` over n keys (one
    compile)."""
    f = jax.jit(init)
    draws = [f(jax.random.PRNGKey(i)) for i in range(n)]
    return {k: np.stack([np.asarray(d[k]) for d in draws]) for k in draws[0]}


def _port_draws(make, n=12) -> dict:
    draws = [export_flat(init_flax(make(), torch.Generator().manual_seed(i)))
             for i in range(n)]
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


def _orthogonal(w) -> bool:
    """Each draw's rows or columns orthonormal."""
    return all(np.allclose(x @ x.T, np.eye(len(x)), atol=1e-5)
               or np.allclose(x.T @ x, np.eye(x.shape[1]), atol=1e-5)
               for x in w)


def _same_initialiser(want: dict, got: dict):
    """Each etts variable's kind of draw in the port's: all zero, one
    constant, orthogonal, or random with the standard deviation within
    10 % plus 3 standard errors of the estimate (over 12 draws; 41 % for
    the 48 values of the smallest, whose fan-in of 1 against a fan-in of
    d gives a factor 2)."""
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.min() == w.max():
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
            continue
        assert g.min() != g.max(), key
        if w.ndim == 3 and _orthogonal(w):
            assert _orthogonal(g), key
            continue
        ratio = g.std() / w.std()
        assert abs(ratio - 1) < 0.1 + 3 / (2 * w.size) ** 0.5, (key, ratio)


def test_tacotron_init_matches_etts():
    """init_flax on the port's Tacotron against etts' flax initialisers,
    module by module as etts draws them (one compile): the decoder cell's
    GRUCell and LSTMCells (flax's: input kernels lecun_normal, each
    recurrent gate orthogonal, biases zero) and its attention_v
    (lecun_normal of shape (1, d): a fan-in of 1), the weight-normalised
    style attention (attention_g sqrt(1 / d)), a highway (its T bias -1),
    a CBHG's BiGRU (etts' ``_gru_init``), and the text embedding and style
    tokens (a normal cut at 2, times 0.5). The Dense, Conv and BatchNorm
    layers elsewhere (projections, conv banks, the reference encoder, the
    linear head) take the generic initialisers checked here."""
    import flax.linen as nn
    c = TACO_TINY
    a, rd, w = c["attention_depth"], c["rnn_depth"], c["cbhg_width"]
    enc = 2 * w + c["style_embed_depth"]
    z = lambda *s: jnp.zeros(s)
    cell = "['decoder_cell']"

    def init(key):
        k = lambda i: jax.random.fold_in(key, i)
        out = {f"{cell}['attention_v']": nn.initializers.lecun_normal()(
            k(0), (1, a))}
        out |= _flax_init(nn.GRUCell(a), f"{cell}['attention_gru']", k(1),
                          z(2, a), z(2, c["prenet_depths"][-1] + enc))
        for i in (1, 2):
            out |= _flax_init(nn.LSTMCell(rd), f"{cell}['lstm_{i}']",
                              k(1 + i), (z(2, rd), z(2, rd)), z(2, rd))
        out |= _flax_init(jtaco.StyleAttention(c["num_heads"],
                                               c["style_att_dim"]),
                          "['style_attention']", k(4), z(2, 1, 128),
                          z(2, c["num_gst"], c["style_embed_depth"]
                            // c["num_heads"]))
        out |= _flax_init(jtaco.Highway(w), "['encoder_cbhg']['highway_1']",
                          k(5), z(2, 5, w))
        for j, (d, g) in enumerate((d, g) for d in ("fw", "bw")
                                   for g in ("wi", "wh", "bi", "bh")):
            out[f"['encoder_cbhg']['gru_{d}_{g}']"] = jtaco._gru_init(
                g, w, w)(k(6 + j), jtaco._gru_shape(g, w, w))
        return out | _flax_init(jtaco.Tacotron(**c), "", k(20),
                                jnp.ones((2, 7), jnp.int32),
                                method=lambda mdl, x: mdl.embedding(x))

    want = _etts_draws(init)
    assert {"['style_tokens']", "['text_embedding']['embedding']",
            f"{cell}['lstm_2']['hf']['kernel']"} <= set(want)
    _same_initialiser(want, _port_draws(lambda: ttaco.Tacotron(**c)))
