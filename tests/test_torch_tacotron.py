"""The port's GST-Tacotron (``etts_torch/models/tacotron.py``) against
etts' on the same weights: each module, one decoder step, ``encode`` with
and without a reference, and ``generate`` with a stop inside the run.

The weights are numpy draws for every variable of etts' flax tree
(``torch_parity.taco_pair``), carried into the port by ``convert``.
etts' prenet dropout cannot be drawn alike across frameworks: the tests
replace ``etts.models.tacotron.variable_rate_dropout`` in this process by
dropout that keeps every unit, and feed the port uniforms of 0 (every unit
kept); the random style weights are injected into both. Tolerance: 1e-5
absolute on every output (float32 on both sides, values of unit scale)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etts.models.tacotron as jtaco
from etts_torch.convert import convert, export_flat
from etts_torch.models import tacotron as ttaco
from torch_parity import (TACO_TINY, draw_flat, flax_shapes, taco_flat,
                          taco_pair, unflatten)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
RNGS = {n: KEY for n in ("prenet", "zoneout", "dropout", "style")}


@pytest.fixture
def keep_all(monkeypatch):
    """etts' always-on dropout keeping every unit, scaled by 1 / keep."""
    monkeypatch.setattr(jtaco, "variable_rate_dropout",
                        lambda x, rate, rng: x / (1.0 - rate))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _inputs(seed=0, b=2, n=7, t_mel=13):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TACO_TINY["vocab_size"], (b, n))
    lengths = np.array([n] + [n - 2] * (b - 1))
    mel = rng.uniform(0, 1, (b, t_mel, TACO_TINY["num_mels"]))
    return ids, lengths, mel.astype(np.float32)


def _sub(variables, name):
    return {col: variables[col][name] for col in variables
            if name in variables[col]}


def _zeros(u):
    """Prenet uniforms of 0 (every unit kept); the style's kept."""
    return {k: v if k == "style" else torch.zeros_like(v)
            for k, v in u.items()}


@pytest.mark.parametrize("over", [{}, {"style_att_type": "dot_attention"},
                                  {"use_gst": False}])
def test_convert_maps_every_flax_variable(over):
    """Every variable of etts' tree has its place in the port and back;
    convert raises on a key too many or too few."""
    _, _, tm = taco_pair(**over)
    flat = export_flat(tm)
    assert ({k: v.shape for k, v in flat.items()}
            == {k: v.shape for k, v in taco_flat(**over).items()})
    assert "['decoder_cell']['lstm_1']['if']['kernel']" in flat
    with pytest.raises(KeyError):
        convert({**flat, "['decoder_cell']['extra']": np.zeros(1)}, tm)
    with pytest.raises(KeyError):
        convert({k: v for k, v in flat.items() if "attention_gru" not in k},
                tm)


@pytest.mark.parametrize("name,K,t", [("encoder_cbhg", 16, 9),
                                      ("post_cbhg", 8, 10)])
def test_cbhg_matches_etts(name, K, t):
    """The encoder's bank (k = 1..16, even k padded one more after) and
    the post CBHG's (k = 1..8, projection to num_mels, dim_match); the
    max-pool's -inf frame after the last."""
    jm, v, tm = taco_pair()
    w = TACO_TINY["cbhg_width"]
    proj = (w, w) if K == 16 else (2 * w, TACO_TINY["num_mels"])
    in_dim = TACO_TINY["prenet_depths"][-1] if K == 16 else proj[1]
    x = np.random.default_rng(K).normal(0, 1, (2, t, in_dim)).astype(
        np.float32)
    want = jtaco.CBHG(K=K, projections=proj, width=w).apply(
        _sub(v, name), jnp.asarray(x), False)
    _close(getattr(tm, name)(torch.from_numpy(x)), want)


def test_reference_encoder_matches_etts():
    """13 frames and 10 bins: stride-2 SAME convs pad one more after."""
    jm, v, tm = taco_pair()
    _, _, mel = _inputs()
    want = jtaco.TacoReferenceEncoder(
        TACO_TINY["reference_filters"], TACO_TINY["reference_depth"]).apply(
            _sub(v, "ref_encoder"), jnp.asarray(mel), False)
    _close(tm.ref_encoder(torch.from_numpy(mel)), want)


@pytest.mark.parametrize("kind", ["mlp_attention", "dot_attention"])
@pytest.mark.parametrize("normalize", [True, False])
def test_style_attention_matches_etts(kind, normalize):
    jmod = jtaco.StyleAttention(num_heads=2, num_units=8,
                                attention_type=kind, normalize=normalize)
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 1, 12)).astype(np.float32)
    val = np.tanh(rng.normal(0, 1, (2, 4, 6))).astype(np.float32)
    flat = draw_flat(flax_shapes(jmod, jnp.asarray(q), jnp.asarray(val)), 2)
    tmod = ttaco.StyleAttention(12, 6, 2, 8, kind, normalize)
    tmod.load_state_dict(convert(flat, tmod))
    want = jmod.apply(unflatten(flat), jnp.asarray(q), jnp.asarray(val))
    _close(tmod(torch.from_numpy(q), torch.from_numpy(val)), want)


def test_decoder_cell_step_matches_etts(keep_all):
    """One step from a random carry, a padded encoder step masked."""
    jm, v, tm = taco_pair()
    rng = np.random.default_rng(5)
    b, n, a, rd = 2, 7, TACO_TINY["attention_depth"], TACO_TINY["rnn_depth"]
    enc_dim = tm.memory_proj.in_features
    r = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)
    carry = (r(b, a), (r(b, rd), r(b, rd)), (r(b, rd), r(b, rd)),
             r(b, enc_dim))
    prev, values = r(b, TACO_TINY["num_mels"]), r(b, n, enc_dim)
    keys = r(b, n, a)
    mask = np.arange(n)[None] < np.array([[n], [n - 3]])
    jcell = jtaco.TacotronDecoderCell(
        attention_depth=a, rnn_depth=rd, num_mels=TACO_TINY["num_mels"],
        outputs_per_step=2, prenet_depths=TACO_TINY["prenet_depths"])
    (jcarry, (jframe, jalign)) = jcell.apply(
        _sub(v, "decoder_cell"), jax.tree.map(jnp.asarray, carry),
        jnp.asarray(prev), jnp.asarray(keys), jnp.asarray(values),
        jnp.asarray(mask), False, rngs={"prenet": KEY})
    tt = lambda x: jax.tree.map(torch.from_numpy, x)
    u = torch.zeros(b, sum(TACO_TINY["prenet_depths"]))
    with torch.no_grad():
        tcarry, frame, align = tm.decoder_cell(
            tt(carry), tt(prev), tt(keys), tt(values),
            torch.from_numpy(mask), u)
    _close(frame, jframe)
    _close(align, jalign)
    assert float(align[1, n - 3:].abs().max()) == 0.0
    for got, want in zip(jax.tree.leaves(tcarry), jax.tree.leaves(jcarry)):
        _close(got, want)


def _encode_pair(reference: bool):
    jm, v, tm = taco_pair()
    ids, lengths, mel = _inputs()
    u = _zeros(tm.draw_uniforms(2, 7, seed=3))
    ref = mel if reference else None
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(lengths),
                    None if ref is None else jnp.asarray(ref),
                    method=jtaco.Tacotron.encode, rngs=RNGS)
    got = tm.encode(torch.from_numpy(ids),
                    None if ref is None else torch.from_numpy(ref), u)
    return got, want, u


def test_encode_with_reference_matches_etts(keep_all):
    (enc, style, ref), (jenc, jstyle, jref), _ = _encode_pair(True)
    assert enc.shape == (2, 7, 2 * 8 + 16)
    _close(enc, jenc)
    _close(style, jstyle)
    _close(ref, jref)


def test_encode_without_reference_injected_style(keep_all, monkeypatch):
    """etts draws the random style weights from its "style" rng: the same
    uniforms are injected into its ``jax.random.uniform``."""
    _, _, tm = taco_pair()
    u_style = tm.draw_uniforms(2, 7, seed=3)["style"].numpy()
    fake = types.SimpleNamespace(**{
        **vars(jax.random),
        "uniform": lambda key, shape, *a, **k: jnp.asarray(u_style)})
    monkeypatch.setattr(jtaco, "jax", types.SimpleNamespace(
        **{**vars(jax), "random": fake}))
    (enc, style, ref), (jenc, jstyle, jref), u = _encode_pair(False)
    assert ref is None and jref is None
    _close(style, jstyle)
    _close(enc, jenc)
    want = (torch.softmax(u["style"], -1)
            @ torch.tanh(tm.style_tokens)).reshape(1, 1, -1)
    _close(style[:1], want.detach().numpy())


def _generate_pair(flat=None):
    jm, v, tm = taco_pair(flat=flat)
    ids, lengths, mel = _inputs()
    want = jax.jit(lambda v_, i, n, m: jm.apply(
        v_, i, n, m, method=jtaco.Tacotron.generate, rngs=RNGS))(
            v, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(mel))
    got = tm.generate(torch.from_numpy(ids), torch.from_numpy(lengths),
                      torch.from_numpy(mel),
                      uniforms=_zeros(tm.draw_uniforms(2, 7, seed=1)))
    for k in ("mel_outputs", "linear_outputs", "alignments",
              "style_embeddings"):
        _close(got[k], want[k])
    return got["mel_outputs"].numpy(), np.asarray(want["mel_outputs"])


def test_generate_matches_etts(keep_all):
    mel, _ = _generate_pair()
    assert mel.shape == (2, TACO_TINY["max_iters"] * 2, TACO_TINY["num_mels"])
    assert (np.abs(mel) > 1e-6).any(-1).all()       # never stops


def _stopping_weights() -> dict:
    """A decoder whose frames fall below 1e-6 at step 3 of 6: the attention
    GRU reads nothing (input and recurrent kernels 0), so its h after step
    t is tanh(1) * (1 - z^(t + 1)) with z = 0.02; rnn_proj maps it to
    h - tanh(1), the LSTMs output 0 and frame_proj averages, so every
    frame of step t is -tanh(1) * 0.02^(t + 1): 6.1e-6 at step 2, 1.2e-7
    at step 3."""
    flat = taco_flat()
    cell = "['decoder_cell']"
    z = 0.02
    for key in list(flat):
        if not key.startswith(cell) or "decoder_prenet" in key:
            continue
        if "attention_gru" in key or "lstm_" in key:
            flat[key] = np.zeros_like(flat[key])
    flat[f"{cell}['attention_gru']['iz']['bias']"][:] = np.log(z / (1 - z))
    flat[f"{cell}['attention_gru']['in']['bias']"][:] = 1.0
    a = TACO_TINY["attention_depth"]
    k = np.zeros_like(flat[f"{cell}['rnn_proj']['kernel']"])
    k[:a, :a] = np.eye(a)
    flat[f"{cell}['rnn_proj']['kernel']"] = k
    flat[f"{cell}['rnn_proj']['bias']"][:] = -np.tanh(1.0)
    kf = flat[f"{cell}['frame_proj']['kernel']"]
    flat[f"{cell}['frame_proj']['kernel']"] = np.full_like(kf, 1 / a)
    flat[f"{cell}['frame_proj']['bias']"][:] = 0.0
    return flat


def test_generate_stops_inside_the_run(keep_all):
    """Step 3's frames fall below 1e-6 and are kept; steps 4 and 5 are
    zeroed, on both sides, and the alignments go on being computed."""
    got, want = _generate_pair(_stopping_weights())
    r = 2
    for mel in (got, want):
        level = np.abs(mel).max(-1).reshape(2, -1, r).max(-1)   # (b, steps)
        assert (level[:, :3] > 1e-6).all()
        assert (level[:, 3] > 0).all() and (level[:, 3] < 1e-6).all()
        assert (mel[:, 4 * r:] == 0).all()


def test_generate_draws_from_the_seed():
    _, _, tm = taco_pair()
    ids, lengths, mel = (torch.from_numpy(x) for x in _inputs())
    run = lambda s, m=mel: tm.generate(ids, lengths, m, seed=s)
    a, b = run(0), run(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mel_outputs"], run(1)["mel_outputs"])
    assert not torch.equal(run(0, None)["style_embeddings"],
                           run(1, None)["style_embeddings"])


def test_prenet_dropout_keeps_half_scaled_by_two():
    """On the draws ``generate`` makes: each unit kept with probability
    0.5 (within 4 standard deviations over 500 steps' units) and times
    2."""
    u = ttaco.Tacotron(**TACO_TINY).draw_uniforms(1, 3, 500, seed=7)
    u = u["decoder_prenet"][:, 0]
    net = ttaco.TacoPrenet(4, (u.shape[-1],))
    with torch.no_grad():
        net.dense_1.weight.zero_()
        net.dense_1.bias.fill_(1.0)
    out = net(torch.ones(500, 4), u)
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0))
    share = float(kept.float().mean())
    assert abs(share - 0.5) < 4 * (0.25 / kept.numel()) ** 0.5
