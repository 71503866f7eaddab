"""The port's ``precision: bfloat16`` against etts': the config key, the
AR model's teacher-forced forward and decode, the forward model, the
reference encoder, one AR and one forward train step's gradients, and an
overfit whose parameters stay float32.

etts' reference is compiled with XLA's excess precision off (``STRICT``).
With it on, XLA may keep a fusion's intermediates in float32 where flax's
graph rounds them to bf16: a compiler's liberty, not the model's
arithmetic, and not what an eager run of etts does. The port rounds where
flax's graph rounds, op by op. For the gradients, etts' reference also
sums bf16 values in float32 (``float32_sums``): XLA's CPU backend
accumulates a bf16 sum in bf16 (a bias's gradient over the batch and time,
a tiled style vector's over the text), where the port, as PyTorch does on
the card and on the CPU, accumulates in float32 and rounds once.

Each output is held at a norm-relative 2e-2 of etts' bf16 output AND
within half of etts' own bf16-vs-float32 distance, so that a port that
computed in float32 would fail."""
import contextlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from etts.models.autoregressive import autoregressive_predict as etts_predict
from etts.train import TrainState as JState
from etts.train import make_autoregressive_train_step as etts_ar_step
from etts.train import make_forward_train_step as etts_fwd_step
from etts_torch.models.autoregressive import (AutoregressiveTransformer,
                                              autoregressive_predict)
from etts_torch.models.init import init_flax
from etts_torch.models.layers import Compute, set_compute_dtype
from etts_torch.text import default_tokenizer
from etts_torch.train.state import TrainState
from etts_torch.train.steps import (make_autoregressive_train_step,
                                    make_forward_train_step)
from etts_torch.utils.config import build_forward, build_tts, load_config
from torch_parity import (ROOT, ar_train_batch, capture_state, capture_tx,
                          forward_train_batch, forward_train_pair, to_jax,
                          to_torch, torch_grads, train_pair)

STRICT = {"xla_allow_excess_precision": False}
OUT_TOL = 2e-2
GRAD_TOL = 5e-2
R = 2


def strict(fn, *args):
    """fn(*args), jitted and compiled with excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


@contextlib.contextmanager
def float32_sums():
    """Lower every bf16 ``reduce_sum`` compiled inside as a float32 sum
    rounded once to bf16; the lowering is restored on exit."""
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as lax_internal
    prim = lax_internal.reduce_sum_p
    entry = mlir._lowerings[prim]

    def rule(ctx, x, *, axes, **kw):
        if ctx.avals_in[0].dtype != jnp.bfloat16:
            return entry.rule(ctx, x, axes=axes, **kw)
        return mlir.lower_fun(lambda v: jnp.sum(
            v.astype(jnp.float32), axis=tuple(axes)).astype(jnp.bfloat16),
            multiple_results=False)(ctx, x)
    mlir._lowerings[prim] = mlir.LoweringRuleEntry(rule, entry.inline)
    try:
        yield
    finally:
        mlir._lowerings[prim] = entry


def rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_bf16_close(port, etts_bf16, etts_f32, tol=OUT_TOL, what=""):
    """The port's bf16 output within ``tol`` of etts' and closer to it
    than half of etts' own bf16-vs-float32 distance."""
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    d, control = rel(port, etts_bf16), rel(etts_bf16, etts_f32)
    assert d <= tol and d < 0.5 * control, (what, d, control)


# ---------------------------------------------------------------------------
# the config key
# ---------------------------------------------------------------------------

def _default_configs(tmp_path, precision):
    cfg = tmp_path / "cfg"
    shutil.copytree(ROOT / "configs/default", cfg)
    if precision is not None:
        for name in ("autoregressive_config.yaml", "forward_config.yaml"):
            d = yaml.safe_load((cfg / name).read_text())
            d["precision"] = precision
            (cfg / name).write_text(yaml.safe_dump(d))
    return cfg


def _built(cfg):
    ar = build_tts(load_config(cfg, "autoregressive"),
                   default_tokenizer(True).vocab_size)
    fwd = build_forward(load_config(cfg, "forward"),
                        default_tokenizer(False).vocab_size)
    return ar, fwd


@pytest.mark.parametrize("precision", ["bfloat16", "bf16", None])
def test_precision_key_sets_compute_dtype(tmp_path, precision):
    """`tests/test_config_manager.py:86` for the port: the key gives bf16
    compute on float32 parameters (and statistics) in both models; with
    no key the models compute in float32."""
    want = torch.float32 if precision is None else torch.bfloat16
    for model in _built(_default_configs(tmp_path, precision)):
        assert model.dtype == want
        assert all(m.dtype == want for m in model.modules()
                   if isinstance(m, Compute))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(b.dtype == torch.float32 for n, b in
                   model.named_buffers() if "running" in n)


def test_unknown_precision_raises(tmp_path):
    cfg = _default_configs(tmp_path, "float16")
    with pytest.raises(KeyError):
        _built(cfg)


def test_float32_weights_load_and_come_back_unchanged():
    """A float32 model's state dict loads into a bf16 model and comes back
    bit for bit (`etts/utils/config.py:150`)."""
    _, _, tm = train_pair("text")
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    bf16 = set_compute_dtype(AutoregressiveTransformer(
        system_type="text", **_tiny_ar()), torch.bfloat16)
    bf16.load_state_dict(state)
    back = bf16.state_dict()
    assert set(back) == set(state)
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v)
               for k, v in state.items())


def _tiny_ar():
    from torch_parity import AR_TINY
    return dict(AR_TINY, speaker_embed_dim=256)


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ar():
    """The speaker + style model (its encoder output float32 by the
    concatenated speaker vector, as in etts), dropout 0: etts' flax
    modules in float32 and bf16 and the port's bf16 model on one set of
    weights, and a batch."""
    jm, v, tm = train_pair("speaker_style_text", seed=0, dropout_rate=0.0)
    set_compute_dtype(tm, torch.bfloat16)
    return jm, jm.clone(dtype=jnp.bfloat16), v, tm, ar_train_batch(0)


def test_ar_teacher_forced_outputs(ar):
    jm, jb, v, tm, (mel, phon, _, spk) = ar
    tar = mel[:, :-1][:, ::R]
    rngs = {"dropout": jax.random.PRNGKey(0), "prenet": jax.random.PRNGKey(0)}

    def run(model):
        return lambda v, p, m, s: model.apply(
            v, p, m, s, False, False, False, r=R, prenet_dropout=0.0,
            rngs=rngs)
    args = (v, jnp.asarray(phon), jnp.asarray(tar), jnp.asarray(spk)[:, None])
    want, f32 = strict(run(jb), *args), jax.jit(run(jm))(*args)
    with torch.no_grad():
        got = tm(torch.from_numpy(phon).long(), torch.from_numpy(tar),
                 torch.from_numpy(spk)[:, None], r=R, prenet_dropout=0.0)
    for k in ("final_output", "mel_linear", "stop_prob", "gst_output"):
        assert got[k].dtype == torch.bfloat16, k
        assert_bf16_close(got[k], want[k], f32[k], what=k)
    for k, w in got["decoder_attention"].items():
        assert w.dtype == torch.float32, k
        assert_bf16_close(w, want["decoder_attention"][k],
                          f32["decoder_attention"][k], what=k)


def test_ar_decode_four_steps(ar):
    """autoregressive_predict at r = 2 for 4 steps, dropout 0, no stop:
    KV caches, postnet window and feedback in bf16, the cross-attention
    K/V in float32, as etts decodes."""
    jm, jb, v, tm, (mel, phon, _, spk) = ar
    ref = mel[:1, :-1][:, ::R]

    def run(model):
        return lambda v, p, m, s: etts_predict(
            model, v, p, m, s, r=R, max_length=6, prenet_dropout=0.0,
            stop_enabled=False)["mel"]
    args = (v, jnp.asarray(phon[:1]), jnp.asarray(ref),
            jnp.asarray(spk[:1])[:, None])
    want, f32 = strict(run(jb), *args), jax.jit(run(jm))(*args)
    out = autoregressive_predict(
        tm, torch.from_numpy(phon[:1]).long(), torch.from_numpy(ref),
        torch.from_numpy(spk[:1])[:, None], r=R, max_length=6,
        prenet_dropout=0.0, stop_enabled=False)
    assert out["steps"] == 4 and out["mel"].dtype == torch.bfloat16
    assert_bf16_close(out["mel"], want, f32, what="decoded mel")


def test_reference_encoder(ar):
    """ReferenceEncoderGST alone (``encode_style``): bf16 convs, float32
    BatchNorm statistics, the GRU's float32 gates, the token bank."""
    jm, jb, v, tm, (mel, *_) = ar

    def run(model):
        return lambda v, m: model.apply(v, m, method=type(model).encode_style)
    args = (v, jnp.asarray(mel))
    (want, wa, _), (f32, fa, _) = (strict(run(jb), *args),
                                   jax.jit(run(jm))(*args))
    with torch.no_grad():
        got, ga, _ = tm.encode_style(torch.from_numpy(mel))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, f32, what="style embedding")
    assert_bf16_close(ga["gst_attention"], wa["gst_attention"],
                      fa["gst_attention"], what="token attention")


@pytest.fixture(scope="module")
def fwd():
    jf, v, tf = forward_train_pair(0)
    set_compute_dtype(tf, torch.bfloat16)
    return jf, jf.clone(dtype=jnp.bfloat16), v, tf, forward_train_batch(0)


def test_forward_model(fwd):
    """The forward model with the target durations injected (the mel), and
    its own bf16 duration predictions, rounded half to even: equal to
    etts' wherever etts' value is off a rounding edge."""
    jf, jb, v, tf, (mel, phon, dur) = fwd

    rngs = {"dropout": jax.random.PRNGKey(0), "prenet": jax.random.PRNGKey(0)}

    def run(model):
        return lambda v, p, d: model.apply(v, p, d, max_frames=48, rngs=rngs)
    args = (v, jnp.asarray(phon), jnp.asarray(dur)[..., None])
    want, f32 = strict(run(jb), *args), jax.jit(run(jf))(*args)
    with torch.no_grad():
        got = tf(torch.from_numpy(phon).long(),
                 torch.from_numpy(dur)[..., None], max_frames=48)
    assert got["mel"].dtype == torch.bfloat16
    assert_bf16_close(got["mel"], want["mel"], f32["mel"], what="mel")
    d_want = np.asarray(want["duration"], np.float64)
    d_got = got["duration"].double().numpy()
    assert_bf16_close(d_got, d_want, f32["duration"], what="durations")
    off_edge = np.abs(d_want - np.floor(d_want) - 0.5) > 1e-2
    assert off_edge.mean() > 0.5
    np.testing.assert_array_equal(np.round(d_got)[off_edge],
                                  np.round(d_want)[off_edge])


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

BF16_U = 2.0 ** -8      # bf16's unit roundoff (8 significant bits)


def cancellation(model, run) -> dict:
    """{bias name: kappa}, each bias's float64 cancellation factor in one
    step of ``model``: its gradient is the sum, over every position of the
    layer's output, of the gradient there, and kappa is the norm of the
    sums of those terms' magnitudes over the norm of their sums. ``run``
    takes a float64 copy of the model (the float32 compute path: no
    casts) and takes one step of it with a ``capture_state``."""
    import copy
    import etts_torch.models.layers as layers
    m64 = set_compute_dtype(copy.deepcopy(model), torch.float32).double()
    terms = {}

    def keep(bias, y, ch):
        if y.requires_grad:
            y.register_hook(lambda g: terms.setdefault(id(bias), []).append(
                g.movedim(ch, -1).reshape(-1, g.shape[ch])))
    batch_norm = layers.batch_norm

    def hooked(bn, x, train, *a, **k):
        y = batch_norm(bn, x, train, *a, **k)
        keep(bn.bias, y, 1)
        return y
    for m in m64.modules():
        if getattr(m, "bias", None) is None or not isinstance(
                m, (torch.nn.Linear, torch.nn.LayerNorm, torch.nn.Conv1d,
                    torch.nn.Conv2d)):
            continue
        ch = -1 if isinstance(m, (torch.nn.Linear, torch.nn.LayerNorm)) else 1
        m.register_forward_hook(lambda mod, _, y, ch=ch: keep(mod.bias, y, ch))
    layers.batch_norm = hooked
    try:
        run(m64)
    finally:
        layers.batch_norm = batch_norm
    names = {id(p): n for n, p in m64.named_parameters()}
    out = {}
    for pid, gs in terms.items():
        g = torch.cat(gs)
        out[names[pid]] = float(g.abs().sum(0).norm()
                                / max(float(g.sum(0).norm()), 1e-300))
    return out


def f64(batch):
    return tuple(x.double() if x.is_floating_point() else x for x in batch)


def assert_bf16_grads_close(got: dict, want: dict, f32: dict, kappa: dict):
    """Per tensor: within GRAD_TOL of etts' bf16 gradient (``want``;
    ``f32`` etts' float32 one). A gradient that
    is zero in exact arithmetic (a key bias under the softmax, a conv bias
    before a BatchNorm on the batch's statistics: etts' float32 gradient,
    float32 rounding noise, below a tenth of its bf16 one) is bf16
    rounding noise on both sides, and is held to the size of etts' noise
    instead.

    A bias whose gradient is a near-cancelling sum is held to etts' noise
    too. The criterion is float64's (``cancellation``, ``kappa``): the
    terms of its sum over the output's positions are kappa times larger
    in magnitude than the sum, so bf16's relative rounding of the terms
    (BF16_U) reaches it as up to BF16_U * kappa; where that exceeds
    GRAD_TOL (kappa above 12.8: a bias whose shift a BatchNorm on the
    batch's statistics nearly removes, as the forward model's ``out``
    and the conv block's ``norm_out`` before its postnet), the port's
    gradient is held within sqrt(2) times etts' own bf16 error (its
    distance to the float32 gradient) of etts': the distance of two bf16
    sums whose roundings were independent and each of etts' size.

    The half-distance control is taken over all the gradients together:
    per tensor, the two backward passes order their bf16 roundings
    differently (JAX rounds each float32 cotangent a cast gives back and
    adds them in bf16), which puts some tensors, alone, up to 0.7 of etts'
    own bf16-vs-float32 distance from etts'."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert got[name].dtype == torch.float32, name
        noise = np.linalg.norm(w - f32[name])
        if np.linalg.norm(f32[name]) < 0.1 * np.linalg.norm(w):
            assert np.linalg.norm(g) <= 4 * noise, (name, np.linalg.norm(g))
        elif BF16_U * kappa.get(name, 0.0) > GRAD_TOL:
            assert np.linalg.norm(g - w) <= np.sqrt(2) * noise, (
                name, kappa[name], np.linalg.norm(g - w), noise)
        else:
            assert rel(g, w) <= GRAD_TOL, (name, rel(g, w))
    flat = lambda d: np.concatenate([np.ravel(d[k]) for k in sorted(want)])
    d = rel(flat({k: v.numpy() for k, v in got.items()}), flat(want))
    control = rel(flat(want), flat(f32))
    assert d < 0.5 * control, (d, control)


def test_ar_step_gradients(ar):
    jm, jb, v, tm, batch = ar

    def etts_grads(model, compiler_options):
        step = etts_ar_step(model, capture_tx(), stop_scaling=8.0)
        args = (JState.create(v, capture_tx()), to_jax(batch),
                jnp.asarray(0.0), jax.random.PRNGKey(0))
        kw = dict(prenet_dropout=0.0, ss_rate=0.0)
        with float32_sums():
            run = step.lower(*args, r=R, **kw).compile(
                compiler_options=compiler_options)
        return torch_grads(run(*args, **kw)[0].opt_state)
    def step(model, batch):
        cs = capture_state(model)
        make_autoregressive_train_step(model, stop_scaling=8.0)(
            cs, batch, 0.0, 0, r=R, prenet_dropout=0.0)
        return cs.grads
    kappa = cancellation(tm, lambda m: step(m, f64(to_torch(batch))))
    assert_bf16_grads_close(step(tm, to_torch(batch)),
                            etts_grads(jb, STRICT), etts_grads(jm, None),
                            kappa)


def test_forward_step_gradients(fwd):
    jf, jb, v, tf, batch = fwd

    def etts_grads(model, compiler_options):
        step = etts_fwd_step(model, capture_tx(), max_frames=48)
        args = (JState.create(v, capture_tx()), to_jax(batch),
                jax.random.PRNGKey(0))
        with float32_sums():
            run = step.lower(*args).compile(
                compiler_options=compiler_options)
        return torch_grads(run(*args)[0].opt_state)
    def step(model, batch):
        cs = capture_state(model)
        make_forward_train_step(model, 48)(cs, batch, 0)
        return cs.grads
    kappa = cancellation(tf, lambda m: step(m, f64(to_torch(batch))))
    assert_bf16_grads_close(step(tf, to_torch(batch)),
                            etts_grads(jb, STRICT), etts_grads(jf, None),
                            kappa)


# ---------------------------------------------------------------------------
# the overfit
# ---------------------------------------------------------------------------

def test_autoregressive_overfits_in_bfloat16():
    """`tests/test_overfit.py:72`'s recipe on the port: a text-only model
    (widths 32, one block a stack), r = 2, Adam at 3e-3, 400 steps on one
    batch; the mel MAE must fall below 0.35 of its start, and the
    parameters, their gradients and Adam's moments stay float32."""
    tiny = dict(encoder_model_dimension=32, decoder_model_dimension=32,
                encoder_num_heads=(2,), decoder_num_heads=(2,),
                encoder_dense_blocks=1, decoder_dense_blocks=1,
                encoder_feed_forward_dimension=64,
                decoder_feed_forward_dimension=64,
                encoder_attention_conv_filters=32,
                decoder_attention_conv_filters=32, postnet_conv_filters=32,
                postnet_conv_layers=2, postnet_kernel_size=3, mel_channels=8,
                vocab_size=30, encoder_maximum_position_encoding=50,
                decoder_maximum_position_encoding=200,
                encoder_prenet_dimension=32, decoder_prenet_dimension=32)
    model = AutoregressiveTransformer(system_type="text", max_r=2,
                                      dtype=torch.bfloat16, **tiny)
    init_flax(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t_mel = 13
    mel = (rng.normal(size=(2, t_mel, 8)) * 0.3).astype(np.float32)
    mel[:, 0], mel[:, -1] = 0.5, -0.5
    phon = rng.integers(1, 30, (2, 6))
    stop = np.ones((2, t_mel), np.int64)
    stop[:, -1] = 2
    batch = (torch.from_numpy(mel), torch.from_numpy(phon),
             torch.from_numpy(stop), torch.zeros(2, 1))
    state = TrainState(model, [[0, 3e-3]])
    step = make_autoregressive_train_step(model)
    losses = []
    for i in range(400):
        metrics, _ = step(state, batch, 0.0, i, r=2, prenet_dropout=0.0)
        losses.append(float(metrics["losses"]["output"]))
    assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in model.parameters())
    moments = [t for s in state.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)


# ---------------------------------------------------------------------------
# the synthesizers on a bf16 config
# ---------------------------------------------------------------------------

def test_synthesizer_paths_in_bf16(tmp_path):
    """TTSSynthesizer on configs/default shrunk by TTS_SMALL with
    ``precision: bfloat16``, seeded weights: ``predict`` takes the fused
    decode's path (its weights gathered from the bf16 encoder's output; the
    plain version on the CPU), ``predict_many`` of two texts the plain bf16
    decode, and the stream's mel is ``autoregressive_predict``'s in bf16,
    bit for bit; a tiny vocoder streams it. The forward model's ``predict`` runs in bf16 too."""
    from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
    from etts_torch.convert import seeded_flat
    from etts_torch.utils.config import build_vocoder
    from torch_parity import FWD_SMALL, TTS_SMALL, VOC_SMALL
    for kind, over in (("autoregressive", dict(TTS_SMALL,
                                               precision="bfloat16")),
                       ("forward", dict(FWD_SMALL, precision="bf16")),
                       ("wavernn", VOC_SMALL),
                       ("data", {"phonemizer_backend": "grapheme"})):
        cfg = yaml.safe_load((ROOT / "configs/default" /
                              f"{kind}_config.yaml").read_text())
        cfg.update(over)
        (tmp_path / f"{kind}_config.yaml").write_text(yaml.safe_dump(cfg))
    weights = {}
    for kind, build in (("autoregressive", build_tts),
                        ("forward", build_forward)):
        model = build(load_config(tmp_path, kind),
                      default_tokenizer(kind == "autoregressive").vocab_size)
        weights[kind] = seeded_flat(model, 0, std_1d=0.1)
    voc = VocoderSynthesizer(tmp_path, seeded_flat(build_vocoder(
        load_config(tmp_path, "wavernn")), 0), "cpu")
    tts = TTSSynthesizer(tmp_path, weights["autoregressive"], "cpu",
                         phonemizer_backend="grapheme")
    assert tts.model.dtype == torch.bfloat16
    assert tts.mel_dtype == torch.float32          # the fused decode's
    rng = np.random.default_rng(0)
    ref = rng.uniform(-4, 0, (30, 80)).astype(np.float32)
    spk = rng.normal(size=256).astype(np.float32)
    text, kw = "Hello there.", dict(max_length=40, seed=0)
    mel = tts.predict(text, ref, spk, **kw)["mel"]
    many = tts.predict_many([text, "A longer second sentence."], ref, spk,
                            **kw)
    streamed = np.concatenate(list(tts.stream_mels(text, ref, spk,
                                                   mel_chunk=2, **kw)))
    out = autoregressive_predict(
        tts.model, *tts._stream_inputs(text, ref, spk), r=tts.r,
        max_length=40, prenet_dropout=tts.prenet_dropout,
        generator=torch.Generator().manual_seed(0))
    plain = out["mel"][0, :out["mel_length"]]
    assert plain.dtype == torch.bfloat16
    assert mel.dtype == np.float32 and np.isfinite(mel).all()
    assert all(np.isfinite(m).all() for m in many)
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    for m in (*many, streamed):
        np.testing.assert_array_equal(m, bf16(m))    # bf16 values
    np.testing.assert_array_equal(streamed, plain.float().numpy())
    wav = np.concatenate(list(tts.stream(text, voc, ref, spk, mel_chunk=2,
                                         **kw)))
    assert np.isfinite(wav).all() and wav.size == streamed.shape[0] * \
        voc.model.hop_length
    fwd = TTSSynthesizer(tmp_path, weights["forward"], "cpu",
                         phonemizer_backend="grapheme",
                         model_kind="forward")
    assert fwd.model.dtype == fwd.mel_dtype == torch.bfloat16
    fmel = fwd.predict(text)["mel"]
    assert np.isfinite(fmel).all()
    np.testing.assert_array_equal(fmel, bf16(fmel))
