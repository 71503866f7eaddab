"""The forward (duration) model of the port against etts on the CPU,
float32, at a tiny size: ``regulate_lengths`` (exact), ``DurationPredictor``,
``ForwardTransformer`` with predicted and with target durations, the
decoder prenet's dropout drawn from a generator, the forward
``TTSSynthesizer.predict`` from a config dir and a flat npz export, its
refusal of style and speaker conditioning, the forward ``stream`` (its
samples bit for bit one sample-loop run over the chunks' conditioning),
``--model_kind forward`` in the CLI, and ``build_forward`` /
``build_tts`` on every configuration of ``configs/default``.

Tolerances: 0 for ``regulate_lengths`` and the lengths; 1e-5 for one
module on its own and for durations (float32 reduction order); 1e-4 for a
whole mel, as ``test_torch_autoregressive.py``."""
import functools
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models import layers as jl
from etts.models.forward import ForwardTransformer as JF
from etts.ops.expand import regulate_lengths as jregulate
from etts_torch import streaming
from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
from etts_torch.convert import export_flat
from etts_torch.models import layers as tl
from etts_torch.models.forward import ForwardTransformer as TF
from etts_torch.ops.expand import regulate_lengths
from etts_torch.ops.kernels.wavernn_cell import wavernn_sample_loop
from etts_torch.ops.normalizers import mu_law_decode
from etts_torch.synthesize import main as synthesize
from etts_torch.utils.config import (build_forward, build_tts, load_config,
                                     schedule_values)
from torch_parity import (ROOT, seeded_variables, small_workspace, t,
                          unflatten)

MODULE_ATOL = 1e-5
ATOL = 1e-4
TINY = dict(encoder_model_dimension=32, decoder_model_dimension=32,
            encoder_num_heads=(2, 2), decoder_num_heads=(2, 2, 2),
            encoder_dense_blocks=1, decoder_dense_blocks=2,
            encoder_feed_forward_dimension=48,
            decoder_feed_forward_dimension=40, postnet_conv_filters=16,
            postnet_conv_layers=3, postnet_kernel_size=3, mel_channels=12,
            vocab_size=40, encoder_attention_conv_filters=24,
            decoder_attention_conv_filters=20,
            encoder_maximum_position_encoding=100,
            decoder_maximum_position_encoding=200)
TEXT = "Hello world, this is 42 tests."
STREAM_TEXT = "Hello there."


def test_regulate_lengths():
    """Zero durations, exact halves (round half to even: 0.5 -> 0,
    1.5 -> 2, 2.5 -> 2), a negative one, and a second row whose total
    (22) passes the capacity (16): frames and totals equal, the frames
    past the first row's total (8) zero."""
    x = np.random.default_rng(0).standard_normal((2, 6, 5)).astype(
        np.float32)
    dur = np.asarray([[0.5, 1.5, 2.5, 0.0, 3.49, 1.0],
                      [4.0, 0.0, 6.6, 2.5, -1.0, 9.0]], np.float32)
    want, want_total = jregulate(jnp.asarray(x), jnp.asarray(dur), 16)
    got, total = regulate_lengths(t(x), t(dur), 16)
    assert total.tolist() == np.asarray(want_total).tolist() == [8, 22]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0, 8:].any() and got[1].all(-1).all()


def test_duration_predictor():
    jmod = jl.DurationPredictor(model_dim=16)
    tmod = tl.DurationPredictor(16)
    x = np.random.default_rng(1).standard_normal((2, 7, 16)).astype(
        np.float32)
    v = seeded_variables(tmod, 1)
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(t(x))
    assert got.shape == (2, 7, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


@pytest.fixture(scope="module")
def forward_pair():
    """(flax ForwardTransformer, variables, port model) of TINY: a 1 dense
    + 1 conv encoder, a 2 dense + 1 conv decoder, seeded weights
    (``seeded_variables``), the duration head's bias 1 frame."""
    tm = TF(**TINY)
    with torch.no_grad():
        seeded_variables(tm, 2)
        tm.dur_pred.linear.bias.fill_(1.0)
    v = unflatten(export_flat(tm))
    return JF(**TINY), v, tm.eval()


def _ids():
    ids = np.random.default_rng(3).integers(1, 40, (2, 9)).astype(np.int32)
    ids[1, 5:] = 0                              # padded second row
    return ids


@pytest.mark.parametrize("targets", [False, True],
                         ids=["predicted", "target"])
def test_forward_transformer(forward_pair, targets):
    """durations_scalar 1.7; with target durations the second row's total
    passes the capacity of 40 frames. Every output of the dict."""
    jm, v, tm = forward_pair
    ids = _ids()
    tgt = None
    if targets:
        tgt = np.asarray([[2, 0, 1.5, 3, 2.5, 1, 4, 0.5, 2],
                          [9, 9, 9, 9, 9, 0, 0, 0, 0]],
                         np.float32)[..., None]
    kw = dict(max_frames=40, durations_scalar=1.7)
    want = jax.jit(lambda v, ids, tgt: jm.apply(
        v, ids, tgt, **kw, rngs={"prenet": jax.random.PRNGKey(0)}))(
        v, jnp.asarray(ids), None if tgt is None else jnp.asarray(tgt))
    with torch.no_grad():
        got = tm(t(ids).long(), None if tgt is None else t(tgt), **kw)
    assert sorted(got) == sorted(want)
    lengths = np.asarray(want["mel_lengths"])
    assert got["mel_lengths"].tolist() == lengths.tolist()
    if targets:
        assert lengths.tolist() == [16, 45]
    else:
        assert 0 < lengths.min() and lengths.max() <= 40
    np.testing.assert_allclose(got["duration"].numpy(),
                               np.asarray(want["duration"]),
                               atol=MODULE_ATOL)
    assert not got["duration"][1, 5:].any()
    np.testing.assert_array_equal(got["expanded_mask"].numpy(),
                                  np.asarray(want["expanded_mask"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=ATOL)
    for key in ("encoder_attention", "decoder_attention"):
        assert sorted(got[key]) == sorted(want[key])
        for name in want[key]:
            np.testing.assert_allclose(got[key][name].numpy(),
                                       np.asarray(want[key][name]),
                                       atol=ATOL)
    assert list(got["decoder_attention"]) == [
        "Decoder_DenseBlock1_SelfAttention",
        "Decoder_DenseBlock2_SelfAttention",
        "Decoder_ConvBlock1_SelfAttention"]


def test_forward_prenet_dropout_uses_generator(forward_pair):
    """The decoder prenet's dropout at a given rate draws from the given
    generator: one seed repeats, rate 0 draws nothing and differs."""
    _, _, tm = forward_pair
    ids = t(_ids()).long()
    with torch.no_grad():
        run = lambda rate, seed=0: tm(
            ids, max_frames=40, prenet_dropout=rate,
            generator=torch.Generator().manual_seed(seed))["mel"]
        assert torch.equal(run(0.5), run(0.5))
        assert not torch.allclose(run(0.5), run(0.0))
        assert torch.equal(run(0.0, 1), run(0.0, 2))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return small_workspace(tmp_path_factory.mktemp("cfg"),
                           ("forward", "wavernn"))


@pytest.fixture(scope="module")
def tts(workspace):
    return TTSSynthesizer(workspace["dir"], workspace["dir"] / "forward.npz",
                          "cpu", model_kind="forward")


@functools.cache
def _forward_apply(model):
    """etts' forward pass at the config's capacity, jitted once for every
    durations_scalar."""
    return jax.jit(lambda v, ids, scalar: model.apply(
        v, ids, None, max_frames=96, durations_scalar=scalar,
        rngs={"prenet": jax.random.PRNGKey(0)}))


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_predict_forward(workspace, tts, speed):
    """The config's capacity (96 frames), durations divided by the speed
    regulator, the mel cut to its length; the ids without start and end
    tokens, as etts' forward pipeline."""
    cm, model, variables = workspace["forward"]
    ids = np.asarray(cm.get_text_pipeline()(TEXT), np.int32)
    np.testing.assert_array_equal(tts.encode_text(TEXT), ids)
    out = _forward_apply(model)(variables, jnp.asarray(ids)[None],
                                jnp.float32(1.0 / speed))
    n = int(out["mel_lengths"][0])
    want = np.asarray(out["mel"][0][:n])
    got = tts.predict(TEXT, speed_regulator=speed)
    assert list(got) == ["mel"] and 0 < n <= 96
    assert got["mel"].shape == want.shape
    np.testing.assert_allclose(got["mel"], want, atol=ATOL)


def test_forward_refuses_conditioning(workspace, tts):
    voc = VocoderSynthesizer(workspace["dir"],
                             workspace["dir"] / "wavernn.npz", "cpu")
    for kw in ({"ref_mel": np.zeros((20, 80), np.float32)},
               {"spk_embed": np.zeros(256, np.float32)}):
        with pytest.raises(ValueError, match="no ref_mel/spk_embed"):
            tts.predict(TEXT, **kw)
        with pytest.raises(ValueError, match="no ref_mel/spk_embed"):
            next(tts.stream(TEXT, voc, **kw))
    for call in (lambda: tts.predict_many([TEXT]),
                 lambda: next(tts.stream_mels(TEXT))):
        with pytest.raises(ValueError, match="autoregressive model only"):
            call()


def test_forward_stream(workspace, tts):
    """predict's mel of a short text (14 frames) through the vocoder in
    chunks of 5 frames, the last one partial: one sample-loop call a
    chunk, and the samples bit for bit those of one sample-loop run,
    seeded with seed + 1, over the chunks' conditioning."""
    voc = VocoderSynthesizer(workspace["dir"],
                             workspace["dir"] / "wavernn.npz", "cpu")
    vm = voc.model
    mel = tts.predict(STREAM_TEXT)["mel"]
    calls = []
    real = streaming.wavernn_sample_loop

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)
    streaming.wavernn_sample_loop = spy
    try:
        chunks = list(tts.stream(STREAM_TEXT, voc, mel_chunk=5, seed=3))
    finally:
        streaming.wavernn_sample_loop = real
    hop = vm.hop_length
    n = mel.shape[0]
    assert n % 5 and [c.shape[0] for c in chunks] == calls == [
        min(5, n - i) * hop for i in range(0, n, 5)]
    vmel = (mel + 4.0) / 8.0
    conds = [streaming._chunk_cond(vm, ctx)[:k * hop] for ctx, k in
             streaming._chunk_contexts([vmel], 5, vm.pad, vm.feat_dims,
                                       "cpu")]
    one, _ = wavernn_sample_loop(torch.cat(conds), voc.weights, mode=vm.mode,
                                 n_classes=vm.n_classes, seed=4)
    one = one[:, 0]
    if voc.config.get("mu_law", True) and vm.mode == "RAW":
        one = mu_law_decode(one, vm.n_classes, from_labels=False)
    assert np.array_equal(np.concatenate(chunks), one.numpy())


def test_cli_model_kind_forward(workspace, tmp_path):
    """--model_kind forward with the vocoder; --ref_wav or --spk_embed with
    a forward model is a usage error."""
    d = workspace["dir"]
    args = ["--model_kind", "forward", "--tts_config", str(d),
            "--tts_weights", str(d / "forward.npz"), "--voc_config", str(d),
            "--voc_weights", str(d / "wavernn.npz"), "--sentences", TEXT,
            "--device", "cpu", "--out_dir", str(tmp_path / "out")]
    synthesize(args)
    mel = np.load(tmp_path / "out" / "0_mel.npy")
    with wave.open(str(tmp_path / "out" / "0.wav"), "rb") as f:
        assert f.getnframes() == (mel.shape[0] - 1) * 200
    for extra in (["--ref_wav", "ref.wav"], ["--spk_embed", "spk.npy"]):
        with pytest.raises(SystemExit) as e:
            synthesize(args + extra)
        assert e.value.code == 2


def test_build_every_default_config():
    """forward_config.yaml, and the AR config with conv blocks in both
    stacks and prosody statistics, build at full width with no
    refusal."""
    cfg = load_config(ROOT / "configs/default", "forward")
    fwd = build_forward(cfg, 60)
    assert schedule_values(cfg, 0) == {"reduction_factor": 1,
                                       "decoder_prenet_dropout": 0.0}
    assert fwd.decoder_postnet.last_conv.out_channels == cfg["mel_channels"]
    cfg = load_config(ROOT / "configs/default", "autoregressive")
    cfg.update(encoder_dense_blocks=2, decoder_dense_blocks=2,
               use_prosody_stats=True)
    ar = build_tts(cfg, 60)
    assert [type(b).__name__ for b in ar.Decoder.blocks()] == [
        "CrossAttentionDenseBlock"] * 2 + ["CrossAttentionConvBlock"] * 2
    assert hasattr(ar, "ProsodyStats") == ar.has_style
