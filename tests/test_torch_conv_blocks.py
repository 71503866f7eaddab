"""The conv attention blocks and the prosody statistics of the port against
etts on the CPU, float32, at a tiny size: ``CNNResNorm`` in every padding,
norm and activation etts uses, the postnet's stack unchanged bit for bit,
``SelfAttentionConvBlock`` and ``CrossAttentionConvBlock``, text encoders
and decoders of 2 dense and 2 conv blocks (``decode_step`` with the conv
blocks' rolling input windows), ``autoregressive_predict`` on such a
decoder, the chunked decode against the one-shot decode (bit for bit),
``ProsodyStatEncoder`` and ``encode`` with ``use_prosody_stats``.

Tolerances: 1e-5 for one module on its own (float32 reduction order);
1e-4 for a whole encode or decode, as ``test_torch_autoregressive.py``;
0 for the port's chunked decode against its one-shot decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from etts.models import layers as jl
from etts.models.autoregressive import (AutoregressiveTransformer as JM,
                                        _cross_attention_kv,
                                        _decoder_cache_spec,
                                        autoregressive_predict as jpredict)
from etts.ops.masking import look_ahead_mask
from etts_torch.convert import load_into
from etts_torch.models import layers as tl
from etts_torch.models.autoregressive import (autoregressive_predict,
                                              make_chunk_decoder,
                                              streaming_decode_init)
from etts_torch.ops.kernels.decoder_step import can_fuse
from etts_torch.models.autoregressive import AutoregressiveTransformer as TM
from torch_parity import AR_TINY, SPK_DIM, flatten, seeded_variables, t

MODULE_ATOL = 1e-5
ATOL = 1e-4
# 2 dense then 2 conv blocks in the text encoder and in the decoder
MIXED = dict(encoder_num_heads=(2, 2, 2, 2), decoder_num_heads=(2, 2, 2, 2),
             encoder_dense_blocks=2, decoder_dense_blocks=2,
             encoder_attention_conv_filters=24,
             decoder_attention_conv_filters=20)


def _module_pair(tmod, seed=0):
    """Seed ``tmod`` (``seeded_variables``) and return its weights as the
    flax variables of the same module; ``tmod`` in eval mode."""
    v = seeded_variables(tmod, seed)
    tmod.eval()
    return v


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# every configuration etts builds: SACB, CACB, the duration predictor, the
# AR postnet, the forward postnet; and flax SAME at an even kernel
CNN_CASES = {
    "sacb": ("relu", "relu", "same", "batch", 3),
    "cacb": ("relu", "relu", "causal", "batch", 3),
    "duration": ("relu", "relu", "same", "layer", 3),
    "ar_postnet": ("tanh", "linear", "causal", "batch", 5),
    "forward_postnet": ("tanh", "linear", "same", "batch", 5),
    "same_even_kernel": ("relu", "tanh", "SAME", "layer", 4),
}


@pytest.mark.parametrize("case", list(CNN_CASES))
def test_cnn_resnorm(case):
    inner, last, padding, norm, k = CNN_CASES[case]
    jmod = jl.CNNResNorm(out_size=10, n_layers=3, hidden_size=14,
                         kernel_size=k, inner_activation=inner,
                         last_activation=last, padding=padding,
                         normalization=norm)
    tmod = tl.CNNResNorm(10, 10, 3, 14, k, inner, last, padding=padding,
                         normalization=norm)
    x = _x((2, 11, 10))
    v = _module_pair(tmod)
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL)


def test_postnet_stack_unchanged():
    """The postnet's stack computes exactly what the port's postnet-only
    CNNResNorm computed: causal convs, tanh after each inner BatchNorm, no
    activation after the last, BatchNorm of the residual sum."""
    post = tl.Postnet(12, 16, 4, 5).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in post.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        for name, b in post.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
            elif name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
        x = torch.randn(2, 9, 12, generator=g)
        cb = post.conv_blocks

        def bn(m, y):
            return F.batch_norm(y, m.running_mean, m.running_var, m.weight,
                                m.bias, False, 0.0, m.eps)
        y = x.transpose(1, 2)
        for i in range(3):
            conv = getattr(cb, f"conv_{i}")
            y = torch.tanh(bn(getattr(cb, f"norm_{i}"),
                              conv(F.pad(y, (4, 0)))))
        y = bn(cb.norm_last, cb.last_conv(F.pad(y, (4, 0))))
        want = bn(cb.norm_out, x.transpose(1, 2) + y).transpose(1, 2)
        assert torch.equal(post(x)["final_output"], want)


def test_self_attention_conv_block():
    jmod = jl.SelfAttentionConvBlock(16, 2, 0.1, 20, 3)
    tmod = tl.SelfAttentionConvBlock(16, 2, 20, 3)
    x = _x((2, 7, 16), 1)
    mask = np.zeros((2, 1, 1, 7), np.float32)
    mask[1, ..., 5:] = 1.0
    v = _module_pair(tmod, 1)
    want, want_w, _ = jax.jit(jmod.apply)(v, jnp.asarray(x),
                                          jnp.asarray(mask))
    with torch.no_grad():
        got, w = tmod(t(x), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w),
                               atol=MODULE_ATOL)


def test_cross_attention_conv_block():
    """Teacher-forced, then four incremental steps from zero caches: the
    output and the conv window after each step."""
    jmod = jl.CrossAttentionConvBlock(16, 2, 20, 0.1, 3)
    tmod = tl.CrossAttentionConvBlock(16, 2, 20, 3, 12)
    x, enc = _x((2, 6, 16), 2), _x((2, 5, 12), 3)
    la = np.asarray(look_ahead_mask(6))
    cross = np.zeros((2, 1, 1, 5), np.float32)
    v = _module_pair(tmod, 2)
    want, want_w, _ = jax.jit(jmod.apply)(v, jnp.asarray(x), jnp.asarray(enc),
                                          jnp.asarray(la), jnp.asarray(cross))
    with torch.no_grad():
        got, w = tmod(t(x), t(enc), t(la), t(cross))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w),
                               atol=MODULE_ATOL)
    z = jnp.zeros((2, 2, 6, 8))
    jc = {"k": z, "v": z, "conv": jnp.zeros((2, 4, 16))}
    tc = {"k": torch.zeros(2, 2, 6, 8), "v": torch.zeros(2, 2, 6, 8),
          "conv": torch.zeros(2, 4, 16)}
    tc["ck"] = tc["cv"] = None
    step = jax.jit(lambda v, xi, c, i: jmod.apply(
        v, xi, jnp.asarray(enc), None, jnp.asarray(cross), cache=c,
        cache_index=i))
    for i in range(4):
        xi = x[:, i:i + 1]
        want, _, jc = step(v, jnp.asarray(xi), jc, i)
        with torch.no_grad():
            tc["ck"], tc["cv"] = (tmod.carn.mha.split(f(t(enc))) for f in
                                  (tmod.carn.mha.wk, tmod.carn.mha.wv))
            got, _ = tmod(t(xi), t(enc), None, t(cross), tc, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODULE_ATOL)
        np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                                   atol=MODULE_ATOL)


def _inputs(seed=0):
    """ids (2, 9), the second row padded after 6 tokens; an r-strided
    reference mel (2, 17, 12) whose second row is padded after 12 frames;
    a speaker vector per row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 40, (2, 9)).astype(np.int32)
    ids[1, 6:] = 0
    ref = (rng.standard_normal((2, 17, 12)) * 0.5).astype(np.float32)
    ref[1, 12:] = 0.0
    spk = rng.standard_normal((2, 1, SPK_DIM)).astype(np.float32)
    return ids, ref, spk


def _conv_model(stop=None):
    """speaker_style_text with prosody statistics, 2 dense and 2 conv
    blocks in the text encoder and the decoder; ``stop``: (channel,
    threshold), a stop head whose stop class wins on a frame exactly when
    mel_linear[channel] exceeds the threshold (the other two logits 0)."""
    cfg = dict(AR_TINY, use_prosody_stats=True, prosody_embed_dim=6, **MIXED)
    jm = JM(system_type="speaker_style_text", **cfg)
    tm = TM(system_type="speaker_style_text", speaker_embed_dim=SPK_DIM, **cfg)
    v = _module_pair(tm)
    if stop is not None:
        channel, threshold = stop
        sl = v["params"]["Postnet"]["stop_linear"]
        sl["kernel"] = jnp.zeros_like(sl["kernel"]).at[channel, 2].set(1.0)
        sl["bias"] = jnp.asarray([0.0, 0.0, -threshold], jnp.float32)
        load_into(tm, flatten(v))
    return jm, v, tm


def _encode(jm, v, ids, ref, spk):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=JM.encode))(
        v, jnp.asarray(ids), jnp.asarray(ref), jnp.asarray(spk))


def test_encode_mixed_stack_and_prosody_stats():
    """A text encoder of 2 dense and 2 conv blocks, each block's attention
    under etts' keys; the prosody statistics' embedding after the GST,
    before the speaker, tiled over the text."""
    jm, v, tm = _conv_model()
    ids, ref, spk = _inputs(1)
    want, _, want_attn, *_ = _encode(jm, v, ids, ref, spk)
    with torch.no_grad():
        got, _, attn, *_ = tm.encode(t(ids).long(), t(ref), t(spk))
    assert got.shape[-1] == 32 + 16 + 6 + SPK_DIM
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert sorted(want_attn) == sorted(attn)        # jit sorts dict keys
    assert list(attn) == [
        "TextEncoder_DenseBlock1_SelfAttention",
        "TextEncoder_DenseBlock2_SelfAttention",
        "TextEncoder_ConvBlock1_SelfAttention",
        "TextEncoder_ConvBlock2_SelfAttention"]
    for k in want_attn:
        np.testing.assert_allclose(attn[k].numpy(), np.asarray(want_attn[k]),
                                   atol=ATOL)


@pytest.mark.parametrize("r", [1, 3])
def test_decode_step_conv_caches(r):
    """Six incremental steps of a decoder of 2 dense and 2 conv blocks:
    mel_linear, the last block's cross-attention and each conv block's
    window after each step. The fused kernel refuses such a decoder."""
    jm, v, tm = _conv_model()
    assert not can_fuse(tm)
    ids, ref, spk = _inputs(2)
    enc, mask, *_ = _encode(jm, v, ids, ref, spk)
    caches = _decoder_cache_spec(jm, 2, 6)
    for entry, (ck, cv) in zip(caches, _cross_attention_kv(jm, v, enc)):
        entry["ck"], entry["cv"] = ck, cv
    step = jax.jit(lambda v, f, c, i: jm.apply(
        v, f, enc, mask, c, i, r, 0.0, 0, True, method=JM.decode_step,
        rngs={"prenet": jax.random.PRNGKey(0)}))
    with torch.no_grad():
        tenc, tmask, *_ = tm.encode(t(ids).long(), t(ref), t(spk))
        tcaches = tm.init_caches(tenc, 6)
    assert [sorted(c) for c in tcaches] == [sorted(c) for c in caches]
    frames = np.random.default_rng(3).standard_normal((6, 2, 1, 12)) * 0.3
    for i in range(6):
        f = frames[i].astype(np.float32)
        mel, caches, attn = step(v, jnp.asarray(f), caches, i)
        with torch.no_grad():
            tmel, tattn = tm.decode_step(t(f), tenc, tmask, tcaches, i, r,
                                         prenet_dropout=0.0)
        np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=ATOL)
        np.testing.assert_allclose(tattn.numpy(), np.asarray(attn),
                                   atol=ATOL)
        for tc, jc in zip(tcaches[2:], caches[2:]):
            np.testing.assert_allclose(tc["conv"].numpy(),
                                       np.asarray(jc["conv"]), atol=ATOL)


# (r, frames per token, stop channel, stop threshold): the channel and
# threshold were read off a stop-off run of this model on _inputs(4). The
# second row's mel_linear[channel] first exceeds the threshold at group 7
# (r = 1) or 8 (r = 3); the first row's stays below it for its whole run,
# by at least 0.13 (r = 1) or 0.05 (r = 3) on each side, far above ATOL.
STOP_CASES = [(1, 5.0, 0, 1.5705795), (3, 10.0, 7, 3.3441305)]


@pytest.mark.parametrize("r, per_token, channel, threshold", STOP_CASES,
                         ids=["1-5.0", "3-10.0"])
def test_predict_conv_decoder(r, per_token, channel, threshold):
    """Dropout 0; the stop head fires on the second row only, near step
    10, and the decode runs on with that row's conv windows carried until
    the frame cap ends the first row (9 real tokens) 30 steps or more
    after the start: mel, lengths and steps against etts' while-loop
    decode."""
    jm, v, tm = _conv_model((channel, threshold))
    ids, ref, spk = _inputs(4)
    kw = dict(r=r, max_length=60 * r, prenet_dropout=0.0,
              max_frames_per_token=per_token)
    want = jax.jit(lambda v, *a: jpredict(jm, v, *a, **kw))(
        v, jnp.asarray(ids), jnp.asarray(ref), jnp.asarray(spk))
    got = autoregressive_predict(tm, t(ids).long(), t(ref), t(spk), **kw)
    lengths = got["mel_lengths"].tolist()
    assert lengths == np.asarray(want["mel_lengths"]).tolist()
    assert lengths[0] == int(9 * per_token)         # the frame cap
    assert 6 * r < lengths[1] <= 9 * r              # the stop head
    assert got["steps"] == int(want["steps"]) == lengths[0] // r >= 30
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(got["mel"][row, :n].numpy(),
                                   np.asarray(want["mel"][row, :n]),
                                   atol=ATOL)


@pytest.mark.parametrize("r", [1, 3])
def test_chunked_decode_conv_caches(r):
    """Dropout 0.5 from one seed, stop off: chunks of 4 steps carrying the
    conv windows equal ``autoregressive_predict`` bit for bit."""
    _, _, tm = _conv_model()
    ids, ref, spk = (t(x) for x in _inputs(5))
    ids = ids.long()
    max_length = 13 * r
    want = autoregressive_predict(
        tm, ids, ref, spk, r=r, max_length=max_length, prenet_dropout=0.5,
        stop_enabled=False, generator=torch.Generator().manual_seed(4))
    state = streaming_decode_init(tm, ids, ref, spk, r=r,
                                  max_length=max_length,
                                  generator=torch.Generator().manual_seed(4))
    dec = make_chunk_decoder(tm, chunk=4, r=r, prenet_dropout=0.5,
                             stop_enabled=False)
    chunks = []
    while state["i"] < state["max_steps"]:
        state, out = dec(state)
        chunks.append(out)
    got = torch.cat(chunks, 1)[:, :want["steps"] * r]
    assert want["steps"] == 14 and len(chunks) == 4
    assert torch.equal(got, want["mel"])
    assert torch.equal(state["lengths"], want["mel_lengths"])


@pytest.mark.parametrize("n_mels", [12, 64])
def test_prosody_stat_encoder(n_mels):
    """Frames of zeros at the end of one row (padding, masked out) and a
    quiet frame inside; n_mels below 48 takes every bin, above it the
    lowest 48."""
    jmod = jl.ProsodyStatEncoder(embed_dim=8)
    tmod = tl.ProsodyStatEncoder(8)
    mel = np.clip(_x((2, 23, n_mels), 6) * 1.5, -4, 4)
    mel[1, 15:] = 0.0
    mel[0, 4] = 5e-4
    v = _module_pair(tmod, 6)
    want = jax.jit(jmod.apply)(v, jnp.asarray(mel))
    with torch.no_grad():
        got = tmod(t(mel))
    assert got.shape == (2, 1, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL)
