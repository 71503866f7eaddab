"""Plain version of the fused decode kernel (etts_torch.ops.kernels.
decoder_step) against etts' Pallas kernel in interpret mode with float32
compute, as tests/test_pallas_decoder.py runs it, and against the port's own
autoregressive_predict. Weights are bf16-rounded on both sides; tolerance
5e-3 over up to 16 fed-back steps (float32 reduction order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.autoregressive import AutoregressiveTransformer as JM
from etts.ops.pallas.decoder_step import fused_decode as jfused
from etts_torch.convert import load_into
from etts_torch.models.autoregressive import autoregressive_predict
from etts_torch.ops.kernels import _build
from etts_torch.ops.kernels.decoder_step import (CLUSTER, PHASES, TIMER,
                                                 can_fuse, decode_weights,
                                                 fused_decode,
                                                 fused_decode_plain,
                                                 launch_cluster, phase_split)
from torch_parity import ar_pair, flatten, t

ATOL = 5e-3
IDS = np.asarray([[3, 17, 5, 22, 9, 31, 12]], np.int32)


def _bf16_pair(batch_stats=True, stop_bias=None):
    jm, v, tm = ar_pair("text", batch_stats=batch_stats)
    v = jax.tree.map(lambda x: (x.astype(jnp.bfloat16).astype(jnp.float32)
                                if x.ndim >= 2 else x), v)
    if stop_bias is not None:
        sl = v["params"]["Postnet"]["stop_linear"]
        sl["kernel"] = jnp.zeros_like(sl["kernel"])
        sl["bias"] = jnp.asarray(stop_bias, jnp.float32)
    load_into(tm, flatten(v))
    return jm, v, tm


def _jax(jm, v, ids, **kw):
    key = jax.random.PRNGKey(1)
    enc, *_ = jm.apply(v, jnp.asarray(ids), None, None, method=JM.encode)
    mel, length, _ = jfused(jm, v, enc, key=key, prenet_dropout=0.0,
                            interpret=True, compute_dtype="float32", **kw)
    return np.asarray(mel[0]), int(length)


def _weights(tm, ids, r, dtype=torch.float32):
    with torch.no_grad():
        enc = tm.encode(t(ids).long())[0]
    return decode_weights(tm, enc, r, dtype)


@pytest.mark.parametrize("r,steps", [(1, 16), (2, 8)])
def test_plain_matches_etts_kernel(r, steps):
    jm, v, tm = _bf16_pair()
    want, want_len = _jax(jm, v, IDS, max_steps=steps, r=r,
                          stop_enabled=False)
    got, length, n = fused_decode_plain(_weights(tm, IDS, r),
                                        max_steps=steps, prenet_dropout=0.0,
                                        stop_enabled=False)
    np.testing.assert_allclose(got.numpy(), want[:steps * r], atol=ATOL)
    assert length == want_len == steps * r and n == steps


@pytest.mark.parametrize("r", [1, 2])
def test_plain_matches_autoregressive_predict(r):
    """With init BatchNorm stats and zero conv biases the incremental
    postnet and autoregressive_predict's sliding window agree exactly in
    arithmetic (with trained biases the window's zero frames before the
    sequence start differ, see ROADMAP Queue C)."""
    _, _, tm = _bf16_pair(batch_stats=False)
    steps = 10
    want = autoregressive_predict(tm, t(IDS).long(), r=r,
                                  max_length=steps * r - 1,
                                  prenet_dropout=0.0, stop_enabled=False)
    got, length, _ = fused_decode_plain(_weights(tm, IDS, r),
                                        max_steps=steps, prenet_dropout=0.0,
                                        stop_enabled=False)
    np.testing.assert_allclose(got.numpy(), want["mel"][0].numpy(),
                               atol=1e-4)
    assert length == want["mel_length"]


def test_stop_token():
    jm, v, tm = _bf16_pair(stop_bias=[0.0, 0.0, 10.0])
    _, want_len = _jax(jm, v, IDS, max_steps=16)
    mel, length, n = fused_decode_plain(_weights(tm, IDS, 1), max_steps=16,
                                        prenet_dropout=0.0)
    assert length == want_len == 1 and n == 1
    assert torch.all(mel[1:] == 0)


def test_stop_interior_frame_r2():
    jm, v, tm = _bf16_pair(stop_bias=[0.0, 0.0, 10.0])
    _, want_len = _jax(jm, v, IDS, max_steps=8, r=2)
    _, length, n = fused_decode_plain(_weights(tm, IDS, 2), max_steps=8,
                                      prenet_dropout=0.0)
    assert length == want_len == 1 and n == 1


def test_frame_cap():
    jm, v, tm = _bf16_pair(stop_bias=[10.0, 0.0, -10.0])
    _, want_len = _jax(jm, v, IDS, max_steps=16, max_frames_per_token=1.0)
    _, length, _ = fused_decode_plain(_weights(tm, IDS, 1), max_steps=16,
                                      prenet_dropout=0.0,
                                      max_frames_per_token=1.0)
    assert length == want_len == 7


def test_attn_stop_patience():
    jm, v, tm = _bf16_pair(stop_bias=[10.0, 0.0, -10.0])
    ids = IDS[:, :2]
    _, want_len = _jax(jm, v, ids, max_steps=16, attn_stop_patience=3)
    _, length, n = fused_decode_plain(_weights(tm, ids, 1), max_steps=16,
                                      prenet_dropout=0.0,
                                      attn_stop_patience=3)
    assert length == want_len == 3 and n == 3


def test_dropout_noise():
    """Shared uniforms make the dropout exact: all-kept equals rate 0 (up
    to the 1/keep rescale), all-dropped zeroes the prenet."""
    _, _, tm = _bf16_pair()
    w = _weights(tm, IDS, 1)
    P, d = w.pw1.shape[0], w.d
    base, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.0,
                                  stop_enabled=False)
    noise = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(6, P + d)).astype(np.float32))
    a, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.5,
                               noise=noise, stop_enabled=False)
    b, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.5,
                               noise=noise, stop_enabled=False)
    assert torch.equal(a, b) and not torch.allclose(a, base)
    dropped, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.5,
                                     noise=torch.full((6, P + d), 0.9),
                                     stop_enabled=False)
    assert torch.isfinite(dropped).all()


def test_teacher_own_output_is_identity():
    _, _, tm = _bf16_pair()
    w = _weights(tm, IDS, 2)
    free, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.0,
                                  stop_enabled=False)
    forced, *_ = fused_decode_plain(w, max_steps=6, prenet_dropout=0.0,
                                    stop_enabled=False, teacher=free)
    assert torch.equal(free, forced)


def test_bf16_storage_stays_close():
    """bf16 weights and KV caches (the kernel's storage) against float32
    storage of the same bf16-rounded weights: early frames agree to bf16
    noise, as in tests/test_pallas_decoder.py."""
    _, _, tm = _bf16_pair()
    f32, *_ = fused_decode_plain(_weights(tm, IDS, 1), max_steps=12,
                                 prenet_dropout=0.0, stop_enabled=False)
    b16, *_ = fused_decode_plain(_weights(tm, IDS, 1, torch.bfloat16),
                                 max_steps=12, prenet_dropout=0.0,
                                 stop_enabled=False)
    assert torch.isfinite(b16).all()
    assert float((f32[:4] - b16[:4]).abs().max()) < 0.08


def test_wrapper_runs_plain_on_cpu_without_counting():
    _, _, tm = _bf16_pair()
    w = _weights(tm, IDS, 1)
    before = fused_decode.launches
    got, length, _ = fused_decode(w, max_steps=5, prenet_dropout=0.0,
                                  stop_enabled=False)
    want, *_ = fused_decode_plain(w, max_steps=5, prenet_dropout=0.0,
                                  stop_enabled=False)
    assert torch.equal(got, want) and length == 5
    assert fused_decode.launches == before


def test_geometry_checks():
    _, _, tm = _bf16_pair()
    assert can_fuse(tm)
    with torch.no_grad():
        enc = tm.encode(t(np.repeat(IDS, 2, 0)).long())[0]
    with pytest.raises(ValueError, match="batch 1"):
        decode_weights(tm, enc, 1)
    _, _, mixed = ar_pair("text", decoder_num_heads=(2, 4))
    assert not can_fuse(mixed)


@pytest.mark.parametrize("over", [
    dict(mel_channels=10),                  # rows read as float4
    dict(decoder_prenet_dimension=26),
    dict(postnet_conv_filters=18),
    dict(decoder_num_heads=(8, 8)),         # head depth 4: 16-byte key loads
])
def test_geometry_checks_cluster_kernel(over):
    """The cluster kernel's own geometry: widths it reads as float4 and
    splits over the blocks in groups of 4 rows, and key slices of 8 bf16.
    The plain decode still runs such a model, as the API falls back to it
    on geometry alone."""
    _, _, tm = ar_pair("text", **over)
    assert not can_fuse(tm)
    with torch.no_grad():
        enc = tm.encode(t(IDS).long())[0]
    with pytest.raises(ValueError, match="multiples of 4"):
        decode_weights(tm, enc, 1)


def test_kernel_variants_refuse_cpu_weights():
    """The kernel's variant and timer launches run on the card only: no
    plain version stands in for a measurement."""
    _, _, tm = _bf16_pair()
    w = _weights(tm, IDS, 1)
    with pytest.raises(ValueError, match="CUDA"):
        launch_cluster(w, 8, max_steps=2)
    with pytest.raises(ValueError, match="CUDA"):
        phase_split(w, max_steps=2)
    assert len(PHASES) == 10


@pytest.mark.parametrize("measure", ["cluster", "timer"])
def test_kernel_variants_take_fused_decode_options(measure):
    """The variant and timer launches take ``fused_decode``'s own options:
    a name it does not have is refused before anything is built."""
    _, _, tm = _bf16_pair()
    w = _weights(tm, IDS, 1)
    run = (lambda **kw: launch_cluster(w, 8, **kw)) if measure == "cluster" \
        else (lambda **kw: phase_split(w, **kw))
    with pytest.raises(TypeError):
        run(max_step=2)
    with pytest.raises(TypeError):
        run(prenet_dropout=0.0)         # max_steps has no default


def test_build_variants_are_separate_libraries():
    """Each set of -D defines builds its own library (and log) beside the
    plain build, so the timer and cluster-size variants never overwrite
    the kernel the main path loads."""
    plain = _build._target("decoder_step")
    timer = _build._target("decoder_step", (TIMER,))
    other = _build._target("decoder_step", (f"{CLUSTER}=8",))
    assert len({plain, timer, other}) == 3
    assert plain.parent == timer.parent == other.parent
    assert TIMER in timer.name and "DECODE_CLUSTER_8" in other.name
    assert _build._tag(()) == ""
