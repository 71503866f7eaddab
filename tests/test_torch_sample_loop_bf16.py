"""The bf16 sample loop of the port against etts' Pallas kernel in interpret
mode with its default bf16 weights, and the tensor-core packing of the bf16
kernel, on the CPU at tiny sizes (d 32, feat 8, adim 4, T 12).

The TPU kernel's bf16 mode rounds the conditioning stream and every
product's activation to bf16, takes each split of a concatenated input as
a product of its own and keeps W_I's x_prev row in float32; the port's plain
version repeats it. Tolerances: 1e-6 on the forced-pick MOL case, one step
at a time from etts' state, whose samples are mixture means (a continuous
function of every activation) and where both packages sum the same bf16
products in float32, on at least AGREE of the steps; 1e-5 for peaky
RAW samples (argmax picks); 1e-5 for a float32 product of bf16 values of
width <= 512 emulated on the mma fragments."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.ops.pallas.wavernn_cell import wavernn_sample_loop as jloop
from etts_torch.ops.kernels import wavernn_cell as wc
from etts_torch.ops.kernels.wavernn_cell import (Int8SampleLoopWeights,
                                                 SampleLoopWeights, pack_mma,
                                                 unpack_mma,
                                                 wavernn_sample_loop,
                                                 wavernn_sample_loop_plain)
from torch_parity import t

D, FC, FEAT, ADIM, T = 32, 32, 8, 4, 12
PEAKY = 1e6
TOL = 1e-6
# XLA's tanh and PyTorch's differ in the last bit on most inputs; now and
# then such a bit turns an activation's bf16 rounding the other way inside a
# step and moves its sample by up to about 1e-3 (0.998-1 of the steps
# within TOL at B 8 and 11 here)
AGREE = 0.99


def _weights(seed, n_out, scale=0.1):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(W_I=n(1 + FEAT + ADIM, D), b_I=n(D), wi1=n(D, 3 * D),
                wh1=n(D, 3 * D), bi1=n(3 * D), bh1=n(3 * D), w2x=n(D, 3 * D),
                w2a=n(ADIM, 3 * D), wh2=n(D, 3 * D), bi2=n(3 * D),
                bh2=n(3 * D), wf1x=n(D, FC), wf1a=n(ADIM, FC), bf1=n(FC),
                wf2x=n(FC, FC), wf2a=n(ADIM, FC), bf2=n(FC),
                wf3=n(FC, n_out), bf3=np.zeros(n_out, np.float32))


def _port(w, dtype=torch.bfloat16):
    return SampleLoopWeights.from_flax_layout(
        t(w["W_I"]), t(w["b_I"]), t(w["wi1"]), t(w["wh1"]), t(w["bi1"]),
        t(w["bh1"]), t(np.concatenate([w["w2x"], w["w2a"]])), t(w["wh2"]),
        t(w["bi2"]), t(w["bh2"]), t(np.concatenate([w["wf1x"], w["wf1a"]])),
        t(w["bf1"]), t(np.concatenate([w["wf2x"], w["wf2a"]])), t(w["bf2"]),
        t(w["wf3"]), t(w["bf3"]), feat=FEAT, dtype=dtype)


def _jax_loop(cond, w, state=None, return_state=False, **kw):
    """etts' kernel in interpret mode with its default (bf16) weights."""
    j = {k: jnp.asarray(v) for k, v in w.items()}
    return jloop(
        jnp.asarray(cond), j["W_I"], j["b_I"], j["wi1"], j["wh1"], j["bi1"],
        j["bh1"], j["w2x"], j["w2a"], j["wh2"], j["bi2"], j["bh2"],
        j["wf1x"], j["wf1a"], j["bf1"], j["wf2x"], j["wf2a"], j["bf2"],
        j["wf3"], j["bf3"], 3, feat=FEAT, adim=ADIM, chunk=4, interpret=True,
        state=state, return_state=return_state or state is not None, **kw)


def _cond(seed, B, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(
        (T, B, FEAT + 4 * ADIM)) * scale).astype(np.float32)


def _forced_mean_weights(seed):
    """MOL with the mixture pick forced to mixture 0 (its logit 1e4) and a
    vanishing scale (log-scales -100, clamped to log 1e-14): each sample is
    mixture 0's mean, a continuous function of every activation."""
    w = _weights(seed, 30, scale=0.2)
    w["wf3"][:, :10] = 0.0
    w["wf3"][:, 20:] = 0.0
    w["bf3"][0], w["bf3"][20:] = 1e4, -100.0
    return w


@pytest.mark.parametrize("B", [8, 11])
def test_bf16_plain_matches_etts_kernel_rounding(B):
    """One step at a time from etts' state (its kernel's returned state fed
    to both sides), over 8 seeded weight and conditioning draws of 12
    steps: the port's bf16 plain version repeats the TPU kernel's rounding
    within TOL on at least AGREE of the steps, and within 1e-2 on every
    one. Float32 activations on the same bf16 weights (the port's bf16
    plain version before it took the TPU rounding) differ by more than 100x
    TOL on the median step (about 1e-3 here)."""
    got, old = [], []
    for s in range(8):
        w = _forced_mean_weights(1000 * B + s)
        cond = _cond(2000 * B + s, B, scale=1.0)
        pw = _port(w)
        f32act = dataclasses.replace(pw, **{k: getattr(pw, k).float()
                                            for k in wc.MATRICES})
        jst, st = None, None
        for i in range(T):
            want, jst_next = _jax_loop(cond[i:i + 1], w, state=jst,
                                       return_state=True, mode="MOL")
            want = np.asarray(want)
            assert 0.05 < np.abs(want).mean() < 0.95    # means, not the clip
            a, _ = wavernn_sample_loop(t(cond[i:i + 1]), pw, mode="MOL",
                                       state=st, seed=5)
            b, _ = wavernn_sample_loop(t(cond[i:i + 1]), f32act, mode="MOL",
                                       state=st, seed=5)
            assert a.shape == (1, B)
            got.append(np.abs(a.numpy() - want))
            old.append(np.abs(b.numpy() - want))
            jst = jst_next
            st = {"h1": t(np.asarray(jst["h1"])), "h2": t(np.asarray(jst["h2"])),
                  "x": t(np.asarray(jst["x"])[:, 0]), "step": i + 1}
    got, old = np.concatenate(got, None), np.concatenate(old, None)
    assert (got <= TOL).mean() >= AGREE
    assert got.max() <= 1e-2
    assert np.median(old) > 100 * TOL


@pytest.mark.parametrize("B", [8, 11])
def test_bf16_peaky_raw_matches_etts_kernel(B):
    w = _weights(20 + B, 16)
    w["wf3"] = w["wf3"] * PEAKY
    cond = _cond(B + 1, B)
    want = np.asarray(_jax_loop(cond, w, mode="RAW", n_classes=16))
    got, _ = wavernn_sample_loop(t(cond), _port(w), mode="RAW", n_classes=16,
                                 seed=5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bf16_chunked_state_carry():
    """Peaky RAW in two chunks (7 + 5 steps) with carried state equals one
    call, and equals etts' own chunked run in bf16."""
    w = _weights(6, 16)
    w["wf3"] = w["wf3"] * PEAKY
    pw = _port(w)
    cond = _cond(1, 8)
    kw = dict(mode="RAW", n_classes=16)
    full, _ = wavernn_sample_loop(t(cond), pw, **kw)
    a, st = wavernn_sample_loop(t(cond[:7]), pw, **kw)
    b, st2 = wavernn_sample_loop(t(cond[7:]), pw, state=st, **kw)
    assert st2["step"] == T
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(), full.numpy())
    ja, jst = _jax_loop(cond[:7], w, return_state=True, **kw)
    jb, _ = _jax_loop(cond[7:], w, state=jst, **kw)
    np.testing.assert_allclose(full.numpy(), np.concatenate([ja, jb]),
                               atol=1e-5)


# --- the tensor-core packing of the bf16 kernel ---

@pytest.mark.parametrize("shape", [(30, 512), (D, FEAT + ADIM), (48, 16),
                                   (3 * D, ADIM)])
def test_pack_unpack_round_trip(shape):
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(0))
    w = w.to(torch.bfloat16)
    p = pack_mma(w)
    assert p.shape == (-(-shape[0] // 16), -(-shape[1] // 16), 32, 8)
    assert torch.equal(unpack_mma(p, *shape), w)
    # the padding is zero: tile rows and columns past the matrix
    full = unpack_mma(p, p.shape[0] * 16, p.shape[1] * 16)
    pad = full[shape[0]:].abs().sum() + full[:, shape[1]:].abs().sum()
    assert float(pad) == 0


def _mma_emulate(p, act, M):
    """W @ act.T from the packed tiles p, computed as mma.m16n8k16 does on
    the fragments: lane l = 4g + t of A holds a0 (g, 2t..2t+1), a1 (g + 8,
    2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..) of the 16 x 16 tile; of B (k,
    n) b0 (2t..2t+1, g), b1 (2t+8..2t+9, g), read from the activation rows
    as the kernel reads them; of C (m, n) c0 (g, 2t), c1 (g, 2t+1), c2 (g +
    8, 2t), c3 (g + 8, 2t + 1), scattered to unit mt * 16 + g (+ 8) and row
    nt * 8 + 2t (+ 1) as the kernel's epilogues do (``c_pos``)."""
    MT, KT = p.shape[:2]
    N = act.shape[0]
    NT = -(-N // 8)
    act = torch.nn.functional.pad(act.float(),
                                  (0, KT * 16 - act.shape[1], 0, NT * 8 - N))
    lane = torch.arange(32)
    g, t4 = lane // 4, lane % 4
    out = torch.zeros(MT * 16, NT * 8)
    for mt in range(MT):
        for kt in range(KT):
            f = p[mt, kt].float()
            A = torch.zeros(16, 16)
            for j, (r, c) in enumerate([(g, 2 * t4), (g, 2 * t4 + 1),
                                        (g + 8, 2 * t4), (g + 8, 2 * t4 + 1),
                                        (g, 2 * t4 + 8), (g, 2 * t4 + 9),
                                        (g + 8, 2 * t4 + 8),
                                        (g + 8, 2 * t4 + 9)]):
                A[r, c] = f[:, j]
            for nt in range(NT):
                rows = act[nt * 8 + g, kt * 16:(kt + 1) * 16]   # (32, 16)
                Bm = torch.zeros(16, 8)
                for k in (0, 1, 8, 9):
                    Bm[2 * t4 + k, g] = rows[lane, 2 * t4 + k]
                C = A @ Bm
                frag = [C[g, 2 * t4], C[g, 2 * t4 + 1], C[g + 8, 2 * t4],
                        C[g + 8, 2 * t4 + 1]]
                for c in range(4):
                    out[mt * 16 + g + 8 * (c >= 2),
                        nt * 8 + 2 * t4 + (c & 1)] += frag[c]
    return out[:M, :N]


@pytest.mark.parametrize("shape,rows", [((30, 512), 16), ((D, FEAT + ADIM), 5),
                                        ((3 * D, ADIM), 11)])
def test_mma_fragment_product_on_packed_tiles(shape, rows):
    """The fragment product on the packed tiles equals W @ act for shapes
    that are not multiples of 16 (fc3 30 x 512, wic, w2a) and row counts
    that are not multiples of 8."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(*shape, generator=gen).to(torch.bfloat16)
    act = torch.randn(rows, shape[1], generator=gen).to(torch.bfloat16)
    got = _mma_emulate(pack_mma(w), act, shape[0])
    want = w.float() @ act.float().T
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# --- the wrapper ---

def test_bf16_wrapper_on_cpu_counts_nothing_and_packs_once():
    pw = _port(_weights(1, 30))
    before = wavernn_sample_loop.launches
    out, _ = wavernn_sample_loop(t(_cond(0, 3)), pw)
    assert wavernn_sample_loop.launches == before and out.shape == (T, 3)
    assert pw.n_bytes() == sum(x.numel() * x.element_size()
                               for x in pw.tensors())
    assert pw.packed() is pw.packed() and len(pw.packed()) == 11
    assert pw.n_bytes() == sum(x.numel() * x.element_size()
                               for x in pw.tensors())


def test_bf16_wrapper_raises_on_mismatched_types():
    w = _weights(1, 30)
    pw = _port(w)
    cond = t(_cond(0, 2))
    with pytest.raises(TypeError):
        wavernn_sample_loop(cond, pw, weight_dtype="int8")
    q = Int8SampleLoopWeights.from_flax_layout(
        t(w["W_I"]), t(w["b_I"]), t(w["wi1"]), t(w["wh1"]), t(w["bi1"]),
        t(w["bh1"]), t(np.concatenate([w["w2x"], w["w2a"]])), t(w["wh2"]),
        t(w["bi2"]), t(w["bh2"]), t(np.concatenate([w["wf1x"], w["wf1a"]])),
        t(w["bf1"]), t(np.concatenate([w["wf2x"], w["wf2a"]])), t(w["bf2"]),
        t(w["wf3"]), t(w["bf3"]), feat=FEAT)
    with pytest.raises(TypeError):
        wavernn_sample_loop(cond, q)
    # what the kernel's launch checks before it builds or launches anything
    with pytest.raises(TypeError):
        wc._check_tensors(cond, _port(w, torch.float32), None)
    with pytest.raises(ValueError):     # d not a multiple of 16
        wc._check_tensors(cond, dataclasses.replace(pw, ix=pw.ix[:24]), None)
    wc._check_tensors(cond, pw, None)


def test_bf16_plain_float32_weights_stay_float32():
    """float32 matrices (the TPU kernel's float32 verify mode) take no bf16
    rounding: the loop equals itself on a copy of the conditioning rounded
    to bf16 only where the bf16 matrices do."""
    w = _forced_mean_weights(3)
    cond = t(_cond(4, 5))
    f32 = _port(w, torch.float32)
    a, _ = wavernn_sample_loop_plain(cond, f32, mode="MOL",
                                     noise=torch.full((T, 5, 11), 0.5))
    b, _ = wavernn_sample_loop_plain(cond.to(torch.bfloat16).float(), f32,
                                     mode="MOL",
                                     noise=torch.full((T, 5, 11), 0.5))
    assert not torch.equal(a, b)


def test_bf16_step_with_exact_sums():
    """The bf16 step with float64 sums (the reference that chip_smoke.py
    holds the kernel's one-step state and picks against) rounds the same
    activations to bf16 and differs from the float32 sums by rounding only."""
    pw = _port(_weights(2, 30))
    cond = t(_cond(3, 4))
    st = wc.init_state(4, D, "cpu")
    outs = {}
    for acc in (torch.float32, torch.float64):
        step = wc._bf16_step(cond, pw, acc)
        outs[acc] = step(0, st["x"].to(acc), st["h1"].to(acc),
                         st["h2"].to(acc))
    for a, b in zip(outs[torch.float32], outs[torch.float64]):
        assert b.dtype == torch.float64 and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_raw_sample_value_is_the_kernels_division():
    """RAW maps class c to 2c / (n - 1) - 1 with an IEEE division, as the
    kernels compute it: multiplying by the reciprocal (what CUDA does for a
    Python scalar divisor) is one ulp off for 40 of 512 classes."""
    n = 512
    logits = torch.eye(n) * 100.0
    got = wc._sample(logits, torch.full((n, n), 0.5), "RAW", n)
    c = np.arange(n, dtype=np.float32) * np.float32(2)
    want = c / np.float32(n - 1) - np.float32(1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (c * np.float32(1 / (n - 1)) - np.float32(1) != want).sum() > 0
