"""The tensor-core layout of the int8 sample-loop kernels on the CPU: the
packing of the int8 matrices (``pack_mma_int8``), the kernels' fragment
products emulated lane by lane on the packed tiles (``qstream`` in
``csrc/wavernn_cell.cu``: mma.m16n8k32 s8 for int8_mxu; each int8 word
turned into bf16 pairs by the kernel's bit operations, then two
mma.m16n8k16 for int8), and the int8 step with exact sums.

Tolerances: the emulated products are compared exactly (float64 sums of
int8 x int8, or of bf16 x int8 products, at these widths hold every partial
sum); 1e-5 between the int8 step's float32 and float64 sums."""
import numpy as np
import pytest
import torch

from etts_torch.ops.kernels import wavernn_cell as wc
from etts_torch.ops.kernels.wavernn_cell import (Int8SampleLoopWeights,
                                                 pack_mma_int8,
                                                 unpack_mma_int8)
from torch_parity import t

SHAPES = [(30, 512), (48, 112), (96, 32), (16, 64)]


def _q(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_int8_round_trip(shape):
    """Round trip against the logical (out, in) matrix, for shapes that are
    not multiples of the 16 x 32 tile (fc3 30 x 512, wic 512 x 112 cut
    down, w2a 3d x adim); the padding is zero."""
    q = _q(shape)
    p = pack_mma_int8(q)
    assert p.dtype == torch.int8
    assert p.shape == (-(-shape[0] // 16), -(-shape[1] // 32), 32, 16)
    assert torch.equal(unpack_mma_int8(p, *shape), q)
    full = unpack_mma_int8(p, p.shape[0] * 16, p.shape[1] * 32)
    assert int(full[shape[0]:].abs().sum() + full[:, shape[1]:].abs().sum()) \
        == 0


def test_int8_weights_pack_once():
    rng = np.random.default_rng(0)
    d, fc, feat, adim = 32, 32, 8, 4
    n = lambda *s: t((rng.standard_normal(s) * 0.1).astype(np.float32))
    w = Int8SampleLoopWeights.from_flax_layout(
        n(1 + feat + adim, d), n(d), n(d, 3 * d), n(d, 3 * d), n(3 * d),
        n(3 * d), n(d + adim, 3 * d), n(d, 3 * d), n(3 * d), n(3 * d),
        n(d + adim, fc), n(fc), n(fc + adim, fc), n(fc), n(fc, 30), n(30),
        feat=feat)
    assert w.wic.shape == (d, feat + adim) and w.w2a.shape == (3 * d, adim)
    packed = w.packed()
    assert packed is w.packed() and len(packed) == 11
    for k, p in zip(wc.MATRICES, packed):
        assert torch.equal(unpack_mma_int8(p, *getattr(w, k).shape),
                           getattr(w, k))
    assert w.n_bytes() == sum(x.numel() * x.element_size()
                              for x in w.tensors())


# --- the kernels' fragment products, emulated ---

def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) on uint32 numpy arrays (selector
    nibbles 0-7, no sign replication)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_bits_to_f64(b):
    return (b.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _bf16_pair(p):
    """The kernel's bf16_pair: the bf16 128 + (b & 0x7F) plus the bf16
    -(128 + (b & 0x80)), packed; returns the values (lo, hi)."""
    a = (p & 0x007F007F) | 0x43004300
    m = (p & 0x00800080) | 0xC300C300
    halves = []
    for sh in (0, 16):
        v = (_bf16_bits_to_f64((a >> sh) & 0xFFFF)
             + _bf16_bits_to_f64((m >> sh) & 0xFFFF))
        halves.append(v)
    return halves


def test_bf16_pair_is_exact_for_every_byte():
    """Every signed byte -127..127 comes out as its own value, and the
    value is a bf16 (the packed FMA's rounding cannot change it)."""
    b = np.arange(-127, 128)
    u = (b & 0xFF).astype(np.uint32)
    p = u | (u[::-1] << 16)
    lo, hi = _bf16_pair(p)
    np.testing.assert_array_equal(lo, b)
    np.testing.assert_array_equal(hi, b[::-1])
    f = b.astype(np.float32)
    assert ((f.view(np.uint32) & 0xFFFF) == 0).all()


def _words(p, mt, kt):
    """The four words (x, y, z, w) of each lane's 16-byte fragment of tile
    (mt, kt), as uint32 (32,) arrays (little-endian bytes)."""
    raw = p[mt, kt].numpy().astype(np.uint8).reshape(32, 4, 4)
    w = raw.astype(np.uint32)
    words = (w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
             | (w[..., 3] << 24))
    return [words[:, j] for j in range(4)]


LANE = np.arange(32)
G, T4 = LANE // 4, LANE % 4


def _emulate(p, act, M, mxu):
    """W @ act.T from the packed tiles p, computed as qstream does for the
    8 rows of a tile: int8_mxu, the mma.m16n8k32 s8 fragments read straight
    from the words and the int8 activations at columns 4t.. and 16 + 4t..
    of row g; int8, each word turned into two bf16 pairs (lo_pair: bytes 0,
    1; hi_pair: bytes 2, 3) as the A fragments of two mma.m16n8k16, and the
    lane's B fragments the bf16 activations at columns 4t..4t+3 and 16 +
    4t.. of row g. The mma's are emulated from the PTX fragment layouts."""
    MT, KT = p.shape[:2]
    N = act.shape[0]
    act = torch.nn.functional.pad(act, (0, KT * 32 - act.shape[1],
                                        0, 8 - N))
    a64 = act.double().numpy()
    out = np.zeros((MT * 16, 8))
    for mt in range(MT):
        for kt in range(KT):
            x, y, z, w = _words(p, mt, kt)
            c = np.zeros((16, 8))
            rows = a64[G, kt * 32:(kt + 1) * 32]          # (32 lanes, 32)
            if mxu:
                A = np.zeros((16, 32))
                for j, reg in enumerate((x, y, z, w)):
                    for e in range(4):
                        b = ((reg >> (8 * e)) & 0xFF).astype(np.int64)
                        A[G + 8 * (j & 1), 4 * T4 + e + 16 * (j >> 1)] = \
                            np.where(b > 127, b - 256, b)
                B = np.zeros((32, 8))
                for e in range(4):
                    B[4 * T4 + e, G] = rows[LANE, 4 * T4 + e]
                    B[16 + 4 * T4 + e, G] = rows[LANE, 16 + 4 * T4 + e]
                c += A @ B
            else:
                for half, (r0, r1) in enumerate(((x, y), (z, w))):
                    regs = []
                    for word in (r0, r1):
                        for sel in (0x4140, 0x4342):
                            regs.append(_bf16_pair(_byte_perm(
                                word, np.zeros_like(word), sel)))
                    # A registers: lo_pair(r0), lo_pair(r1), hi_pair(r0),
                    # hi_pair(r1)
                    a_regs = [regs[0], regs[2], regs[1], regs[3]]
                    A = np.zeros((16, 16))
                    for j, (lo, hi) in enumerate(a_regs):
                        row = G + 8 * (j & 1)
                        col = 2 * T4 + 8 * (j >> 1)
                        A[row, col], A[row, col + 1] = lo, hi
                    B = np.zeros((16, 8))
                    base = 16 * half + 4 * T4
                    for k in range(2):
                        B[2 * T4 + k, G] = rows[LANE, base + k]
                        B[2 * T4 + 8 + k, G] = rows[LANE, base + 2 + k]
                    c += A @ B
            out[mt * 16:(mt + 1) * 16] += c
    return out[:M, :N]


@pytest.mark.parametrize("mxu", [False, True], ids=["int8", "int8_mxu"])
@pytest.mark.parametrize("shape,rows", [((30, 512), 8), ((48, 112), 5),
                                        ((96, 32), 3)])
def test_fragment_product_on_packed_tiles(shape, rows, mxu):
    """The kernels' fragment products on the packed tiles equal q @ act
    exactly, for shapes that are not multiples of the tile and fewer rows
    than the tile's 8."""
    q = _q(shape, seed=1)
    g = torch.Generator().manual_seed(2)
    if mxu:
        act = torch.randint(-127, 128, (rows, shape[1]), generator=g).double()
    else:
        act = torch.randn(rows, shape[1], generator=g).to(
            torch.bfloat16).double()
    got = _emulate(pack_mma_int8(q), act, shape[0], mxu)
    want = (q.double() @ act.T).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_step_with_exact_sums():
    """The int8 step with float64 sums (the reference that chip_smoke.py
    holds the kernel's one-step state and picks against) rounds the same
    activations to bf16 and differs from the float32 sums by rounding only;
    int8_mxu's step is float32 whatever the sum type."""
    rng = np.random.default_rng(4)
    d, fc, feat, adim = 32, 32, 8, 4
    n = lambda *s: t((rng.standard_normal(s) * 0.2).astype(np.float32))
    w = Int8SampleLoopWeights.from_flax_layout(
        n(1 + feat + adim, d), n(d), n(d, 3 * d), n(d, 3 * d), n(3 * d),
        n(3 * d), n(d + adim, 3 * d), n(d, 3 * d), n(3 * d), n(3 * d),
        n(d + adim, fc), n(fc), n(fc + adim, fc), n(fc), n(fc, 30), n(30),
        feat=feat)
    cond = n(2, 4, feat + 4 * adim)
    st = wc.init_state(4, d, "cpu")
    outs = {}
    for acc in (torch.float32, torch.float64):
        step = wc._int8_step(cond, w, False, acc)
        outs[acc] = step(0, st["x"], st["h1"].to(acc), st["h2"].to(acc))
    for a, b in zip(outs[torch.float32], outs[torch.float64]):
        assert b.dtype == torch.float64 and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    mx = wc._int8_step(cond, w, True, torch.float64)(0, st["x"], st["h1"],
                                                      st["h2"])
    assert all(x.dtype == torch.float32 for x in mx)
