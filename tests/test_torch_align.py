"""The port's duration extraction (``etts_torch.align``) against etts' on
seeded attention, numpy on both sides, so equal bit for bit: every
combination of the weighted or best head, binary or rounded durations,
jump fixing and zero filling; the invariant sum(durations) == mel_len - 2;
``normalized_durations`` as the values the rounding starts from."""
import numpy as np
import pytest

from etts.align import durations as jd
from etts_torch.align import durations as td


def seeded_batch(seed=0, b=3, heads=2, t_mel=40, t_phon=12, mel_c=5):
    """(attention (b, heads, t_mel, t_phon), mels, phonemes) with rows of
    other lengths: attention a softmax along the phonemes around a
    diagonal with noise, a few frames jumping far ahead, two phonemes that
    draw little attention (zero durations to fill); mels zero past each
    row's length, ids zero past theirs."""
    rng = np.random.default_rng(seed)
    att = np.zeros((b, heads, t_mel, t_phon))
    mels = np.zeros((b, t_mel, mel_c), np.float32)
    phon = np.zeros((b, t_phon), np.int32)
    for i in range(b):
        m = t_mel if i == 0 else int(rng.integers(t_mel // 2, t_mel))
        n = t_phon if i == 0 else int(rng.integers(t_phon // 2 + 2, t_phon))
        mels[i, :m] = rng.normal(0, 1, (m, mel_c))
        phon[i, :n] = rng.integers(1, 40, n)
        centre = np.linspace(0, n - 1, m)
        logits = (-0.5 * (np.arange(t_phon)[None] - centre[:, None]) ** 2
                  + rng.normal(0, 0.3, (heads, m, t_phon)))
        logits[:, :, 3] -= 4.0
        logits[:, :, n - 3] -= 4.0
        for f in rng.choice(np.arange(2, m - 2), 2, replace=False):
            logits[:, f, n - 2] += 12.0           # a jump far ahead
        logits[:, :, n:] = -1e9
        e = np.exp(logits - logits.max(-1, keepdims=True))
        att[i, :, :m] = e / e.sum(-1, keepdims=True)
    return att, mels, phon


CASES = [dict(weighted=True, binary=False, fix_jumps=False, fill_gaps=True,
              fill_mode="next"),
         dict(weighted=False, binary=False, fix_jumps=False, fill_gaps=True,
              fill_mode="max"),
         dict(weighted=True, binary=True, fix_jumps=False, fill_gaps=True,
              fill_mode="next"),
         dict(weighted=False, binary=True, fix_jumps=True, fill_gaps=True,
              fill_mode="max"),
         dict(weighted=True, binary=True, fix_jumps=True, fill_gaps=False),
         dict(weighted=False, binary=False, fix_jumps=False, fill_gaps=False)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("opts", CASES, ids=[
    "weighted-round-next", "best-round-max", "weighted-binary-next",
    "best-binary-fixjumps-max", "weighted-binary-fixjumps-nofill",
    "best-round-nofill"])
def test_durations_equal_etts(opts, seed):
    att, mels, phon = seeded_batch(seed)
    want = jd.get_durations_from_alignment(att, mels, phon, **opts)
    got = td.get_durations_from_alignment(att, mels, phon, **opts)
    for w, g in zip(want, got):
        assert len(w) == len(g) == 3
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    mel_lens, phon_lens = td._unpad_lengths(mels, phon)
    for dur, mel, p, m, n in zip(got[0], got[1], got[2], mel_lens,
                                 phon_lens):
        assert dur.sum() == m - 2 == mel.shape[0]
        assert dur.shape == p.shape == (n - 2,)
        if opts["fill_gaps"]:
            assert (dur > 0).all()


def test_seeded_attention_exercises_every_branch():
    """The seeded rows give the binary mode zero durations (for the
    filling to act on) and jumps that fix_jumps changes."""
    att, mels, phon = seeded_batch(0)
    plain = td.get_durations_from_alignment(att, mels, phon, binary=True)[0]
    fixed = td.get_durations_from_alignment(att, mels, phon, binary=True,
                                            fix_jumps=True)[0]
    assert any((d == 0).any() for d in plain)
    assert any(not np.array_equal(a, b) for a, b in zip(plain, fixed))


@pytest.mark.parametrize("weighted", [True, False])
def test_normalized_durations(weighted):
    """The values the rounding starts from: they sum to mel_len - 2, and
    the unfilled integer durations lie within one frame of them."""
    att, mels, phon = seeded_batch(2)
    mel_lens, phon_lens = td._unpad_lengths(mels, phon)
    durs = td.get_durations_from_alignment(att, mels, phon,
                                           weighted=weighted)[0]
    for i, dur in enumerate(durs):
        norm = td.normalized_durations(att[i], int(mel_lens[i]),
                                       int(phon_lens[i]), weighted)
        assert norm.sum() == pytest.approx(mel_lens[i] - 2, abs=1e-9)
        assert np.abs(dur - norm).max() <= 1.0


def test_helpers_equal_etts():
    rng = np.random.default_rng(3)
    dur = rng.integers(0, 4, 15)
    np.testing.assert_array_equal(td.duration_to_alignment_matrix(dur),
                                  jd.duration_to_alignment_matrix(dur))
    for mode in ("next", "max"):
        np.testing.assert_array_equal(td.fill_zeros(dur, mode),
                                      jd.fill_zeros(dur, mode))
    binary = np.eye(9)[rng.integers(0, 9, 30)]
    for th in (1, 2, 5):
        np.testing.assert_array_equal(td.clean_attention(binary, th),
                                      jd.clean_attention(binary, th))
    w = rng.uniform(size=(30, 9))
    np.testing.assert_array_equal(td.weight_mask(w), jd.weight_mask(w))


def test_fix_jumps_needs_binary():
    att, mels, phon = seeded_batch(0)
    with pytest.raises(ValueError, match="non-binary"):
        td.get_durations_from_alignment(att, mels, phon, fix_jumps=True)
