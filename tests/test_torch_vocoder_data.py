"""The vocoder's data pipeline of the port against etts' on the CPU:
``collate_vocoder`` under the same generator (MOL and RAW),
``fast_forward_permutation``, ``mu_law_encode`` / ``float_to_label``, and
the store ``build_vocoder_dataset`` (and ``python -m
etts_torch.preprocess_wavernn``) writes from seeded wavs: ``dataset.pkl``
and ``quant/`` equal, ``mel/`` within MEL_TOL; a RAW store's labels."""
import pickle

import numpy as np
import pytest
import torch

from etts.data import dataset as jdata
from etts.data.builders import _quantize as j_quantize
from etts.data.builders import build_vocoder_dataset as j_build
from etts.ops import normalizers as jnorm
from etts_torch import preprocess_wavernn
from etts_torch.data import dataset as tdata
from etts_torch.data.audio_io import load_wav
from etts_torch.data.builders import _quantize
from etts_torch.ops import normalizers as tnorm
from torch_parity import VOC_AUDIO, voc_store

# the stores' mels, (mel + 4) / 8 in [0, 1]: the float32 FFTs of the two
# frameworks round apart in the last bits (tests/test_torch_frontend.py)
MEL_TOL = 1e-5


def _items(seed, n=5, mel_c=8, hop=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(20, 40))
        out.append((rng.uniform(0, 1, (mel_c, t)).astype(np.float32),
                    rng.integers(0, 2 ** 16, t * hop).astype(np.int64)))
    return out


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_collate_vocoder_matches_etts(mode):
    items = _items(0)
    want = jdata.collate_vocoder(items, 50, 10, 2, mode=mode, bits=9,
                                 rng=np.random.default_rng(3))
    got = tdata.collate_vocoder(items, 50, 10, 2, mode=mode, bits=9,
                                rng=np.random.default_rng(3))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (5, 50) and got[2].shape == (5, 9, 8)


@pytest.mark.parametrize("n_steps", [0, 3, 7, 8, 21])
def test_fast_forward_permutation_matches_etts(n_steps):
    a, b = np.random.default_rng(1234), np.random.default_rng(1234)
    assert (tdata.fast_forward_permutation(a, 10, 4, n_steps)
            == jdata.fast_forward_permutation(b, 10, 4, n_steps))
    np.testing.assert_array_equal(a.permutation(10), b.permutation(10))


def test_vocoder_dataset_reads_mel_or_gta(tmp_path):
    for sub in ("mel", "gta", "quant"):
        (tmp_path / sub).mkdir()
        np.save(tmp_path / sub / "a.npy", np.full(3, len(sub)))
    for gta, n in ((False, 3), (True, 3)):
        ds = tdata.VocoderDataset(["a"], tmp_path, gta)
        mel, quant = ds[0]
        assert len(ds) == 1 and mel[0] == n and quant[0] == 5
    assert tdata.VocoderDataset(["a"], tmp_path).mel_path.endswith("mel")


def test_mu_law_and_labels_match_etts():
    x = np.random.default_rng(0).uniform(-1, 1, 50000).astype(np.float32)
    x[:5] = [-1.0, -0.5, 0.0, 0.5, 1.0]
    t = torch.from_numpy(x)
    for mu in (2 ** 9, 2 ** 10):
        np.testing.assert_array_equal(tnorm.mu_law_encode(t, mu).numpy(),
                                      np.asarray(jnorm.mu_law_encode(x, mu)))
    for bits in (9, 16):
        np.testing.assert_array_equal(tnorm.float_to_label(t, bits).numpy(),
                                      np.asarray(jnorm.float_to_label(x,
                                                                      bits)))
    for mode, mu_law in (("MOL", True), ("RAW", True), ("RAW", False)):
        q = _quantize(x * 1.3, mode, 9, mu_law, peak_norm=True)
        assert q.dtype == np.int64 and q.min() >= 0
        assert q.max() == (2 ** 16 - 1 if mode == "MOL" else 2 ** 9 - 1)


def _compare_stores(got, want):
    with open(got / "dataset.pkl", "rb") as f, \
            open(want / "dataset.pkl", "rb") as g:
        index = pickle.load(f)
        assert index == pickle.load(g)
    for item_id, frames in index:
        m = np.load(got / "mel" / f"{item_id}.npy")
        mw = np.load(want / "mel" / f"{item_id}.npy")
        assert m.dtype == np.float32 and m.shape == mw.shape == (8, frames)
        np.testing.assert_allclose(m, mw, atol=MEL_TOL, err_msg=item_id)
        q = np.load(got / "quant" / f"{item_id}.npy")
        qw = np.load(want / "quant" / f"{item_id}.npy")
        assert q.dtype == qw.dtype == np.int64
        np.testing.assert_array_equal(q, qw, err_msg=item_id)
    return index


def test_build_vocoder_dataset_matches_etts(tmp_path):
    """The MOL store of 10 seeded wavs (and one too short for a window)
    and etts' of the same wavs; then the CLI's store against the one
    ``build_vocoder_dataset`` wrote."""
    store = voc_store(tmp_path)
    want = tmp_path / "etts_store"
    j_build(tmp_path / "wavs", want, VOC_AUDIO, mode="MOL", njobs=2,
            progress=False)
    index = _compare_stores(store, want)
    assert len(index) == 11 and min(n for _, n in index) == 11
    preprocess_wavernn.main(["--config", str(tmp_path), "--wav_dir",
                             str(tmp_path / "wavs"), "--out_dir",
                             str(tmp_path / "cli"), "--njobs", "1",
                             "--device", "cpu"])
    _compare_stores(tmp_path / "cli", store)


def test_build_vocoder_dataset_defaults_to_the_card(tmp_path):
    """As its sibling builders: on the card unless asked for the CPU, and
    without a card it raises."""
    import inspect
    from etts_torch.data.builders import build_vocoder_dataset
    assert inspect.signature(build_vocoder_dataset).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_vocoder_dataset(tmp_path, tmp_path / "store", VOC_AUDIO)


@pytest.mark.parametrize("mu_law", [True, False], ids=["mu-law", "linear"])
def test_raw_store_labels_match_etts(tmp_path, mu_law):
    """A RAW store's labels (9 bits, mu-law or linear) against etts'
    quantizer on the same samples (all wavs in one call: etts' eager
    jnp compiles once a length)."""
    store = voc_store(tmp_path, mode="RAW", mu_law=mu_law)
    index = pickle.load(open(store / "dataset.pkl", "rb"))
    wavs = [load_wav(tmp_path / "wavs" / f"{i}.wav")[0] for i, _ in index]
    want = np.split(j_quantize(np.concatenate(wavs), "RAW", 9, mu_law, False),
                    np.cumsum([len(w) for w in wavs])[:-1])
    for (item_id, _), w in zip(index, want):
        np.testing.assert_array_equal(
            np.load(store / "quant" / f"{item_id}.npy"), w, err_msg=item_id)
