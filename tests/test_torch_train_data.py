"""The port's input pipeline against ``etts.data.dataset`` (which imports
no JAX) on the same samples and seed: the same batches in the same order,
bit for bit, across epochs, ``seek``, ``change_batches``, bucketing and GTA
mels; the tokenizer; the session directories against etts'
ConfigManager; checkpoints and the scalar log."""
import numpy as np
import pytest
import torch
import yaml

from etts.data import dataset as jdata
from etts.text import Pipeline as JPipeline
from etts.utils.config import ConfigManager as JConfigManager
from etts_torch.data import dataset as tdata
from etts_torch.text import default_tokenizer
from etts_torch.utils.checkpoints import CheckpointManager
from etts_torch.utils.config import ConfigManager
from etts_torch.utils.logging import ScalarLog, ValueWindow, read_scalars
from torch_parity import tiny_corpus


def _datasets(d, gta=False, **kw):
    tiny_corpus(d)
    cfg = dict(yaml.safe_load(open(d / "autoregressive_config.yaml")),
               **yaml.safe_load(open(d / "data_config.yaml")))
    corpus = d / "corpus"
    args = (corpus / "train_metafile.txt", corpus / "mels",
            corpus / "spk_embeds")
    (js, _), (ts, _) = jdata.load_files(*args), tdata.load_files(*args)
    assert js == ts
    jtok = JPipeline.default_pipeline("en", True, False,
                                      backend="grapheme").tokenizer
    if gta:       # the mels themselves, two frames short
        gdir = d / "gta"
        gdir.mkdir()
        for p in (corpus / "mels").iterdir():
            np.save(gdir / p.name, np.load(p)[:-2] * 0.5)
        jp = jdata.GTADataPrepper(cfg, jtok, gdir)
        tp = tdata.GTADataPrepper(cfg, default_tokenizer(True), gdir)
    else:
        jp, tp = (jdata.DataPrepper(cfg, jtok),
                  tdata.DataPrepper(cfg, default_tokenizer(True)))
    return (lambda: jdata.Dataset(js, jp, 4, mel_channels=12, **kw),
            lambda: tdata.Dataset(ts, tp, 4, mel_channels=12, **kw))


def _same(a, b, n):
    for _ in range(n):
        x, y = a.next_batch(), b.next_batch()
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def test_tokenizer_is_etts():
    jtok = JPipeline.default_pipeline("en", True, False,
                                      backend="grapheme").tokenizer
    tok = default_tokenizer(True)
    assert tok.vocab_size == jtok.vocab_size
    assert tok("həˈloʊ, wɜːld!") == jtok("həˈloʊ, wɜːld!")


@pytest.mark.parametrize("kw", [{}, {"bucket_by_length": True,
                                     "bucket_groups": 2},
                                {"seed": 43, "gta": True}])
def test_batches_equal_etts(tmp_path, kw):
    """10 batches (three epochs of 3), then a fresh stream seeked 5 ahead
    against etts' seeked one, then both switched to 3 a batch."""
    gta = kw.pop("gta", False)
    mk_j, mk_t = _datasets(tmp_path, gta, **kw)
    _same(mk_j(), mk_t(), 10)
    a, b = mk_j(), mk_t()
    a.seek(5)
    b.seek(5)
    _same(a, b, 4)
    a.change_batches(3)
    b.change_batches(3)
    _same(a, b, 5)


def test_prefetcher_keeps_the_order_and_hands_on_errors(tmp_path):
    mk_j, mk_t = _datasets(tmp_path)
    p = tdata.Prefetcher(mk_t())
    try:
        _same(mk_j(), p, 5)
    finally:
        p.stop()

    class Broken:
        def next_batch(self):
            raise OSError("disk gone")
    p = tdata.Prefetcher(Broken())
    with pytest.raises(OSError, match="disk gone"):
        p.next_batch()
    p.stop()


@pytest.mark.parametrize("system, mine_type, pretrained", [
    ("speaker_style_text", "MINE", False), ("speaker_style_text",
                                            "MINE_CLUB", True),
    ("style_text", "CLUB", False), ("text", "MINE", False)])
def test_session_dirs_are_etts(tmp_path, system, mine_type, pretrained):
    tiny_corpus(tmp_path, system_type=system, mine_type=mine_type,
                use_pretrained=pretrained)
    j = JConfigManager(str(tmp_path), "autoregressive", "s")
    p = ConfigManager(tmp_path, "autoregressive", "s")
    for a in ("session_name", "base_dir", "log_dir", "weights_dir",
              "train_datadir", "mine_weights_dir"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.config["mine_pair_types"] == j.config["mine_pair_types"]
    p.create_remove_dirs()
    p.dump_config()
    assert yaml.safe_load(open(p.base_dir / "autoregressive_config.yaml"))[
        "session_name"] == "tmp_path_s".replace("tmp_path", tmp_path.name)
    (p.weights_dir / "x").write_text("")
    p.create_remove_dirs(clear_dir=True, force=True)
    assert p.weights_dir.is_dir() and not (p.weights_dir / "x").exists()


def test_checkpoints_keep_the_newest(tmp_path):
    m = CheckpointManager(tmp_path / "w", max_to_keep=2)
    assert m.restore() == (None, None)
    for step in (10, 20, 30):
        m.save(step, {"step": step, "x": torch.full((3,), float(step))})
    assert m.steps() == [20, 30]
    tree, step = m.restore()
    assert step == 30 and torch.equal(tree["x"], torch.full((3,), 30.0))
    assert m.restore(20)[0]["step"] == 20
    assert not list((tmp_path / "w").glob(".*tmp"))


def test_scalar_log_and_window(tmp_path):
    log = ScalarLog(tmp_path)
    log.add_scalar("train/loss", 2.5, 0)
    log.add_scalar("train/loss", 2.0, 1)
    log.add_scalar("train/loss", 1.5, 1)      # a rerun of step 1 wins
    assert read_scalars(tmp_path) == {"train/loss": {0: 2.5, 1: 1.5}}
    path = log.save_mel(np.ones((4, 3)), "prediction/mel", 7)
    assert path.name == "prediction_mel_7.npy"
    w = ValueWindow(2)
    for x in (1.0, 2.0, 4.0):
        w.append(x)
    assert w.average == 3.0 and w.count == 2
