"""The port's training driver as a whole, on the CPU, on a tiny corpus
(tests/torch_parity.py::tiny_corpus): its tts_loss step by step against
etts' train step fed etts' Dataset batches from the same initial weights;
a run cut after 2 steps and resumed against one run of 4, bit for bit, with
dropout, head drop and prenet dropout on; and the trained weights, exported
to the flat npz, served by TTSSynthesizer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.data import dataset as jdata
from etts.train import TrainState as JState
from etts.train import make_autoregressive_train_step, make_optimizer
from etts.utils.config import ConfigManager as JConfigManager
from etts_torch.api import TTSSynthesizer
from etts_torch.convert import export_flat
from etts_torch.models.init import init_flax
from etts_torch.text import default_tokenizer
from etts_torch.train_autoregressive import SEED, main
from etts_torch.utils.config import ConfigManager, build_tts
from etts_torch.utils.logging import read_scalars
from torch_parity import tiny_corpus, unflatten

DETERMINISTIC = dict(dropout_rate=0.0, head_drop_schedule=[[0, 0]],
                     decoder_prenet_dropout_schedule=[[0, 0.0]],
                     learning_rate_tts_schedule=[[0, 1e-3]])
# smoothing below 1, so that the MI state carried across the resume counts
RANDOM = dict(dropout_rate=0.1, head_drop_schedule=[[0, 1]],
              decoder_prenet_dropout_schedule=[[0, 0.5]],
              mine_smoothing_factor=0.5)


def run(d, session, steps, *extra):
    main(["--config", str(d), "--device", "cpu", "--session_name", session,
          "--max_steps", str(steps), *extra])
    return ConfigManager(d, "autoregressive", session)


def test_tts_loss_follows_etts(tmp_path):
    """4 steps, use_mine on (the MI hinge moves the loss, not the
    gradients, so tts_loss is compared): within 1e-4 relative each step."""
    tiny_corpus(tmp_path, **DETERMINISTIC)
    cm = run(tmp_path, "s", 4)
    got = read_scalars(cm.log_dir)["train/tts_loss"]
    jcm = JConfigManager(str(tmp_path), "autoregressive", "s")
    c = jcm.config
    model = build_tts(c, default_tokenizer(True).vocab_size)
    init_flax(model, torch.Generator().manual_seed(SEED))
    jm = jcm.get_model(ignore_hash=True)
    tx = make_optimizer(c["learning_rate_tts_schedule"])
    state = JState.create(unflatten(export_flat(model)), tx)
    step = make_autoregressive_train_step(jm, tx, stop_scaling=8.0)
    samples, _ = jdata.load_files(jcm.train_datadir / "train_metafile.txt",
                                  jcm.train_datadir / "mels",
                                  jcm.train_datadir / "spk_embeds")
    tok = jcm.get_text_pipeline(backend="grapheme").tokenizer
    ds = jdata.Dataset(samples, jdata.DataPrepper(c, tok), 4,
                       mel_channels=12)
    for i in range(4):
        state, met, _ = step(state, ds.next_batch(), jnp.zeros(()),
                             jax.random.PRNGKey(i), r=3, prenet_dropout=0.0)
        assert got[i] == pytest.approx(float(met["tts_loss"]), rel=1e-4), i
    assert len(set(got.values())) == 4


def test_resume_is_bit_for_bit(tmp_path, capsys):
    """2 steps, then a rerun to 4, against 4 in one run: the checkpoint
    (weights, BatchNorm statistics, Adam state, step, MI state), every MINE
    net's and the logged losses equal."""
    tiny_corpus(tmp_path, **RANDOM)
    one = run(tmp_path, "one", 4)
    run(tmp_path, "two", 2)
    two = run(tmp_path, "two", 4)
    assert "restored TTS weights at step 2" in capsys.readouterr().out
    for a, b in zip([one.weights_dir] + one.mine_weights_dir,
                    [two.weights_dir] + two.mine_weights_dir):
        x = torch.load(a / "ckpt-4.pt", weights_only=True)
        y = torch.load(b / "ckpt-4.pt", weights_only=True)
        assert x["step"] == y["step"] == 4
        for k in x["model"]:
            assert torch.equal(x["model"][k], y["model"][k]), k
        for pa, pb in zip(x["optimizer"]["state"].values(),
                          y["optimizer"]["state"].values()):
            assert all(torch.equal(pa[k], pb[k]) for k in pa)
    x = torch.load(one.weights_dir / "ckpt-4.pt", weights_only=True)
    y = torch.load(two.weights_dir / "ckpt-4.pt", weights_only=True)
    assert all(torch.equal(x["mi_state"][k], y["mi_state"][k])
               for k in x["mi_state"])
    la, lb = read_scalars(one.log_dir), read_scalars(two.log_dir)
    assert la["train/loss"] == lb["train/loss"]
    assert len(la["mi/MINE_0"]) == 4
    assert all(la[k] == lb[k] for k in la if k.startswith("mi/"))


def test_trained_weights_serve(tmp_path):
    """The step-4 checkpoint exported by ``export_flat`` loads in
    TTSSynthesizer, whose decode reads the trained BatchNorm statistics."""
    tiny_corpus(tmp_path, **RANDOM)
    cm = run(tmp_path, "s", 4)
    model = build_tts(cm.config, default_tokenizer(True).vocab_size)
    model.load_state_dict(torch.load(cm.weights_dir / "ckpt-4.pt",
                                     weights_only=True)["model"])
    np.savez(tmp_path / "trained.npz", **export_flat(model))
    tts = TTSSynthesizer(tmp_path, tmp_path / "trained.npz", "cpu", step=4,
                         phonemizer_backend="grapheme")
    for name, b in tts.model.named_buffers():
        if name.endswith("running_var"):
            assert not torch.equal(b, torch.ones_like(b)), name
    rng = np.random.default_rng(0)
    out = tts.predict("Hello there.", rng.uniform(-4, 4, (30, 12)),
                      rng.normal(size=256), max_length=30)
    assert out["mel"].shape[1] == 12 and np.isfinite(out["mel"]).all()
