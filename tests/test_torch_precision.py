"""Every entry point of the port pins the checked float32 precision: after
each synthesizer's constructor and each CLI's ``main`` runs (on the CPU),
TF32 is off for matmuls and for cuDNN convolutions. torch's own default
leaves cuDNN in TF32, which no check on the card runs."""
import numpy as np
import pytest
import torch
import yaml

from etts_torch import (api, eval_tacotron, extract_durations, synthesize,
                        time_decode, train_autoregressive, train_forward)
from etts_torch.convert import seeded_flat
from etts_torch.utils.config import (build_tacotron, build_vocoder,
                                     load_config)
from torch_parity import ROOT, VOC_SMALL, small_workspace, tiny_corpus

# the Tacotron of configs/default cut to a few units, 4 decode steps (8
# frames, enough samples for Griffin-Lim's reflect padding at n_fft 2048)
TACO_SMALL = dict(embed_depth=8, attention_depth=8, rnn_depth=8,
                  prenet_depths=[8, 4], num_gst=2, num_heads=2,
                  style_embed_depth=8, style_att_dim=4,
                  reference_filters=[2, 2], reference_depth=4, max_iters=4,
                  cbhg_width=4, griffin_lim_iters=1)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Config dirs with seeded exports of the forward model, the vocoder
    and the Tacotron (no flax init), and a tiny training corpus."""
    d = tmp_path_factory.mktemp("precision")
    ws = small_workspace(d, ("forward",))
    for kind, over in (("wavernn", VOC_SMALL), ("tacotron", TACO_SMALL)):
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    np.savez(d / "wavernn.npz",
             **seeded_flat(build_vocoder(load_config(d, "wavernn")), 0))
    np.savez(d / "tacotron.npz",
             **seeded_flat(build_tacotron(load_config(d, "tacotron")), 0))
    tiny_corpus(d / "train")
    return ws


@pytest.fixture
def tf32_on():
    """Both flags set True before the call, restored after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


def _entry(name, d, tmp):
    cfg = str(d)
    return {
        "TTSSynthesizer": lambda: api.TTSSynthesizer(
            cfg, d / "forward.npz", "cpu", phonemizer_backend="grapheme",
            model_kind="forward"),
        "VocoderSynthesizer": lambda: api.VocoderSynthesizer(
            cfg, d / "wavernn.npz", "cpu"),
        "TacotronSynthesizer": lambda: api.TacotronSynthesizer(
            cfg, d / "tacotron.npz", "cpu"),
        "synthesize.main": lambda: synthesize.main(
            ["--tts_config", cfg, "--tts_weights", str(d / "forward.npz"),
             "--model_kind", "forward", "--phonemizer_backend", "grapheme",
             "--sentences", "Hi.", "--out_dir", str(tmp), "--device",
             "cpu"]),
        "eval_tacotron.main": lambda: eval_tacotron.main(
            ["--config", cfg, "--weights", str(d / "tacotron.npz"),
             "--sentences", "Hi.", "--out_dir", str(tmp), "--device",
             "cpu"]),
        "train_autoregressive.main": lambda: train_autoregressive.main(
            ["--config", str(d / "train"), "--device", "cpu",
             "--max_steps", "1"]),
        # no card here: main pins the precision, then returns 2
        "time_decode.main": lambda: time_decode.main([]),
        # these pin it, then find no checkpoint and no training triples
        "extract_durations.main": _raises(FileNotFoundError, lambda: (
            extract_durations.main(["--config", str(d / "train"), "--device",
                                    "cpu", "--session_name", "untrained"]))),
        "train_forward.main": _raises(ValueError, lambda: train_forward.main(
            ["--config", cfg, "--device", "cpu", "--max_steps", "1"])),
    }[name]


def _raises(exc, fn):
    def run():
        with pytest.raises(exc):
            fn()
    return run


@pytest.mark.parametrize("name", [
    "TTSSynthesizer", "VocoderSynthesizer", "TacotronSynthesizer",
    "synthesize.main", "eval_tacotron.main", "train_autoregressive.main",
    "time_decode.main", "extract_durations.main", "train_forward.main"])
def test_entry_point_turns_tf32_off(name, workspace, tf32_on, tmp_path):
    _entry(name, workspace["dir"], tmp_path)()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
