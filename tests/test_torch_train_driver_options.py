"""The driver with each option etts' driver takes, a few steps on the CPU on
a tiny corpus: mine_type MINE, CLUB and MINE_CLUB, the adversarial game,
scheduled sampling with the style loss and the MINE batch of its own, GTA
decoder inputs with the pretrained freeze. Each must run to its end with
finite losses and its checkpoints."""
import math

import numpy as np
import pytest
import torch

from etts_torch.train_autoregressive import main
from etts_torch.utils.config import ConfigManager
from etts_torch.utils.logging import read_scalars
from torch_parity import tiny_corpus

CASES = {
    "mine": {},
    "club": {"mine_type": "CLUB"},
    "mine_club_adversarial": {"mine_type": "MINE_CLUB",
                              "mine_adversarial": True},
    "sampling_style_sep_call": {
        "scheduled_sampling_schedule": [[0, 0.5]], "use_style_loss": True,
        "mine_sep_call": True, "divergence_type": "reyni",
        "mine_smoothing_factor": 0.9},
    "gta_pretrained": {"gta": True, "use_pretrained": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_option_runs(tmp_path, case):
    over = dict(CASES[case])
    gta = over.pop("gta", False)
    ids = tiny_corpus(tmp_path, **over)
    extra = []
    if gta:
        gdir = tmp_path / "gta"
        gdir.mkdir()
        for u in ids:
            mel = np.load(tmp_path / "corpus" / "mels" / f"{u}.npy")
            np.save(gdir / f"{u}.npy", mel[:-1] * 0.9)
        extra = ["--gta_mel_dir", str(gdir)]
    main(["--config", str(tmp_path), "--device", "cpu", "--session_name",
          "s", "--max_steps", "3", *extra])
    cm = ConfigManager(tmp_path, "autoregressive", "s")
    logs = read_scalars(cm.log_dir)
    assert len(logs["train/loss"]) == 3
    assert all(math.isfinite(v) for v in logs["train/loss"].values())
    n_mi = sum(1 for tag in logs if tag.startswith("mi/"))
    assert n_mi == len(cm.mine_weights_dir) > 0
    for w in [cm.weights_dir] + cm.mine_weights_dir:
        assert (w / "ckpt-3.pt").exists()
    if over.get("use_pretrained"):
        tree = torch.load(cm.weights_dir / "ckpt-3.pt", weights_only=True)
        assert len(tree["optimizer"]["state"]) < len(
            [k for k in tree["model"] if "running" not in k])
