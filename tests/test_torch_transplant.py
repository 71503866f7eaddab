"""The transplant of pretrained weights (``etts_torch.train.transplant``)
against etts' (``etts/train/transplant.py``): etts' own case on the port's
dotted names; two tiny AR models of different decoder widths, etts'
transplant converted through the flat layout against the port's on the
converted models (equal tensors, equal counts); the freeze mask against
what ``TrainState`` leaves out; and a port checkpoint round-tripped
through ``load_pretrained_params``."""
import jax
import numpy as np
import pytest
import torch

from etts.train.transplant import (text_encoder_freeze_mask as j_mask,
                                   transplant_params as j_transplant)
from etts_torch.convert import load_into
from etts_torch.train.state import FROZEN_PRETRAINED, TrainState
from etts_torch.train.transplant import (load_pretrained_params,
                                         text_encoder_freeze_mask,
                                         transplant_params)
from torch_parity import AR_TINY, SPK_DIM, flatten, seeded_variables


def _ar(seed, **over):
    """(flax variables, the port's model) of one seeded tiny AR model."""
    from etts_torch.models.autoregressive import AutoregressiveTransformer
    tm = AutoregressiveTransformer(system_type="speaker_style_text",
                                   speaker_embed_dim=SPK_DIM,
                                   **dict(AR_TINY, **over))
    return seeded_variables(tm, seed), tm


def test_transplant_and_freeze_mask():
    """etts' case (tests/test_data_pipeline.py::TestTransplant)."""
    target = {"TextEncoder.w": torch.zeros(3, 3), "Decoder.w": torch.zeros(2)}
    donor = {"TextEncoder.w": torch.ones(3, 3),
             "Decoder.w": torch.ones(4)}                # shape mismatch
    new, copied, skipped = transplant_params(target, donor)
    assert copied == 1 and skipped == ["Decoder.w"]
    assert torch.equal(new["TextEncoder.w"], torch.ones(3, 3))
    assert torch.equal(new["Decoder.w"], torch.zeros(2))
    new2, c2, _ = transplant_params(target, donor, only_text_encoder=True)
    assert c2 == 1 and torch.equal(new2["TextEncoder.w"], torch.ones(3, 3))
    mask = text_encoder_freeze_mask(target)
    assert mask == {"TextEncoder.w": True, "Decoder.w": False}


@pytest.mark.parametrize("only_text_encoder", [False, True])
def test_matches_etts_through_convert(only_text_encoder):
    """Donor: decoder width 48; target: 32. etts grafts its flax params,
    the result converted into the port's model, against the port's graft
    of the converted donor into the converted target."""
    v_tgt, tm_tgt = _ar(0)
    v_dnr, tm_dnr = _ar(1, decoder_model_dimension=48)
    new, copied, skipped = j_transplant(v_tgt["params"], v_dnr["params"],
                                        only_text_encoder)
    _, want = _ar(0)
    load_into(want, flatten({**v_tgt, "params": new}))
    got, t_copied, t_skipped = transplant_params(
        dict(tm_tgt.named_parameters()), dict(tm_dnr.named_parameters()),
        only_text_encoder)
    assert t_copied == copied > 0 and len(t_skipped) == len(skipped)
    assert bool(skipped) != only_text_encoder
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p.detach()), name
    # the mask names the text encoder's parameters, as etts' does
    mask = text_encoder_freeze_mask(got)
    n_frozen = sum(np.size(leaf) for leaf, frozen in zip(
        *[jax.tree_util.tree_leaves(x)
          for x in (v_tgt["params"], j_mask(v_tgt["params"]))]) if frozen)
    assert sum(got[n].numel() for n, m in mask.items() if m) == n_frozen


def test_freeze_mask_is_what_train_state_leaves_out():
    _, tm = _ar(0)
    mask = text_encoder_freeze_mask(dict(tm.named_parameters()))
    state = TrainState(tm, [[0, 1e-3]], frozen=FROZEN_PRETRAINED)
    frozen = {n for n, m in mask.items() if m}
    assert frozen and frozen == set(mask) - set(state.names)


def test_load_pretrained_params_round_trips_a_checkpoint(tmp_path):
    from etts_torch.models.init import init_flax
    from etts_torch.text import default_tokenizer
    from etts_torch.utils.checkpoints import CheckpointManager
    from etts_torch.utils.config import ConfigManager, build_tts
    from torch_parity import tiny_corpus
    tiny_corpus(tmp_path)
    cm = ConfigManager(tmp_path, "autoregressive")
    model = build_tts(cm.config, default_tokenizer(True).vocab_size)
    init_flax(model, torch.Generator().manual_seed(3))
    CheckpointManager(cm.weights_dir).save(7, {"model": model.state_dict()})
    params, step = load_pretrained_params(tmp_path, "autoregressive",
                                          device="cpu")
    assert step == 7
    want = dict(model.named_parameters())
    assert set(params) == set(want)
    for name, p in want.items():
        assert torch.equal(params[name], p.detach()), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pretrained_params(tmp_path, "autoregressive")
