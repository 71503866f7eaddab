"""convert.py: flat keystr exports load into the port's modules with every
key consumed, layouts transposed; unknown, missing or misshapen keys raise;
export_flat gives the exports back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etts.models.wavernn import WaveRNN as JW
from etts_torch.convert import convert, export_flat, load_into, read_flat
from etts_torch.models.wavernn import WaveRNN as TW
from torch_parity import ar_pair, flatten, randomize_batch_stats

VOC_TINY = dict(rnn_dims=16, fc_dims=16, bits=4, pad=2,
                upsample_factors=(2, 5), feat_dims=8, compute_dims=8,
                res_out_dims=8, res_blocks=2, hop_length=10)


def _voc_pair():
    jm = JW(mode="MOL", sample_rate=100, **VOC_TINY)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 50)),
                jnp.zeros((1, 9, 8)), False)
    return jm, randomize_batch_stats(dict(v)), TW(mode="MOL", **VOC_TINY)


@pytest.mark.parametrize("system_type", ["text", "speaker_style_text"])
def test_ar_every_key_consumed(system_type):
    _, variables, tm = ar_pair(system_type)
    flat = flatten(variables)
    sd = convert(flat, tm)
    assert len(sd) == len(flat)                 # one tensor per exported key
    params = {n for n, _ in tm.named_parameters()}
    assert params <= set(sd)                    # nothing left at init


def test_layouts_transposed():
    _, variables, tm = ar_pair("speaker_style_text")
    sd = convert(flatten(variables), tm)
    p = variables["params"]
    dense = np.asarray(p["FinalProj"]["kernel"])                 # (in, out)
    np.testing.assert_array_equal(sd["FinalProj.weight"].numpy(), dense.T)
    conv = np.asarray(p["Postnet"]["conv_blocks"]["conv_0"]["kernel"])
    np.testing.assert_array_equal(
        sd["Postnet.conv_blocks.conv_0.weight"].numpy(),
        conv.transpose(2, 1, 0))                                 # (out, in, k)
    conv2 = np.asarray(p["RefEncoderGST"]["conv_1"]["kernel"])
    np.testing.assert_array_equal(
        sd["RefEncoderGST.conv_1.weight"].numpy(),
        conv2.transpose(3, 2, 0, 1))                             # (out, in, kh, kw)
    bs = variables["batch_stats"]["Postnet"]["conv_blocks"]["norm_0"]
    np.testing.assert_array_equal(
        sd["Postnet.conv_blocks.norm_0.running_var"].numpy(), bs["var"])


@pytest.mark.parametrize("model", ["ar", "wavernn"])
def test_export_flat_inverts_convert(model):
    """A module loaded from flax variables exports them back: the same
    keys, layouts and values (BatchNorm statistics included)."""
    if model == "ar":
        _, variables, tm = ar_pair("speaker_style_text")
    else:
        _, variables, tm = _voc_pair()
        load_into(tm, flatten(variables))
    want, got = flatten(variables), export_flat(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_wavernn_every_key_consumed():
    _, variables, tm = _voc_pair()
    flat = flatten(variables)
    assert any(k.startswith("batch_stats:") for k in flat)
    sd = convert(flat, tm)
    assert len(sd) == len(flat)
    load_into(tm, flat)
    np.testing.assert_array_equal(
        tm.upsample.smooth_0.weight.detach().numpy()[0, 0, 0],
        np.asarray(variables["params"]["upsample"]["smooth_0"]["kernel"])
        [0, :, 0, 0])


def test_renamed_key_raises():
    _, variables, tm = _voc_pair()
    flat = flatten(variables)
    key = "['fc3']['kernel']"
    flat["['fc9']['kernel']"] = flat.pop(key)
    with pytest.raises(KeyError, match="no place"):
        convert(flat, tm)


def test_missing_key_raises():
    _, variables, tm = _voc_pair()
    flat = flatten(variables)
    del flat["['rnn1_wh']"]
    with pytest.raises(KeyError, match="not found"):
        convert(flat, tm)


def test_wrong_shape_raises():
    _, variables, tm = _voc_pair()
    flat = flatten(variables)
    flat["['fc1']['bias']"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert(flat, tm)


def test_missing_batch_stats_keep_init():
    """The committed exports carry no batch_stats: init stats stay."""
    _, variables, tm = _voc_pair()
    flat = {k: v for k, v in flatten(variables).items()
            if not k.startswith("batch_stats:")}
    load_into(tm, flat)
    bn = tm.upsample.resnet.BatchNorm_0
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))


@pytest.mark.parametrize("name,n", [("ar_best_14k_params_fp16.npz", 270),
                                    ("voc_gta26k_params_fp16.npz", 84)])
def test_committed_exports_load(name, n):
    """Both committed exports fit the port's flagship models key for key."""
    from pathlib import Path
    from etts_torch.text import Pipeline
    from etts_torch.utils.config import (build_tts, build_vocoder,
                                         load_config)
    root = Path(__file__).resolve().parents[1]
    flat = read_flat(root / "artifacts" / "soak" / name)
    assert len(flat) == n
    if name.startswith("ar"):
        cfg = load_config(root / "configs" / "default", "autoregressive")
        vocab = Pipeline.default_pipeline(
            "en", True, False, backend="grapheme").tokenizer.vocab_size
        model = build_tts(cfg, vocab)
    else:
        model = build_vocoder(load_config(root / "configs" / "default",
                                          "wavernn"))
    assert len(convert(flat, model)) == n
