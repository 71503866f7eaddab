"""Shared helpers for the JAX-vs-port parity tests (``test_torch_*.py``):
build the same tiny model in flax and in ``etts_torch`` from one set of
params, carried over through the exported flat-npz layout."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from etts_torch.convert import load_into, seeded_flat

# the models here are tiny; two threads per test process keep parallel
# test workers from crowding the CPU that the timing tests measure on
torch.set_num_threads(min(2, torch.get_num_threads()))


def flatten(variables) -> dict:
    """flax variables -> the flat ``keystr`` dict export_params_npz writes."""
    flat = {}

    def collect(prefix):
        def f(path, leaf):
            flat[prefix + jax.tree_util.keystr(path)] = np.asarray(
                leaf, np.float32)
        return f
    jax.tree_util.tree_map_with_path(collect(""), variables["params"])
    if variables.get("batch_stats"):
        jax.tree_util.tree_map_with_path(collect("batch_stats:"),
                                         variables["batch_stats"])
    return flat


def unfreeze(variables):
    """A copy with fresh (mutable) dict containers, arrays shared."""
    if isinstance(variables, dict) or hasattr(variables, "items"):
        return {k: unfreeze(v) for k, v in variables.items()}
    return variables


def randomize_batch_stats(variables, seed=0):
    """Non-trivial BatchNorm running stats so inference BN is exercised."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['var']"):
            return jax.numpy.asarray(rng.uniform(0.5, 1.5, shape), np.float32)
        return jax.numpy.asarray(rng.normal(0, 0.1, shape), np.float32)
    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        f, variables["batch_stats"])
    return out


AR_TINY = dict(encoder_model_dimension=32, decoder_model_dimension=32,
               encoder_num_heads=(2, 2), decoder_num_heads=(2, 2),
               encoder_dense_blocks=2, decoder_dense_blocks=2,
               encoder_feed_forward_dimension=48,
               decoder_feed_forward_dimension=48,
               encoder_prenet_dimension=32, decoder_prenet_dimension=24,
               postnet_conv_filters=16, postnet_conv_layers=3,
               postnet_kernel_size=3, encoder_maximum_position_encoding=100,
               decoder_maximum_position_encoding=300, mel_channels=12,
               vocab_size=40, ref_encoder_filters=(4, 8),
               ref_encoder_gru_cell_units=8, gst_style_embed_dim=16,
               gst_multi_num_heads=2, gst_heads=5, max_r=3)
SPK_DIM = 256


@functools.lru_cache(maxsize=16)
def _ar_init(system_type, seed, batch_stats, over):
    from etts.models.autoregressive import AutoregressiveTransformer as JM
    cfg = dict(AR_TINY, **dict(over))
    jm = JM(system_type=system_type, **cfg)
    key = jax.random.PRNGKey(seed)
    phon = jax.random.randint(key, (1, 7), 1, cfg["vocab_size"])
    mel = jax.random.normal(key, (1, 9, cfg["mel_channels"])) * 0.3
    spk = (jax.numpy.zeros((1, 1, SPK_DIM))
           if "speaker" in system_type else None)
    variables = jm.init({"params": key, "dropout": key, "prenet": key},
                        phon, mel, spk, r=1)
    variables = dict(variables)
    if batch_stats:
        variables = randomize_batch_stats(variables, seed)
    return jm, variables


def ar_pair(system_type="text", seed=0, batch_stats=True, **over):
    """(flax model, variables, torch model) sharing one random init; the
    variables are fresh containers, safe to edit."""
    from etts_torch.models.autoregressive import (
        AutoregressiveTransformer as TM)
    cfg = dict(AR_TINY, **over)
    jm, variables = _ar_init(system_type, seed, batch_stats,
                             tuple(sorted(over.items())))
    variables = unfreeze(variables)
    tcfg = {k: v for k, v in cfg.items()
            if k not in ("encoder_maximum_position_encoding",
                         "decoder_maximum_position_encoding")}
    tm = TM(system_type=system_type, speaker_embed_dim=SPK_DIM,
            encoder_maximum_position_encoding=cfg[
                "encoder_maximum_position_encoding"],
            decoder_maximum_position_encoding=cfg[
                "decoder_maximum_position_encoding"], **tcfg)
    load_into(tm, flatten(variables))
    return jm, variables, tm


def unflatten(flat: dict) -> dict:
    """The flat ``keystr`` dict -> flax variables {'params', and
    'batch_stats' where it has any}: the inverse of ``flatten``."""
    out = {}
    for key, a in flat.items():
        col = "batch_stats" if key.startswith("batch_stats:") else "params"
        node = out.setdefault(col, {})
        *path, leaf = re.findall(r"\['([^']+)'\]",
                                 key.removeprefix("batch_stats:"))
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(a)
    return out


def seeded_variables(module, seed=0) -> dict:
    """Seed a port module in place (``seeded_flat``, 1-D parameters normal
    0.1) and return its weights as flax variables, with no flax init."""
    return unflatten(seeded_flat(module, seed, std_1d=0.1))


def t(x, dtype=None):
    """numpy / jax array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(x, dtype=dtype))


VOC_TINY = dict(rnn_dims=16, fc_dims=16, bits=4, pad=2,
                upsample_factors=(2, 5), feat_dims=8, compute_dims=8,
                res_out_dims=8, res_blocks=2, hop_length=10)


def voc_pair(mode="MOL", peaky=None, batch_stats=True):
    """(flax WaveRNN, variables, torch WaveRNN) of VOC_TINY sharing one
    random init; ``peaky`` scales fc3's kernel (a near-delta categorical in
    RAW mode makes sampling an argmax)."""
    from etts.models.wavernn import WaveRNN as JW
    from etts_torch.models.wavernn import WaveRNN as TW
    jm = JW(mode=mode, sample_rate=100, **VOC_TINY)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 50)),
                jax.random.normal(jax.random.PRNGKey(0), (2, 9, 8)), False)
    v = {k: dict(x) for k, x in v.items()}
    # the smoothing kernels init to a constant 1/k, which would hide a
    # reversed kernel: give them distinct values
    up = dict(v["params"]["upsample"])
    rng = np.random.default_rng(7)
    for name in ("smooth_0", "smooth_1"):
        k = up[name]["kernel"]
        up[name] = {"kernel": jnp.asarray(rng.uniform(0, 0.3, k.shape),
                                          jnp.float32)}
    v["params"]["upsample"] = up
    if batch_stats:
        v = randomize_batch_stats(v)
    if peaky:
        v["params"] = dict(v["params"])
        v["params"]["fc3"] = dict(v["params"]["fc3"])
        v["params"]["fc3"]["kernel"] = v["params"]["fc3"]["kernel"] * peaky
    return jm, v, load_into(TW(mode=mode, **VOC_TINY), flatten(v))


ROOT = Path(__file__).resolve().parents[1]
TTS_SMALL = dict(
    decoder_model_dimension=32, encoder_model_dimension=32,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    decoder_prenet_dimension=24, encoder_prenet_dimension=32,
    encoder_attention_conv_filters=32, decoder_attention_conv_filters=32,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=2, decoder_dense_blocks=2,
    ref_encoder_filters=[4, 8], ref_encoder_gru_cell_units=8,
    gst_style_embed_dim=16, gst_multi_num_heads=2, gst_heads=5,
    reduction_factor_schedule=[[0, 2], [80000, 1]])
# the forward model: one dense and one conv block in the encoder and in
# the decoder, a capacity of 96 frames
FWD_SMALL = dict(
    decoder_model_dimension=32, encoder_model_dimension=32,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_feed_forward_dimension=48, decoder_feed_forward_dimension=48,
    encoder_attention_conv_filters=24, decoder_attention_conv_filters=20,
    postnet_conv_filters=16, postnet_conv_layers=3, postnet_kernel_size=3,
    encoder_dense_blocks=1, decoder_dense_blocks=1, max_frames=96)
VOC_SMALL = dict(voc_mode="RAW", voc_rnn_dims=16, voc_fc_dims=16,
                 voc_compute_dims=8, voc_res_out_dims=8, voc_res_blocks=2,
                 voc_target=600, voc_overlap=50)


def _jit_init(model, kind):
    """The inputs of etts.utils.config._init_variables, under jit (a few
    times faster than its eager init)."""
    k = jax.random.PRNGKey(0)
    if kind == "autoregressive":
        rngs = {"params": k, "dropout": k, "prenet": k}
        return jax.jit(lambda g, ids, mel, spk: model.init(g, ids, mel, spk,
                                                           r=1))(
            rngs, jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 6, 80)),
            jnp.zeros((1, 1, 256)))
    return jax.jit(lambda g, x, mel: model.init(g, x, mel, False))(
        k, jnp.zeros((1, 4 * 200)), jnp.zeros((1, 8, 80)))


def _seeded_forward(d: Path) -> dict:
    """The forward model of config dir ``d`` on seeded port weights
    (drawn as ``seeded_variables`` draws them, seed 0; no flax init to
    compile), the duration head's bias 1 frame, as flax variables."""
    from etts_torch.utils.config import (build_forward, load_config,
                                         text_pipeline)
    cfg = load_config(d, "forward")
    vocab = text_pipeline(cfg, "grapheme", "forward").tokenizer.vocab_size
    flat = seeded_flat(build_forward(cfg, vocab), 0, std_1d=0.1)
    flat["['dur_pred']['linear']['bias']"][:] = 1.0
    return unflatten(flat)


def small_workspace(d: Path, kinds=("autoregressive", "wavernn")) -> dict:
    """Config dir ``d`` of configs/default shrunk by TTS_SMALL, FWD_SMALL
    and VOC_SMALL, the flat npz exports of one init of each model of
    ``kinds`` (the forward model's from ``_seeded_forward``; the vocoder
    a near-delta RAW categorical, so its sampling is an argmax), a seeded
    reference wav and speaker vector. Returns {'dir', one (ConfigManager,
    flax model, variables) under each kind, 'wav', 'spk'}."""
    from etts.utils.config import ConfigManager
    small = {"autoregressive": TTS_SMALL, "forward": FWD_SMALL,
             "wavernn": VOC_SMALL}
    for kind, over in [(k, small[k]) for k in kinds] + [
            ("data", {"phonemizer_backend": "grapheme",
                      "log_directory": str(d / "logs")})]:
        cfg = yaml.safe_load(open(ROOT / "configs/default" /
                                  f"{kind}_config.yaml"))
        cfg.update(over)
        yaml.safe_dump(cfg, open(d / f"{kind}_config.yaml", "w"))
    out = {"dir": d}
    for kind in kinds:
        cm = ConfigManager(str(d), kind)
        model = cm.get_model(ignore_hash=True)
        if kind == "forward":
            variables = _seeded_forward(d)
        else:
            variables = dict(_jit_init(model, kind))
        if kind == "wavernn":   # near-delta categorical: argmax sampling
            p = {k: dict(v) if hasattr(v, "items") else v
                 for k, v in variables["params"].items()}
            p["fc3"]["kernel"] = p["fc3"]["kernel"] * 1e6
            variables["params"] = p
        np.savez(d / f"{kind}.npz", **flatten(variables))
        out[kind] = (cm, model, variables)
    wav = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    out["wav"] = 0.2 * wav
    out["spk"] = np.random.default_rng(1).standard_normal(256).astype(
        np.float32)
    return out
