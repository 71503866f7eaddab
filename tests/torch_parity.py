"""Shared helpers for the JAX-vs-port parity tests (``test_torch_*.py``):
build the same tiny model in flax and in ``etts_torch`` from one set of
params, carried over through the exported flat-npz layout."""
import functools

import jax
import numpy as np
import torch

from etts_torch.convert import load_into

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


def t(x, dtype=None):
    """numpy / jax array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(x, dtype=dtype))
