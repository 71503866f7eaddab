"""Read a config dir (``data_config.yaml`` + ``{kind}_config.yaml``) and build
the port's models: the counterpart of ``ConfigManager.get_model``
(``etts/utils/config.py:145-305``) for the AR TTS, forward TTS and WaveRNN
families."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from ..text import Pipeline

__all__ = ["load_config", "text_pipeline", "build_tts", "build_forward",
           "build_vocoder", "schedule_values"]


def load_config(config_dir, model_kind: str) -> dict:
    """Merged dict: the model config, overridden by the data config."""
    config_dir = Path(config_dir)
    with open(config_dir / f"{model_kind}_config.yaml") as f:
        config = dict(yaml.safe_load(f))
    with open(config_dir / "data_config.yaml") as f:
        config.update(yaml.safe_load(f))
    return config


def text_pipeline(config: dict, backend: str | None = None,
                  model_kind: str = "autoregressive") -> Pipeline:
    """The TTS model's text pipeline: start and end tokens for the AR
    model, none for the forward model (``ConfigManager.get_text_pipeline``).
    The phonemizer backend is ``backend`` or the config's
    ``phonemizer_backend`` (the one the dataset was built with); with
    neither, this raises."""
    backend = backend or config.get("phonemizer_backend")
    if backend is None:
        raise ValueError("no phonemizer backend: pass one or set "
                         "phonemizer_backend in data_config.yaml")
    return Pipeline.default_pipeline(
        config["phoneme_language"],
        add_start_end=model_kind == "autoregressive",
        with_stress=config.get("with_stress", False), backend=backend)


def _piecewise_linear(step: int, schedule) -> float:
    s = np.asarray(schedule, dtype=np.float64)
    if step < s[0, 0]:
        return float(s[0, 1])
    i = int(np.where(step >= s[:, 0])[0][-1])
    if i == len(s) - 1:
        return float(s[-1, 1])
    (x0, y0), (x1, y1) = s[i], s[i + 1]
    return float(y0 + (y1 - y0) * (step - x0) / (x1 - x0))


def _step_function(step: int, schedule) -> int:
    value = schedule[0][1]
    for bp, v in schedule:
        if bp <= step:
            value = v
        else:
            break
    return int(value)


def schedule_values(config: dict, step: int) -> dict:
    """The TTS model's inference constants at a training step: reduction
    factor r (1 without a schedule, as for the forward model) and decoder
    prenet dropout (``ConfigManager.schedule_values``)."""
    return {"reduction_factor": _step_function(
                step, config["reduction_factor_schedule"])
            if "reduction_factor_schedule" in config else 1,
            "decoder_prenet_dropout": _piecewise_linear(
                step, config["decoder_prenet_dropout_schedule"])
            if "decoder_prenet_dropout_schedule" in config else 0.0}


def build_tts(config: dict, vocab_size: int):
    from ..models.autoregressive import AutoregressiveTransformer
    c = config
    return AutoregressiveTransformer(
        system_type=c["system_type"],
        mel_channels=c["mel_channels"],
        encoder_model_dimension=c["encoder_model_dimension"],
        decoder_model_dimension=c["decoder_model_dimension"],
        encoder_num_heads=tuple(c["encoder_num_heads"]),
        decoder_num_heads=tuple(c["decoder_num_heads"]),
        encoder_feed_forward_dimension=c["encoder_feed_forward_dimension"],
        decoder_feed_forward_dimension=c["decoder_feed_forward_dimension"],
        encoder_maximum_position_encoding=c["encoder_max_position_encoding"],
        decoder_maximum_position_encoding=c["decoder_max_position_encoding"],
        encoder_dense_blocks=c["encoder_dense_blocks"],
        decoder_dense_blocks=c["decoder_dense_blocks"],
        decoder_prenet_dimension=c["decoder_prenet_dimension"],
        encoder_prenet_dimension=c["encoder_prenet_dimension"],
        postnet_conv_filters=c["postnet_conv_filters"],
        postnet_conv_layers=c["postnet_conv_layers"],
        postnet_kernel_size=c["postnet_kernel_size"],
        ref_encoder_filters=tuple(c["ref_encoder_filters"]),
        ref_encoder_kernel_size=c["ref_encoder_kernel_size"],
        ref_encoder_strides=c["ref_encoder_strides"],
        ref_encoder_gru_cell_units=c["ref_encoder_gru_cell_units"],
        gst_style_embed_dim=c["gst_style_embed_dim"],
        gst_multi_num_heads=c["gst_multi_num_heads"],
        gst_heads=c["gst_heads"],
        speaker_embed_dim=c.get("speaker_embed_dim", 256),
        **_conv_blocks(c),
        use_prosody_stats=c.get("use_prosody_stats", False),
        prosody_embed_dim=c.get("prosody_embed_dim", 32),
        max_r=int(np.asarray(c["reduction_factor_schedule"])[0, 1]),
        mel_start_value=c["mel_start_value"],
        vocab_size=vocab_size)


def _conv_blocks(c: dict) -> dict:
    return {k: c[k] for k in (
        "encoder_attention_conv_filters", "decoder_attention_conv_filters",
        "encoder_attention_conv_kernel", "decoder_attention_conv_kernel")}


def build_forward(config: dict, vocab_size: int):
    """The forward (duration) model of ``forward_config.yaml``
    (``etts/utils/config.py:194-215``)."""
    from ..models.forward import ForwardTransformer
    c = config
    return ForwardTransformer(
        mel_channels=c["mel_channels"],
        encoder_model_dimension=c["encoder_model_dimension"],
        decoder_model_dimension=c["decoder_model_dimension"],
        encoder_num_heads=tuple(c["encoder_num_heads"]),
        decoder_num_heads=tuple(c["decoder_num_heads"]),
        encoder_feed_forward_dimension=c["encoder_feed_forward_dimension"],
        decoder_feed_forward_dimension=c["decoder_feed_forward_dimension"],
        encoder_maximum_position_encoding=c["encoder_max_position_encoding"],
        decoder_maximum_position_encoding=c["decoder_max_position_encoding"],
        encoder_dense_blocks=c["encoder_dense_blocks"],
        decoder_dense_blocks=c["decoder_dense_blocks"],
        postnet_conv_filters=c["postnet_conv_filters"],
        postnet_conv_layers=c["postnet_conv_layers"],
        postnet_kernel_size=c["postnet_kernel_size"],
        **_conv_blocks(c), vocab_size=vocab_size)


def build_vocoder(config: dict):
    from ..models.wavernn import WaveRNN
    c = config
    return WaveRNN(
        rnn_dims=c.get("voc_rnn_dims", 512), fc_dims=c.get("voc_fc_dims", 512),
        bits=c.get("bits", 9), pad=c.get("voc_pad", 2),
        upsample_factors=tuple(c.get("voc_upsample_factors", (5, 5, 8))),
        feat_dims=c["mel_channels"],
        compute_dims=c.get("voc_compute_dims", 128),
        res_out_dims=c.get("voc_res_out_dims", 128),
        res_blocks=c.get("voc_res_blocks", 10), hop_length=c["hop_length"],
        mode=c.get("voc_mode", "MOL"))
