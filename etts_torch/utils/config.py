"""Read a config dir (``data_config.yaml`` + ``{kind}_config.yaml``) and build
the port's models: the counterpart of ``ConfigManager.get_model``
(``etts/utils/config.py:145-305``) for the AR TTS, forward TTS, WaveRNN
and GST-Tacotron families; and ``ConfigManager``'s session directories,
which a training driver uses, and the trained model it saved there
(``ConfigManager.load_model``)."""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import yaml

from ..text import Pipeline, default_tokenizer
from .checkpoints import CheckpointManager

__all__ = ["load_config", "text_pipeline", "compute_dtype", "build_tts",
           "build_forward", "build_vocoder", "build_tacotron",
           "schedule_values", "step_schedule", "piecewise_linear_schedule",
           "ConfigManager"]


def _read_yaml(path) -> dict:
    with open(path) as f:
        return dict(yaml.safe_load(f))


def load_config(config_dir, model_kind: str) -> dict:
    """Merged dict: the model config, overridden by the data config."""
    config_dir = Path(config_dir)
    return {**_read_yaml(config_dir / f"{model_kind}_config.yaml"),
            **_read_yaml(config_dir / "data_config.yaml")}


def _mine_pair_types(config: dict) -> list:
    """The embedding pairs MINE reads for the config's system type
    (`etts/utils/config.py:37-56`; "speaker_text" is etts' name, which its
    pair builder refuses, kept as etts has it)."""
    st = config.get("system_type")
    pairs = {"speaker_style_text": ["style_text", "style_speaker",
                                    "text_speaker"],
             "style_text": ["style_text"],
             "speaker_text": ["speaker_text"]}.get(st)
    if pairs is None:
        print(f"use_mine with system_type={st!r}: no embedding pairs to "
              "disentangle, MINE disabled")
        return []
    if config.get("use_pretrained") and st == "speaker_style_text":
        return ["style_text", "style_speaker"]
    return pairs


class ConfigManager:
    """A training session's config and directories (the part of
    ``etts/utils/config.py:60-116, :261-281`` a driver uses): the merged
    ``config`` (MINE's pair types derived from ``system_type``), the
    session name (``session_name``, else the config's, else the git
    hash), ``base_dir``, ``log_dir``, ``weights_dir``, one
    ``mine_weights_dir`` a MINE net, ``train_datadir``; ``dump_config``
    and ``create_remove_dirs``."""

    def __init__(self, config_path, model_kind: str,
                 session_name: Optional[str] = None):
        self.config_path = Path(config_path)
        self.model_kind = model_kind
        self.model_config = _read_yaml(
            self.config_path / f"{model_kind}_config.yaml")
        self.data_config = _read_yaml(self.config_path / "data_config.yaml")
        self.config = {**self.model_config, **self.data_config}
        self.git_hash = _git_hash()
        c = self.config
        if c.get("use_mine"):
            c["mine_pair_types"] = _mine_pair_types(c)
        session_name = session_name or c.get("session_name") or self.git_hash
        self.session_name = "_".join(
            filter(None, [self.config_path.name, session_name]))
        self.base_dir = Path(c["log_directory"]) / self.session_name
        self.log_dir = self.base_dir / f"{model_kind}_logs"
        self.weights_dir = self.base_dir / f"{model_kind}_weights"
        self.train_datadir = Path(c.get("train_data_directory")
                                  or c["data_directory"])
        n_mine = 0
        if c.get("use_mine"):
            n_mine = len(c["mine_pair_types"]) * (
                2 if c.get("mine_type") == "MINE_CLUB" else 1)
        self.mine_weights_dir = [self.base_dir / f"mine_weights_{i}"
                                 for i in range(n_mine)]

    def dump_config(self):
        """Write the model and data configs, with the git hash and session
        name, into ``base_dir``."""
        for cfg in (self.config, self.model_config, self.data_config):
            cfg["git_hash"] = self.git_hash
            cfg["session_name"] = self.session_name
        with open(self.base_dir / f"{self.model_kind}_config.yaml", "w") as f:
            yaml.safe_dump(self.model_config, f)
        with open(self.base_dir / "data_config.yaml", "w") as f:
            yaml.safe_dump(self.data_config, f)

    def load_model(self, step: Optional[int] = None, device="cpu"):
        """The session's model (``model_kind`` "autoregressive", "forward",
        "wavernn" or "tacotron") with the weights and BatchNorm statistics of
        ``weights_dir/ckpt-{step}.pt`` (the latest where ``step`` is None),
        as the training drivers save them, on ``device``; the counterpart
        of etts' ``ConfigManager.load_model``. Returns (model, step, the
        schedule values at that step: ``schedule_values``). Where the
        session has no checkpoint this raises, where etts warns and hands
        back a fresh init."""
        tree, step = CheckpointManager(self.weights_dir).restore(
            step, map_location="cpu")
        if tree is None:
            raise FileNotFoundError(f"no checkpoint in {self.weights_dir}")
        if self.model_kind == "wavernn":
            model = build_vocoder(self.config)
        elif self.model_kind == "tacotron":
            model = build_tacotron(self.config)
        else:
            build = {"autoregressive": build_tts,
                     "forward": build_forward}[self.model_kind]
            model = build(self.config, default_tokenizer(
                self.model_kind == "autoregressive").vocab_size)
        model.load_state_dict(tree["model"])
        print(f"restored weights from {self.weights_dir} at step {step}")
        return (model.to(device).eval(), step,
                schedule_values(self.config, step))

    def create_remove_dirs(self, clear_dir=False, force=False):
        """Make the session's directories; with ``clear_dir`` delete its
        logs and weights first, asking unless ``force``."""
        self.base_dir.mkdir(parents=True, exist_ok=True)
        if clear_dir and (force or input(
                f"Delete {self.log_dir} AND {self.weights_dir}? (y/[n])")
                == "y"):
            shutil.rmtree(self.log_dir, ignore_errors=True)
            shutil.rmtree(self.weights_dir, ignore_errors=True)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.weights_dir.mkdir(parents=True, exist_ok=True)


def _git_hash():
    try:
        return subprocess.check_output(
            ["git", "describe", "--always"],
            stderr=subprocess.DEVNULL).strip().decode()
    except (OSError, subprocess.CalledProcessError):
        print("WARNING: could not retrieve the git hash")
        return None


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


def piecewise_linear_schedule(step: int, schedule) -> float:
    """Linear between the [[step, value], ...] breakpoints, clamped at both
    ends (`etts/utils/scheduling.py:10-21`)."""
    s = np.asarray(schedule, dtype=np.float64)
    if step < s[0, 0]:
        return float(s[0, 1])
    i = int(np.where(step >= s[:, 0])[0][-1])
    if i == len(s) - 1:
        return float(s[-1, 1])
    (x0, y0), (x1, y1) = s[i], s[i + 1]
    return float(y0 + (y1 - y0) * (step - x0) / (x1 - x0))


def step_schedule(step: int, schedule) -> int:
    """The value of the last breakpoint at or before ``step`` (r, head
    drop, MINE batch size); the first value before the first breakpoint."""
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
    return {"reduction_factor": step_schedule(
                step, config["reduction_factor_schedule"])
            if "reduction_factor_schedule" in config else 1,
            "decoder_prenet_dropout": piecewise_linear_schedule(
                step, config["decoder_prenet_dropout_schedule"])
            if "decoder_prenet_dropout_schedule" in config else 0.0}


def compute_dtype(config: dict):
    """The compute dtype of the config's ``precision`` (float32 where it
    has none; "bfloat16" and "bf16" are bf16 compute on float32 parameters,
    `etts/utils/config.py:148-153`); another value raises ``KeyError``, as
    etts' lookup does."""
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16}[config.get("precision", "float32")]


def build_tts(config: dict, vocab_size: int):
    """The AR TTS model of ``autoregressive_config.yaml`` (merged with the
    data config), at the compute dtype of its ``precision``."""
    from ..models.autoregressive import AutoregressiveTransformer
    c = config
    return AutoregressiveTransformer(
        system_type=c["system_type"], dtype=compute_dtype(c),
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
        dropout_rate=c.get("dropout_rate", 0.1),
        vocab_size=vocab_size)


def _conv_blocks(c: dict) -> dict:
    return {k: c[k] for k in (
        "encoder_attention_conv_filters", "decoder_attention_conv_filters",
        "encoder_attention_conv_kernel", "decoder_attention_conv_kernel")}


def build_forward(config: dict, vocab_size: int, dropout_rate: float = 0.1):
    """The forward (duration) model of ``forward_config.yaml``
    (``etts/utils/config.py:194-215``). As etts, it does not read the
    config's ``dropout_rate``: the model's dropout is etts' default 0.1
    unless the caller passes another. Its compute dtype is the config's
    ``precision``'s."""
    from ..models.forward import ForwardTransformer
    c = config
    return ForwardTransformer(
        dtype=compute_dtype(c), mel_channels=c["mel_channels"],
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
        **_conv_blocks(c), vocab_size=vocab_size, dropout_rate=dropout_rate)


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


def build_tacotron(config: dict):
    """The GST-Tacotron of ``tacotron_config.yaml`` (merged with the data
    config), every key read with etts' default
    (``etts/utils/config.py:234-257``); the vocabulary is the keithito
    symbol table. ``encoder_depth``, which etts reads and no module uses,
    is not read; ``ref_proj_dim`` stays 128, as etts never reads it."""
    from ..models.tacotron import Tacotron
    from ..text import keithito_symbols
    c = config
    return Tacotron(
        vocab_size=len(keithito_symbols),
        embed_depth=c.get("embed_depth", 256),
        attention_depth=c.get("attention_depth", 256),
        rnn_depth=c.get("rnn_depth", 256),
        num_mels=c["mel_channels"],
        num_freq=c.get("num_freq", 1025),
        outputs_per_step=c.get("outputs_per_step", 2),
        prenet_depths=tuple(c.get("prenet_depths", (256, 128))),
        use_gst=c.get("use_gst", True),
        num_gst=c.get("num_gst", 10),
        num_heads=c.get("num_heads", 4),
        style_embed_depth=c.get("style_embed_depth", 256),
        style_att_dim=c.get("style_att_dim", 128),
        style_att_type=c.get("style_att_type", "mlp_attention"),
        reference_filters=tuple(c.get("reference_filters",
                                      (32, 32, 64, 64, 128, 128))),
        reference_depth=c.get("reference_depth", 128),
        cbhg_width=c.get("cbhg_width", 128),
        max_iters=c.get("max_iters", 1000))
