"""Tiny configurations and traffic of the benchmark's cells, for runs on
the CPU: every width cut, the structure and the code paths kept."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _load(name):
    return json.loads((HERE / name).read_text())


def ar_config() -> dict:
    c = copy.deepcopy(_load("configs/ar_gst_wavernn.json"))
    a = c["files"]["autoregressive_config.yaml"]
    a.update(encoder_model_dimension=16, decoder_model_dimension=16,
             encoder_num_heads=[2, 2], decoder_num_heads=[2, 2],
             encoder_dense_blocks=2, decoder_dense_blocks=2,
             encoder_feed_forward_dimension=32,
             decoder_feed_forward_dimension=32, encoder_prenet_dimension=16,
             decoder_prenet_dimension=16, postnet_conv_filters=8,
             postnet_conv_layers=3, ref_encoder_filters=[4, 4, 8],
             ref_encoder_gru_cell_units=8, gst_style_embed_dim=8,
             gst_multi_num_heads=2, gst_heads=4, speaker_embed_dim=8)
    v = c["files"]["wavernn_config.yaml"]
    v.update(voc_rnn_dims=16, voc_fc_dims=16, voc_compute_dims=8,
             voc_res_out_dims=8, voc_res_blocks=1, voc_target=300,
             voc_overlap=40)
    c["files"]["data_config.yaml"]["mel_channels"] = 8
    return c


def fwd_config() -> dict:
    c = copy.deepcopy(_load("configs/forward_tts.json"))
    f = c["files"]["forward_config.yaml"]
    f.update(encoder_model_dimension=16, decoder_model_dimension=16,
             encoder_num_heads=[2, 2], decoder_num_heads=[2, 2],
             encoder_dense_blocks=2, decoder_dense_blocks=2,
             encoder_feed_forward_dimension=32,
             decoder_feed_forward_dimension=32, postnet_conv_filters=8,
             postnet_conv_layers=3, max_frames=64)
    c["files"]["data_config.yaml"]["mel_channels"] = 8
    return c


def bulk_traffic() -> dict:
    t = _load("traffic/bulk_b64.json")
    t.update(texts=3, tokens=[6, 12], max_length=60, ref_frames=16,
             trace_units=1)
    t["check"]["utterances"] = 2
    return t


def stream_traffic() -> dict:
    t = _load("traffic/stream_c2.json")
    t.update(max_lengths=[20, 40], tokens=[8, 6], ref_frames=16,
             trace_units=1)
    return t


def train_traffic() -> dict:
    t = _load("traffic/train_b16.json")
    t.update(batch=2, pool=4, frames=[20, 60], trace_units=2)
    return t
