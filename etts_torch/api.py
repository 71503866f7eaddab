"""High-level synthesis API (port of ``etts/api.py``): ``TTSSynthesizer``
(text + reference audio + speaker -> mel) and ``VocoderSynthesizer``
(mel -> waveform), both loading the flat npz weight exports.

On the card both run their CUDA kernels: the fused decode when the model's
geometry allows it (``can_fuse``), and the WaveRNN sample loop. A failing
kernel raises; nothing falls back to another path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import load_into
from .models.autoregressive import autoregressive_predict
from .models.wavernn import generate
from .ops.audio import AudioProcessor
from .ops.kernels.decoder_step import can_fuse, decode_weights, fused_decode
from .utils.config import (build_tts, build_vocoder, load_config,
                           schedule_values, text_pipeline)

__all__ = ["TTSSynthesizer", "VocoderSynthesizer"]


def _weight_dtype(device: torch.device):
    """bf16 matrices for the kernels on the card; float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class TTSSynthesizer:
    """AR GST-TransformerTTS: text + reference mel + speaker -> mel.

    ``step`` is the training step of the weights, which fixes the reduction
    factor and prenet dropout through the config's schedules.
    ``phonemizer_backend`` overrides the config's ``phonemizer_backend``;
    one of the two must name it."""

    def __init__(self, config_dir, weights_npz, device="cuda", *,
                 step: int = 0, phonemizer_backend: Optional[str] = None):
        self.device = torch.device(device)
        self.config = load_config(config_dir, "autoregressive")
        self.pipeline = text_pipeline(self.config, phonemizer_backend)
        self.model = load_into(build_tts(
            self.config, self.pipeline.tokenizer.vocab_size),
            weights_npz).to(self.device)
        sched = schedule_values(self.config, step)
        self.r = sched["reduction_factor"]
        self.prenet_dropout = sched["decoder_prenet_dropout"]
        self.audio = AudioProcessor(self.config)
        self.attn_stop_patience = self.config.get("attn_stop_patience")
        self.max_frames_per_token = self.config.get("max_frames_per_token")

    def encode_text(self, text: str) -> np.ndarray:
        return np.asarray(self.pipeline(text), np.int64)

    def mel_from_wav(self, wav) -> np.ndarray:
        """Reference wav -> normalized mel (t, n_mels)."""
        return self.audio.mel_spectrogram(wav).T.numpy()

    @torch.no_grad()
    def predict(self, text, ref_mel=None, spk_embed=None, max_length=1000,
                seed: int = 0, attn_stop_patience=None,
                max_frames_per_token=None) -> dict:
        """-> {'mel': (t, n_mels) in [-4, 4], 'steps': decode steps run}.
        Guards left at None take the config's values; 0 turns one off."""
        asp = (self.attn_stop_patience if attn_stop_patience is None
               else (attn_stop_patience or None))
        mft = (self.max_frames_per_token if max_frames_per_token is None
               else (max_frames_per_token or None))
        m = self.model
        inp = torch.from_numpy(self.encode_text(text))[None].to(self.device)
        ref = spk = None
        if m.has_style:
            if ref_mel is None:
                raise ValueError(f"system_type={m.system_type!r} needs "
                                 "reference-style audio: pass ref_mel= "
                                 "(e.g. mel_from_wav(wav))")
            ref = m.encode_ref(torch.as_tensor(
                np.asarray(ref_mel, np.float32), device=self.device), self.r)
        if m.has_speaker:
            if spk_embed is None:
                raise ValueError(f"system_type={m.system_type!r} needs a "
                                 "speaker embedding: pass spk_embed=")
            spk = torch.as_tensor(np.asarray(spk_embed, np.float32),
                                  device=self.device).reshape(1, 1, -1)
        max_steps = int(max_length) // self.r + 1
        if can_fuse(m):
            enc, _ = m.encode(inp, ref, spk)
            w = decode_weights(m, enc, self.r, _weight_dtype(self.device))
            mel, length, steps = fused_decode(
                w, max_steps=max_steps, prenet_dropout=self.prenet_dropout,
                seed=seed, attn_stop_patience=asp, max_frames_per_token=mft)
            return {"mel": mel[:length].cpu().numpy(), "steps": steps}
        gen = torch.Generator(self.device).manual_seed(seed)
        out = autoregressive_predict(
            m, inp, ref, spk, r=self.r, max_length=max_length,
            prenet_dropout=self.prenet_dropout, attn_stop_patience=asp,
            max_frames_per_token=mft, generator=gen)
        return {"mel": out["mel"][0, :out["mel_length"]].cpu().numpy(),
                "steps": out["steps"]}


class VocoderSynthesizer:
    """Batch-folded WaveRNN vocoder (reference `synthesizer_wavernn.py`)."""

    def __init__(self, config_dir, weights_npz, device="cuda"):
        self.device = torch.device(device)
        self.config = load_config(config_dir, "wavernn")
        self.model = load_into(build_vocoder(self.config),
                               weights_npz).to(self.device)
        self.weights = self.model.sample_weights(_weight_dtype(self.device))

    @torch.no_grad()
    def generate(self, mel, batched=None, target=None, overlap=None,
                 mu_law=None, seed: int = 0) -> np.ndarray:
        """mel (t, n_mels) in the vocoder's [0, 1] convention -> waveform of
        (t - 1) * hop samples."""
        c = self.config
        pick = lambda v, key, default: c.get(key, default) if v is None else v
        wav = generate(
            self.model, torch.as_tensor(np.asarray(mel, np.float32),
                                        device=self.device),
            batched=pick(batched, "voc_gen_batched", True),
            target=pick(target, "voc_target", 11000),
            overlap=pick(overlap, "voc_overlap", 550),
            mu_law=pick(mu_law, "mu_law", True), seed=seed,
            weights=self.weights)
        return wav.cpu().numpy()
