"""High-level synthesis API (port of ``etts/api.py``): ``TTSSynthesizer``
(text + reference audio + speaker -> mel with the autoregressive model, or
text -> mel with the forward model), ``VocoderSynthesizer`` (mel ->
waveform) and ``TacotronSynthesizer`` (GST-Tacotron text + reference mel
-> waveform through Griffin-Lim), each loading a flat npz weight export
(the vocoder also a ``train_wavernn`` checkpoint), and the streamed
synthesis ``TTSSynthesizer.stream``. Each constructor
pins the checked float32 precision (``utils.precision``).

On the card both run their CUDA kernels: the fused decode for one text
when the model's geometry allows it (``can_fuse``), and the WaveRNN sample
loop in the mode that ``int8_weights`` picks (bf16, "int8" or "int8_mxu").
A batch of texts (``predict_many``) decodes through
``autoregressive_predict`` in plain PyTorch on the card, as the JAX package
decodes it outside any kernel. A failing kernel raises; nothing falls back
to another path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import load_into
from .models.autoregressive import autoregressive_predict
from .models.wavernn import generate, generate_batch
from .ops.audio import AudioProcessor
from .ops.griffin_lim import griffin_lim
from .ops.kernels.decoder_step import can_fuse, decode_weights, fused_decode
from .ops.normalizers import (db_to_amp, deemphasis, denormalize_db,
                              vocoder_mel)
from .text import text_to_sequence
from .utils.config import (ConfigManager, build_forward, build_tacotron,
                           build_tts, build_vocoder, load_config,
                           schedule_values, text_pipeline)
from .utils.precision import pin_float32

__all__ = ["TTSSynthesizer", "VocoderSynthesizer", "TacotronSynthesizer"]


def _style(gst_tokens, gst_attn) -> dict:
    """``encode``'s GST outputs as ``predict`` returns them: the dicts kept,
    their tensors as numpy."""
    numpy = lambda d: (None if d is None else
                       {k: v.detach().cpu().numpy() for k, v in d.items()})
    return {"gst_tokens": numpy(gst_tokens), "gst_attention": numpy(gst_attn)}


def _weight_dtype(device: torch.device):
    """bf16 matrices for the kernels on the card; float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _reject_forward_conditioning(ref_mel, spk_embed):
    """The forward model takes no style or speaker conditioning: refuse it
    rather than ignore it (`etts/api.py:150-161`)."""
    if ref_mel is not None or spk_embed is not None:
        raise ValueError(
            "forward-family models take no ref_mel/spk_embed conditioning "
            "(ForwardTransformer is text->mel only); use an autoregressive "
            "system_type for style/speaker control")


class TTSSynthesizer:
    """The TTS acoustic model of ``model_kind``: "autoregressive" (AR
    GST-TransformerTTS, text + reference mel + speaker -> mel, from
    ``autoregressive_config.yaml``) or "forward" (the duration model, text
    -> mel in one pass, from ``forward_config.yaml``).

    ``step`` is the training step of the weights, which fixes the reduction
    factor and prenet dropout through the config's schedules.
    ``phonemizer_backend`` overrides the config's ``phonemizer_backend``;
    one of the two must name it."""

    def __init__(self, config_dir, weights_npz, device="cuda", *,
                 step: int = 0, phonemizer_backend: Optional[str] = None,
                 model_kind: str = "autoregressive"):
        if model_kind not in ("autoregressive", "forward"):
            raise ValueError("model_kind must be autoregressive|forward, got "
                             f"{model_kind!r}")
        pin_float32()
        self.device = torch.device(device)
        self.model_kind = model_kind
        self.config = load_config(config_dir, model_kind)
        self.pipeline = text_pipeline(self.config, phonemizer_backend,
                                      model_kind)
        build = build_tts if model_kind == "autoregressive" else build_forward
        self.model = load_into(build(
            self.config, self.pipeline.tokenizer.vocab_size),
            weights_npz).to(self.device)
        sched = schedule_values(self.config, step)
        self.r = sched["reduction_factor"]
        self.prenet_dropout = sched["decoder_prenet_dropout"]
        self.audio = AudioProcessor(self.config)
        self.attn_stop_patience = self.config.get("attn_stop_patience")
        self.max_frames_per_token = self.config.get("max_frames_per_token")

    @property
    def mel_dtype(self) -> torch.dtype:
        """The dtype ``predict`` makes its mel in (it returns it as float32
        numpy): float32 from the fused decode, else the model's compute
        dtype. ``ops.normalizers.vocoder_mel`` takes it."""
        fused = self.model_kind == "autoregressive" and can_fuse(self.model)
        return torch.float32 if fused else self.model.dtype

    def encode_text(self, text: str) -> np.ndarray:
        return np.asarray(self.pipeline(text), np.int64)

    def mel_from_wav(self, wav) -> np.ndarray:
        """Reference wav -> normalized mel (t, n_mels), computed on the
        synthesizer's device."""
        wav = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)
        return self.audio.mel_spectrogram(wav).T.cpu().numpy()

    def _conditioning(self, ref_mel, spk_embed, n: int):
        """The encoder's reference and speaker inputs for n rows (the one
        reference and speaker tiled), or None where the system takes none."""
        m = self.model
        ref = spk = None
        if m.has_style:
            if ref_mel is None:
                raise ValueError(f"system_type={m.system_type!r} needs "
                                 "reference-style audio: pass ref_mel= "
                                 "(e.g. mel_from_wav(wav))")
            ref = m.encode_ref(torch.as_tensor(
                np.asarray(ref_mel, np.float32), device=self.device), self.r)
            ref = ref.repeat(n, 1, 1)
        if m.has_speaker:
            if spk_embed is None:
                raise ValueError(f"system_type={m.system_type!r} needs a "
                                 "speaker embedding: pass spk_embed=")
            spk = torch.as_tensor(np.asarray(spk_embed, np.float32),
                                  device=self.device).reshape(1, 1, -1)
            spk = spk.repeat(n, 1, 1)
        return ref, spk

    @torch.no_grad()
    def _decode(self, texts, ref_mel, spk_embed, max_length, seed,
                attn_stop_patience, max_frames_per_token):
        """Decode texts, their ids zero-padded to one length, in one batch:
        the fused kernel for one text where ``can_fuse`` allows it (as
        `etts/api.py:134` does), else ``autoregressive_predict`` with
        per-row stop tracking. Returns (list of mels (t_i, n_mels), steps,
        style): ``style`` holds ``encode``'s GST outputs for ``predict``,
        {"gst_tokens": {"GST_tokens": ...}, "gst_attention":
        {"gst_attention": ...}} as numpy, each None without a style
        encoder. Guards left at None take the config's values; 0 turns one
        off."""
        asp = (self.attn_stop_patience if attn_stop_patience is None
               else (attn_stop_patience or None))
        mft = (self.max_frames_per_token if max_frames_per_token is None
               else (max_frames_per_token or None))
        m = self.model
        seqs = [self.encode_text(t) for t in texts]
        inp = np.zeros((len(seqs), max(len(q) for q in seqs)), np.int64)
        for i, q in enumerate(seqs):
            inp[i, :len(q)] = q
        inp = torch.from_numpy(inp).to(self.device)
        ref, spk = self._conditioning(ref_mel, spk_embed, len(seqs))
        max_steps = int(max_length) // self.r + 1
        if len(seqs) == 1 and can_fuse(m):
            enc, _, _, gst_attn, gst_tokens, *_ = m.encode(inp, ref, spk)
            w = decode_weights(m, enc, self.r, _weight_dtype(self.device))
            mel, length, steps = fused_decode(
                w, max_steps=max_steps, prenet_dropout=self.prenet_dropout,
                seed=seed, attn_stop_patience=asp, max_frames_per_token=mft)
            return ([mel[:length].cpu().numpy()], steps,
                    _style(gst_tokens, gst_attn))
        gen = torch.Generator(self.device).manual_seed(seed)
        out = autoregressive_predict(
            m, inp, ref, spk, r=self.r, max_length=max_length,
            prenet_dropout=self.prenet_dropout, attn_stop_patience=asp,
            max_frames_per_token=mft, generator=gen)
        mel = out["mel"].float().cpu().numpy()
        lengths = out["mel_lengths"].tolist()
        return ([mel[i, :n] for i, n in enumerate(lengths)], out["steps"],
                _style(out["gst_tokens"], out["gst_encoder_attention"]))

    @torch.no_grad()
    def _forward_mel(self, text, speed_regulator: float) -> torch.Tensor:
        """The forward model's mel (t, n_mels) on the device: one pass at
        the config's ``max_frames`` capacity (1280 by default), durations
        scaled by 1 / ``speed_regulator``, cut to the regulated length
        (`etts/api.py:166-175`)."""
        ids = torch.from_numpy(self.encode_text(text))[None].to(self.device)
        out = self.model(ids, max_frames=int(self.config.get("max_frames",
                                                             1280)),
                         durations_scalar=1.0 / speed_regulator)
        return out["mel"][0, :int(out["mel_lengths"][0])]

    def _autoregressive_only(self, name: str):
        if self.model_kind != "autoregressive":
            raise ValueError(f"{name} runs the autoregressive model only, "
                             "as etts' does")

    def predict(self, text, ref_mel=None, spk_embed=None, max_length=1000,
                seed: int = 0, attn_stop_patience=None,
                max_frames_per_token=None,
                speed_regulator: float = 1.0) -> dict:
        """-> {'mel': (t, n_mels) in [-4, 4], 'steps': decode steps run,
        'gst_tokens': {'GST_tokens': the style-token parameters},
        'gst_attention': {'gst_attention': this reference's token-bank
        attention (1, heads, 1, tokens)}}, as `etts/api.py:186-191`; the
        last two None without a style encoder. Guards left at None take the
        config's values; 0 turns one off.

        The forward model returns {'mel'} alone, refuses ``ref_mel`` and
        ``spk_embed``, ignores ``max_length``, the seed and the guards, and
        divides its durations by ``speed_regulator``."""
        if self.model_kind == "forward":
            _reject_forward_conditioning(ref_mel, spk_embed)
            return {"mel": self._forward_mel(
                text, speed_regulator).float().cpu().numpy()}
        mels, steps, style = self._decode([text], ref_mel, spk_embed,
                                          max_length, seed,
                                          attn_stop_patience,
                                          max_frames_per_token)
        return {"mel": mels[0], "steps": steps, **style}

    def predict_many(self, texts, ref_mel=None, spk_embed=None,
                     max_length=1000, seed: int = 0, attn_stop_patience=None,
                     max_frames_per_token=None) -> list:
        """Several texts in one decode (the serving path,
        `etts/api.py:193-217`): ids zero-padded to a common length, the
        reference encoded once and tiled with the speaker, one decode over
        the batch with per-row stop tracking. Returns a list of mels
        (t_i, n_mels) in [-4, 4]."""
        self._autoregressive_only("predict_many")
        return self._decode(list(texts), ref_mel, spk_embed, max_length,
                            seed, attn_stop_patience, max_frames_per_token)[0]

    # -- streaming ----------------------------------------------------------

    def _stream_inputs(self, text, ref_mel, spk_embed):
        """One text's ids (1, n) and its encoder conditioning on the device."""
        inp = torch.from_numpy(self.encode_text(text))[None].to(self.device)
        return (inp, *self._conditioning(ref_mel, spk_embed, 1))

    def stream_mels(self, text, ref_mel=None, spk_embed=None, *,
                    mel_chunk: int = 40, max_length: int = 1000,
                    seed: int = 0):
        """Yield mel chunks (t_i, n_mels) in [-4, 4], numpy, as they decode:
        ``streaming.stream_mel`` with the plain chunked decode
        (`etts/api.py:249-257`), the dropout's generator seeded with
        ``seed`` on the device. Like etts' stream, it applies no runaway
        guard."""
        from .streaming import stream_mel
        self._autoregressive_only("stream_mels")
        inp, ref, spk = self._stream_inputs(text, ref_mel, spk_embed)
        yield from stream_mel(
            self.model, inp, ref, spk, chunk=mel_chunk, r=self.r,
            max_length=max_length, prenet_dropout=self.prenet_dropout,
            generator=torch.Generator(self.device).manual_seed(seed))

    def stream(self, text, vocoder: "VocoderSynthesizer", ref_mel=None,
               spk_embed=None, *, mel_chunk: int = 40, max_length: int = 1000,
               seed: int = 0, int8_weights=None):
        """Yield waveform chunks of mel_chunk * r * hop samples, numpy, end
        to end (`etts/api.py:259-290`): ``streaming.stream_synthesize``,
        the decode seeded with ``seed`` and the sample loop with seed + 1.
        Mu-law and the weight mode come from ``vocoder`` as its
        ``generate`` takes them; any int8 flag, "mxu" included, runs the
        "int8" sample loop, as etts' stream does.

        The forward model (`etts/api.py:271-283`) makes its whole mel in one
        pass (``predict``'s, ``max_length`` ignored), then vocodes
        (mel + 4) / 8 in chunks of ``mel_chunk`` frames through
        ``streaming.stream_vocode``, the sample loop seeded with seed + 1,
        so the first audio waits for one vocoder chunk after the pass."""
        from .streaming import stream_synthesize, stream_vocode
        int8 = bool(vocoder._int8(int8_weights))
        mu_law = vocoder._pick(None, "mu_law", True)
        weights = vocoder._loop_args(int8)["weights"]
        if self.model_kind == "forward":
            _reject_forward_conditioning(ref_mel, spk_embed)
            mel = self._forward_mel(text, 1.0)
            mel = vocoder_mel(mel, mel.dtype)
            yield from stream_vocode(
                vocoder.model, (mel[i:i + mel_chunk]
                                for i in range(0, mel.shape[0], mel_chunk)),
                chunk_frames=mel_chunk, mu_law=mu_law, seed=seed + 1,
                int8_weights=int8, weights=weights)
            return
        inp, ref, spk = self._stream_inputs(text, ref_mel, spk_embed)
        yield from stream_synthesize(
            self.model, vocoder.model, inp, ref, spk, r=self.r,
            max_length=max_length, mel_chunk=mel_chunk,
            prenet_dropout=self.prenet_dropout, mu_law=mu_law,
            int8_weights=int8, seed=seed, voc_weights=weights)


class VocoderSynthesizer:
    """Batch-folded WaveRNN vocoder (reference `synthesizer_wavernn.py`).

    ``int8_weights`` (per call, else the config key ``voc_int8_weights``):
    True runs the "int8" sample loop, "mxu" the "int8_mxu" one, falsy the
    bf16 one. The int8 weights are quantized from the float32 parameters at
    their first use and kept; both int8 modes share them.

    The weights come from the flat npz ``weights_npz`` (or such a dict),
    or, where it is None, from a training session of ``train_wavernn``
    (`etts/api.py:296-312`): the checkpoint ``ckpt-{checkpoint}.pt`` (the
    latest where None) of session ``session_name`` under the config's
    ``log_directory``, its BatchNorm running statistics with it."""

    def __init__(self, config_dir, weights_npz=None, device="cuda", *,
                 session_name: Optional[str] = None,
                 checkpoint: Optional[int] = None):
        pin_float32()
        self.device = torch.device(device)
        if weights_npz is None:
            cm = ConfigManager(config_dir, "wavernn", session_name)
            self.config = cm.config
            self.model = cm.load_model(checkpoint, self.device)[0]
        else:
            self.config = load_config(config_dir, "wavernn")
            self.model = load_into(build_vocoder(self.config),
                                   weights_npz).to(self.device)
        self.weights = self.model.sample_weights(_weight_dtype(self.device))
        self._int8_weights = None

    def _int8(self, override):
        """True -> int8 dequant path; "mxu" -> int8 x int8 products
        (``models.wavernn._int8_dtype``); falsy -> bf16
        (`etts/api.py:348-353`)."""
        v = (override if override is not None
             else self.config.get("voc_int8_weights", False))
        return v if v == "mxu" else bool(v)

    def _loop_args(self, int8_weights) -> dict:
        flag = self._int8(int8_weights)
        if not flag:
            return {"int8_weights": False, "weights": self.weights}
        if self._int8_weights is None:
            self._int8_weights = self.model.int8_sample_weights()
        return {"int8_weights": flag, "weights": self._int8_weights}

    def _pick(self, v, key, default):
        return self.config.get(key, default) if v is None else v

    @torch.no_grad()
    def generate(self, mel, batched=None, target=None, overlap=None,
                 mu_law=None, seed: int = 0, int8_weights=None) -> np.ndarray:
        """mel (t, n_mels) in the vocoder's [0, 1] convention -> waveform of
        (t - 1) * hop samples."""
        wav = generate(
            self.model, torch.as_tensor(np.asarray(mel, np.float32),
                                        device=self.device),
            batched=self._pick(batched, "voc_gen_batched", True),
            target=self._pick(target, "voc_target", 11000),
            overlap=self._pick(overlap, "voc_overlap", 550),
            mu_law=self._pick(mu_law, "mu_law", True), seed=seed,
            **self._loop_args(int8_weights))
        return wav.cpu().numpy()

    @torch.no_grad()
    def generate_many(self, mels, target=None, overlap=None, mu_law=None,
                      seed: int = 0, int8_weights=None) -> list:
        """Vocode a list of mels in one sample-loop launch (serving
        throughput: all utterances' fold rows share the loop)."""
        wavs = generate_batch(
            self.model, [torch.as_tensor(np.asarray(m, np.float32),
                                         device=self.device) for m in mels],
            target=self._pick(target, "voc_target", 11000),
            overlap=self._pick(overlap, "voc_overlap", 550),
            mu_law=self._pick(mu_law, "mu_law", True), seed=seed,
            **self._loop_args(int8_weights))
        return [w.cpu().numpy() for w in wavs]


class TacotronSynthesizer:
    """GST-Tacotron text (+ reference mel) -> waveform through its linear
    spectrogram (`etts/api.py:356-406`): keithito text ids, one
    ``Tacotron.generate`` of the config's ``max_iters`` steps on the
    device, then dB denormalisation, the power raise, Griffin-Lim and
    de-emphasis on the device."""

    def __init__(self, config_dir, weights_npz, device="cuda"):
        pin_float32()
        self.device = torch.device(device)
        self.config = load_config(config_dir, "tacotron")
        self.model = load_into(build_tacotron(self.config),
                               weights_npz).to(self.device)

    @property
    def mel_dtype(self) -> torch.dtype:
        """The dtype ``predict`` makes its mel in (it returns it as float32
        numpy): float32 from the fused decode, else the model's compute
        dtype. ``ops.normalizers.vocoder_mel`` takes it."""
        fused = self.model_kind == "autoregressive" and can_fuse(self.model)
        return torch.float32 if fused else self.model.dtype

    def encode_text(self, text: str) -> np.ndarray:
        return np.asarray(text_to_sequence(
            text, [self.config.get("cleaners", "english_cleaners")]),
            np.int64)

    @torch.no_grad()
    def synthesize(self, text, reference_mel=None, seed: int = 0):
        """-> (wav ((max_iters * r - 1) * hop,), alignment (max_iters, n
        ids)), numpy. ``reference_mel`` (t, num_mels) in [0, 1], numpy or
        a tensor (``data.taco_audio.taco_linear_and_mel``'s mel); without
        it the style is a random mix of the tokens. ``seed`` seeds the
        prenets' dropout and that mix (``Tacotron.draw_uniforms``)."""
        seq = self.encode_text(text)
        ids = torch.from_numpy(seq)[None].to(self.device)
        ref = (None if reference_mel is None else torch.as_tensor(
            reference_mel, dtype=torch.float32, device=self.device)[None])
        out = self.model.generate(
            ids, torch.tensor([len(seq)], device=self.device), ref,
            seed=seed)
        wav = self._inv_linear(out["linear_outputs"][0])
        return wav.cpu().numpy(), out["alignments"][0].cpu().numpy()

    def _inv_linear(self, linear):
        """Linear spectrogram (t, num_freq) in [0, 1] -> waveform."""
        c = self.config
        S = denormalize_db(linear.T, c.get("min_level_db", -100))
        mag = db_to_amp(S + c.get("ref_level_db", 20)) ** c.get("power", 1.5)
        wav = griffin_lim(mag, c["n_fft"], c["hop_length"], c["win_length"],
                          n_iter=c.get("griffin_lim_iters", 60))
        return deemphasis(wav, c.get("preemphasis", 0.97))
