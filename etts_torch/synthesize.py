"""Text + reference audio (+ speaker d-vector) -> wav, TTS and vocoder in one
process (counterpart of ``synthesize_sentences.py``).

    python -m etts_torch.synthesize --tts_config configs/default \\
        --tts_weights artifacts/soak/ar_best_14k_params_fp16.npz --tts_step 14000 \\
        --voc_config configs/default \\
        --voc_weights artifacts/soak/voc_gta26k_params_fp16.npz \\
        --ref_wav ref.wav --spk_embed spk.npy --phonemizer_backend grapheme \\
        --sentences "Scientists say they have discovered a new particle."

Writes ``<out_dir>/<i>.wav`` (16-bit PCM) and ``<out_dir>/<i>_mel.npy``
((t, n_mels) in [-4, 4]) per sentence.
"""
from __future__ import annotations

import argparse
import wave
from pathlib import Path

import numpy as np


def read_wav(path, sample_rate: int) -> np.ndarray:
    """16-bit PCM wav -> float32 mono in [-1, 1]; the rate must match."""
    with wave.open(str(path), "rb") as f:
        if f.getframerate() != sample_rate:
            raise ValueError(f"{path}: {f.getframerate()} Hz, the model "
                             f"expects {sample_rate} Hz")
        if f.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM is read")
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        data = data.reshape(-1, f.getnchannels()).mean(1)
    return (data / 32768.0).astype(np.float32)


def write_wav(path, wav: np.ndarray, sample_rate: int) -> None:
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tts_config", required=True)
    p.add_argument("--tts_weights", required=True, help="flat npz export")
    p.add_argument("--tts_step", type=int, default=0,
                   help="training step of the TTS weights (sets r and the "
                        "prenet dropout from the config's schedules)")
    p.add_argument("--voc_config", required=True)
    p.add_argument("--voc_weights", required=True, help="flat npz export")
    p.add_argument("--sentences", nargs="+", required=True)
    p.add_argument("--ref_wav", default=None, help="reference-style audio")
    p.add_argument("--spk_embed", default=None, help="speaker d-vector .npy")
    p.add_argument("--phonemizer_backend", default=None,
                   choices=["espeak", "grapheme", "rule"])
    p.add_argument("--out_dir", default="synth_out")
    p.add_argument("--max_length", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attn_stop_patience", type=int, default=None)
    p.add_argument("--frames_per_token", type=float, default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from .api import TTSSynthesizer, VocoderSynthesizer
    tts = TTSSynthesizer(a.tts_config, a.tts_weights, a.device,
                         step=a.tts_step,
                         phonemizer_backend=a.phonemizer_backend)
    voc = VocoderSynthesizer(a.voc_config, a.voc_weights, a.device)
    sr = tts.config["sampling_rate"]
    ref_mel = (tts.mel_from_wav(read_wav(a.ref_wav, sr))
               if a.ref_wav else None)
    spk = np.load(a.spk_embed) if a.spk_embed else None
    out = Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, sentence in enumerate(a.sentences):
        mel = tts.predict(sentence, ref_mel, spk, max_length=a.max_length,
                          seed=a.seed + i,
                          attn_stop_patience=a.attn_stop_patience,
                          max_frames_per_token=a.frames_per_token)["mel"]
        wav = voc.generate((mel + 4.0) / 8.0, seed=a.seed + i)
        write_wav(out / f"{i}.wav", wav, sr)
        np.save(out / f"{i}_mel.npy", mel)
        print(f"{i}: {sentence!r} -> {mel.shape[0]} frames, "
              f"{wav.shape[0] / sr:.2f} s")


if __name__ == "__main__":
    main()
