"""Multi-speaker, multi-regime synthesis (port of
``synthesize_sentences_speaker.py``).

    python -m etts_torch.synthesize_speaker --tts_config DIR \\
        --tts_weights ar.npz --tts_step 14000 \\
        [--voc_config DIR --voc_weights voc.npz] \\
        --test_sentences test_metafile.txt --ref_audio_dir wavs \\
        --spk_embed_dir spk_embeds [--combo_file combos.txt] \\
        [--regimes syn_norm rand text_rand style_rand] \\
        [--phonemizer_backend grapheme] [--out_dir synth_speaker_out] \\
        [--max_length 1000] [--seed 0] [--attn_stop_patience N] \\
        [--frames_per_token F] [--int8] [--save_mels] [--device cuda|cpu]

Four regimes over ``text_id|style_id|speaker_id`` rows (a combo file, else
each test sentence's own id three times): ``syn_norm`` (each sentence with
its own reference audio and speaker), ``rand`` (the combo file's random
triples), ``text_rand`` (a random row's text, the row's style and
speaker), ``style_rand`` (a random row's style). A row's text comes from
``--test_sentences`` (id|text|...), its style from
``<ref_audio_dir>/<style_id>.wav``, its speaker from
``<spk_embed_dir>/<speaker_id>.npy``. Writes
``<out_dir>/<regime>/<text>__<style>__<speaker>.wav`` (16-bit PCM),
vocoded by the WaveRNN export (``--int8``: the int8 sample loop) or, with
no vocoder, by Griffin-Lim (32 iterations); ``--save_mels`` writes each
mel ((t, n_mels) in [-4, 4]) as ``.npy`` instead. A flat npz export and its
training step replace etts' sessions; the lax.scan vocoder loop
(``--voc_scan``) has no counterpart.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

REGIMES = ("syn_norm", "rand", "text_rand", "style_rand")


def read_combos(path):
    combos = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 3:
                combos.append(tuple(parts[:3]))
    return combos


def read_sentences(path) -> dict:
    """{id: text} of an id|text[|...] metafile."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tts_config", required=True)
    p.add_argument("--tts_weights", required=True, help="flat npz export")
    p.add_argument("--tts_step", type=int, default=0,
                   help="training step of the TTS weights (sets r and the "
                        "prenet dropout from the config's schedules)")
    p.add_argument("--voc_config", default=None)
    p.add_argument("--voc_weights", default=None, help="flat npz export")
    p.add_argument("--test_sentences", required=True,
                   help="metafile id|text|phonemes of the test sentences")
    p.add_argument("--combo_file", default=None,
                   help="text_id|style_id|speaker_id combos for the random "
                        "regimes")
    p.add_argument("--ref_audio_dir", required=True,
                   help="dir with <style_id>.wav reference audio")
    p.add_argument("--spk_embed_dir", required=True,
                   help="dir with <speaker_id>.npy d-vectors")
    p.add_argument("--regimes", nargs="*", default=["syn_norm"],
                   choices=list(REGIMES))
    p.add_argument("--phonemizer_backend", default=None,
                   choices=["espeak", "grapheme", "rule"])
    p.add_argument("--out_dir", default="synth_speaker_out")
    p.add_argument("--max_length", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attn_stop_patience", type=int, default=None,
                   help="decode-time runaway guard: stop after N steps of "
                        "cross-attention focus on the final token")
    p.add_argument("--frames_per_token", type=float, default=None,
                   help="decode-time runaway guard: cap output at F frames "
                        "per input token")
    p.add_argument("--int8", action="store_true",
                   help="int8 vocoder sample-loop weights")
    p.add_argument("--save_mels", action="store_true",
                   help="save each mel as <name>.npy ((t, n_mels) in "
                        "[-4, 4]) instead of a wav")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if (a.voc_config is None) != (a.voc_weights is None):
        p.error("give --voc_config and --voc_weights together, or neither "
                "for Griffin-Lim")

    import torch

    from .api import TTSSynthesizer, VocoderSynthesizer
    from .data.audio_io import load_wav, save_wav
    from .ops.normalizers import vocoder_mel
    tts = TTSSynthesizer(a.tts_config, a.tts_weights, a.device,
                         step=a.tts_step,
                         phonemizer_backend=a.phonemizer_backend)
    voc = (VocoderSynthesizer(a.voc_config, a.voc_weights, a.device)
           if a.voc_config and not a.save_mels else None)
    sentences = read_sentences(a.test_sentences)
    combos = (read_combos(a.combo_file) if a.combo_file
              else [(k, k, k) for k in sentences])
    rng = np.random.default_rng(a.seed)
    sr = tts.config["sampling_rate"]
    for regime in a.regimes:
        out_dir = Path(a.out_dir) / regime
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, (text_id, style_id, spk_id) in enumerate(combos):
            if regime == "syn_norm":
                # all conditioning from the target utterance itself
                style_id = spk_id = text_id
            elif regime == "text_rand":
                text_id = combos[rng.integers(len(combos))][0]
            elif regime == "style_rand":
                style_id = combos[rng.integers(len(combos))][1]
            text = sentences.get(text_id)
            if text is None:
                continue
            ref_mel = spk = None
            if tts.model.has_style:
                wav_path = Path(a.ref_audio_dir) / f"{style_id}.wav"
                if not wav_path.exists():
                    continue
                ref_mel = tts.mel_from_wav(load_wav(str(wav_path), sr)[0])
            if tts.model.has_speaker:
                spk_path = Path(a.spk_embed_dir) / f"{spk_id}.npy"
                if not spk_path.exists():
                    continue
                spk = np.load(spk_path)
            mel = tts.predict(text, ref_mel, spk, max_length=a.max_length,
                              seed=a.seed + i,
                              attn_stop_patience=a.attn_stop_patience,
                              max_frames_per_token=a.frames_per_token)["mel"]
            name = f"{text_id}__{style_id}__{spk_id}"
            if a.save_mels:
                np.save(out_dir / f"{name}.npy", mel)
                print(f"[{regime}] {name} ({mel.shape[0]}f, mel saved)",
                      flush=True)
                continue
            if voc is not None:
                wav = voc.generate(
                    vocoder_mel(torch.from_numpy(mel), tts.mel_dtype).numpy(),
                    seed=a.seed + i, int8_weights=a.int8 or None)
            else:
                wav = tts.audio.reconstruct_waveform(
                    torch.from_numpy(mel.T).to(tts.device), n_iter=32)
                wav = wav.cpu().numpy()
            save_wav(wav, out_dir / f"{name}.wav", sr)
            print(f"[{regime}] {name} ({mel.shape[0]}f)", flush=True)
    print("Done.")


if __name__ == "__main__":
    main()
