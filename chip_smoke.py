#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``etts_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build the CUDA kernels (one
     nvcc per source and variant, started together: the fused decode as
     one cluster of blocks, its timer build and its build at the other
     cluster size, and the sample loop in its bf16, int8 and int8_mxu
     modes); print the decode's cluster size;
  2. fused AR decode kernel against its plain version at flagship width on
     the 14k-step export (r = 10): dropout 0, dropout 0.5 with shared
     uniforms, and three cases that must stop early, on copies of the
     weights where needed: a frame cap inside a group, the
     attention-completion stop, and the stop class first firing inside a
     group; and at r = 1 (the schedule's late reduction factor), 300
     steps with dropout 0.5 and shared uniforms, a self-attention cache
     longer than the encoder output; each case at the built cluster size
     and at the other one;
  3. the bf16 WaveRNN sample-loop kernel (a tile of fold rows per block on
     tensor cores) against its plain version on conditioning from the
     26k-step export, B in {1, 5, 11, 16, 17, 33} (the tile edges), T >=
     2000, with shared uniforms, each B with its rows per block and block
     count; one step at a time from the same state, against the plain
     version with exact (float64) sums: the float32 state the step leaves
     within STATE_TOL, and peaky RAW's share of argmax picks equal to the
     exact sums' no worse than the float32 plain version's by more than
     PEAKY_MARGIN (a float32-activation control printed beside); a chunked
     run with state carry against a one-shot run, bit for bit;
  3b. the int8 and int8_mxu sample-loop kernels (the same tile on int8
     weights: int8 x int8 products with activations quantized per row, or
     int8 weights turned into bf16) against their plain versions on seeded
     weights at flagship width, MOL and RAW 512, B in {1, 5, 11, 17}, T >=
     2000, shared uniforms: int8_mxu (exact sums) within STEP_TOL on
     STEP_AGREE of the steps; int8 as phase 3 holds the bf16 kernel, and
     one step from the same state against exact sums with its own bars
     (STATE_TOL_INT8, PEAKY_MARGIN_INT8) and control; chunked against
     one-shot in both modes;
  4. the main path text + reference wav -> wav through TTSSynthesizer and
     VocoderSynthesizer, with both kernels' launch counts read around it;
  5. times (CUDA events), bounds, the plain versions' times, decode ms per
     step at r = 10 and at r = 1 (1001 steps), at the built cluster size
     and at the other one (the two held together within DECODE_TOL), and
     the end-to-end real-time factor, each beside
     the card; the decode's step split phase by phase by the kernel's timer
     build (a separate library); the
     sample loop is also held against its plain version at the main path's
     shapes there, on the run that times the plain version, with the
     float32-activation computation read as a control;
  6. the serving path: TTSSynthesizer.predict_many on 8 texts, then
     VocoderSynthesizer.generate_many once per weight mode (bf16, int8,
     int8_mxu), each kernel's launches read around its call; times, the
     batch real-time factor, and each kernel alone at the serving shapes
     and at the SM count of rows, each int8 kernel held against its plain
     version there;
  7. the streamed path: TTSSynthesizer.stream (the plain chunked decode in
     chunks of STREAM_CHUNK steps, 0.5 s of audio a vocoder chunk) with
     bf16 weights, and with int8_weights="mxu", which runs the "int8" loop;
     each kernel's launches read around each stream (one a vocoder chunk
     in the mode used, none in the others, no fused decode); the streamed
     mel against autoregressive_predict with the same seed (bit for bit),
     each chunk's conditioning against the whole utterance's (STREAM_COND
     relative), and the streamed samples against one launch over the
     chunks' conditioning (bit for bit); the time to first audio (best of
     3), each later chunk's time, the stream's real-time factor, the sample
     loop's time a step at one row, and the plain chunked decode's time a
     step; then Griffin-Lim (reconstruct_waveform, 32 iterations) on phase
     4's mel;
  8. the forward path: a forward model at configs/default's widths on
     seeded weights (forward_phase), text -> mel -> wav through
     TTSSynthesizer.predict and VocoderSynthesizer.generate with the
     launches read around it; the mel on the card against the CPU within
     FWD_TOL; the sample loop at the path's shapes against its plain
     version (phase 3's bar) on the vocoder's weights and on seeded MOL
     weights; TTSSynthesizer.stream in bf16 and int8 (one launch a chunk,
     the samples against one launch over the chunks' conditioning, bit for
     bit, and the second chunk at one row against the plain version from
     the first chunk's state, on seeded weights); then a conv-decoder AR
     model with prosody statistics: no fused decode, its chunked
     stream_mels against autoregressive_predict, bit for bit;
  9. training (train_phase): configs/default's AR model at full width and
     depth with the MINE zoo, on a seeded corpus the phase writes; one
     train step on the card against the CPU from the same init and batch
     (TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL); the driver
     ``python -m etts_torch.train_autoregressive`` (its ``main``, in this
     process) for 20 steps, then resumed to 30; its step and zoo times, target frames a second and
     peak memory; the trained BatchNorm statistics moved; the step-30
     weights exported and served through TTSSynthesizer: one fused decode
     launch, its mel within DECODE_TOL of the plain decode;
  10. GST-Tacotron (tacotron_phase): TacotronSynthesizer at configs/default's
     full width on seeded weights, text + the reference wav's mel -> wav
     through all 1000 decode steps, 60 Griffin-Lim iterations and
     de-emphasis, launches read around it (none of the port's kernels);
     held against the same code on the CPU (TACO_* bars): the reference
     mel, the encoder output, every decode step teacher-fed from the CPU
     run, the head, the wav after 2 Griffin-Lim iterations and
     de-emphasis, de-emphasis alone, a stop inside the run, the random
     style without a reference; the free-running decode's first step past
     the bar printed; times and the real-time factor;
  11. the forward model's training (forward_train_phase): the AR model
     trained to r = 1 on phase 9's corpus, ``python -m
     etts_torch.extract_durations`` (triple counts, duration sums, card
     against CPU), one forward train step card against CPU (float64 at
     the FT_* bars, float32 at phase 9's) and its split, ``python -m
     etts_torch.train_forward`` for 20 steps and resumed to 30 against
     one run of 30 (each entry point's ``main``, in this process), and
     the step-30 export
     through TTSSynthesizer(model_kind="forward") and the bf16 sample
     loop (launches read around it, the call held against its plain
     version); times, peak memory and the real-time factor;
  12. the vocoder's training flow (vocoder_train_phase): seeded wavs
     through ``python -m etts_torch.preprocess_wavernn``; one WaveRNN
     train step card against CPU in MOL and RAW (float64 at the FT_*
     bars; float32 the loss) and its split; the float32 step at batch 64
     against the card's float64 step on the card and the CPU, two crop
     draws, its TF32 control rejected;
     ``python -m etts_torch.train_wavernn`` at configs/default's full
     width and batch 64 for 20 steps, resumed to 30 (the batches against
     the permutation stream); the last export, with its BatchNorm
     statistics, through VocoderSynthesizer and B1 (one launch; the
     share of saturated samples beside the 26k export's; B1 one step at
     a time against exact sums, its float32-activation control
     rejected);
     ``gen_wavernn``; ``make_gta`` on phase 11's r = 1 session (card
     against CPU) and ``train_wavernn --gta``; two runs under
     deterministic algorithms in processes of their own, held bit for
     bit;
  13. the TTS stores and GST-Tacotron's training (taco_train_phase): 48
     seeded wavs in the LJSpeech layout through ``python -m
     etts_torch.create_dataset`` and ``build_tacotron_dataset``, card
     against CPU; ``train_autoregressive`` a few steps on the AR store;
     one full-width Tacotron train step card against CPU (float64 at the
     FT_* bars; float32 on the card and the CPU against the card's
     float64 within TT_F32_GRAD, its TF32 control rejected) and its split;
     ``python -m etts_torch.train_tacotron`` at configs/default's full
     width (batch 8, r = 2) for 20 steps, resumed to 30 (the batches
     against the permutation stream); the last export through
     TacotronSynthesizer (launches read around it: none); two runs under
     deterministic algorithms, one cut and resumed, held bit for bit;
  14. ``precision: bfloat16`` (bf16_phase): the 14k export in the bf16
     model through the fused decode and B1 (against its plain bf16 decode
     on the card, the float32 model's distance the control), its RTF,
     ``predict_many`` and a stream; the forward model at 1280 frames, bf16
     against float32; ``train_autoregressive`` in bf16 with
     ``--profile_dir`` and Griffin-Lim prediction audio, and
     ``train_forward`` in bf16, beside phases 9's and 11's float32 runs;
     one AR and one forward bf16 step, card against CPU;
  15. the evaluation suite (eval_phase) on the corpus the 14k export was
     trained on, rebuilt by ``python -m etts_torch.make_synth_corpus`` and
     ``create_dataset``: the char-CTC transcriber trained on the card
     (``train_ctc_asr``; its step card against CPU in float64), the
     held-out sentences through ``synthesize_speaker`` in regimes syn_norm
     and rand (B2 and B1, launches read around it), one with ``--int8``
     (B3) and syn_norm through Griffin-Lim, scored by
     ``objective_measure`` (MCD, FD, F0-RMSE, STOI, PESQ_proxy, WER)
     beside etts' recorded row, ``export_gst_embeddings``,
     ``eval_disentanglement`` (fresh MINE and CLUB critics, the
     first-token probe) and ``eval_expressive_control`` (its verdicts).
  16. data parallelism (dp_phase): two gloo ranks sharing the card
     (``chip_smoke.py --dp-rank``, processes of their own) vocode two
     seeded mels through ``generate_batch_sharded`` on the 26k export (B1
     once a rank, launches read around it in each; each rank's rows
     bit-equal to one launch here of those rows seeded as the rank seeds
     them) and run ``train_autoregressive --multihost`` for DP_STEPS steps
     on phase 9's corpus and config; the plain driver and the driver as
     the one rank of an NCCL group run here; each first step's loss
     within DP_LOSS_TOL of the plain driver's, the float64 step the
     control; one checkpoint a run; the step times of 1 and 2 ranks (two
     ranks on one card: no speed-up is claimed). Then, on the same ranks,
     tensor and sequence parallelism: the forward, AR and WaveRNN train
     steps at configs/default's full width on a (data 1, model 2) mesh
     (``tp_rank_cases``) against the whole model's step here in float64
     (``tp_case``, ``tp_held``: every gradient, BatchNorm statistic and
     updated parameter), float32 printed; B1 once a rank from the gathered
     WaveRNN (``generate``), the kernel held one step at a time on its
     weights (``tp_b1_check``); ``train_autoregressive`` with
     ``sequence_parallel: 2`` for DP_STEPS steps, its first loss within
     DP_LOSS_TOL of the plain driver's (``tp_phase_checks``).

Phases 13 and 15 run in a process of their own (``--side``) beside phase
12; their lines are printed when it ends.

``python3 chip_smoke.py --nccl-cards``, on a host of two cards or more and
not part of the one-card run, holds data parallelism across the cards:
the worker on one card and on one NCCL rank a card, its checkpoint case,
and ``train_autoregressive`` under torchrun against the plain driver; the
forward step tensor-parallel on a (data N / 2, model 2) mesh of NCCL ranks
(``--tp-rank``) against one card in float64, and the driver with
``sequence_parallel: 2`` under torchrun (``nccl_cards_main``).

The port computes in float32 without TF32 (``utils/precision.py``), as
every entry point sets it, except where a config asks for ``precision:
bfloat16`` (phase 14).

Each entry of the kernels line counts the launches of the run it
describes (the main path's, or the serving run's in its mode), and lists
every path's own run beside them (launches_by_path), each read from zero.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TTS_W = ROOT / "artifacts/soak/ar_best_14k_params_fp16.npz"
VOC_W = ROOT / "artifacts/soak/voc_gta26k_params_fp16.npz"
CONFIG = ROOT / "configs/default"
SENTENCE = ("Scientists at the CERN laboratory say they have discovered "
            "a new particle.")
SERVING_TEXTS = (
    SENTENCE, "Hello there.", "Please close the door when you leave.",
    "The quick brown fox jumps over the lazy dog.",
    "Is this really the best you can do?",
    "Turn left at the next corner, then keep going straight until you "
    "reach the old stone bridge by the river.",
    "Good morning.",
    "We will meet again at seven tomorrow evening, if the weather allows.")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate; the bf16 rate, the
# type of the decode's and of the bf16 and int8 sample loops' products (bf16
# weights, or int8 weights dequantized to bf16, and activations cast to bf16
# before each product in the TPU kernels), whatever cores the port computes
# them on; the int8 rate, the type of the int8_mxu products.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
DECODE_TOL = 5e-3          # max |mel| difference, kernel vs plain
STEP_TOL = 1e-3            # per-step sample difference, kernel vs plain
STEP_AGREE = 0.999         # share of steps within STEP_TOL (int8_mxu)
# the bf16 and int8 kernels sum each product inside mma in an order PyTorch
# cannot
# repeat, so a one-ulp sum now and then turns an activation's bf16
# rounding the other way and the recurrent state carries it for some steps
STEP_AGREE_BF16 = 0.99
PEAKY = 1e6                # fc3 scale that makes RAW sampling an argmax
# h1, h2 after one step from the same state, against exact sums: a bf16
# rounding of one of the step's activations turned the other way moves h by
# up to about 2e-3, in the float32 plain version as in the kernel; leaving
# out the bf16 rounding of the activations moves it by 8e-3
STATE_TOL = 4e-3
# peaky RAW, one step from the same state: the kernel's share of picks equal
# to the exact sums' may fall this far below the float32 plain version's
# (0.9998 on the H100); leaving out the bf16 rounding of the activations
# costs 0.006
PEAKY_MARGIN = 0.001
# the same two bars for the int8 kernel, whose activations round to bf16
# as the bf16 kernel's do, each between its reading and that of its
# float32-activation control (the dequantized weights): on the H100 the
# state within 1.3e-3 (control 7.7e-3), the picks equal to the exact sums'
# 1.0 as the plain version's (control 0.9972)
STATE_TOL_INT8 = 4e-3
PEAKY_MARGIN_INT8 = 0.001
# phase 7: decode steps a stream chunk (r = 10: 40 frames, 0.5 s of audio,
# the chunk of bench.py's stream stage), the bf16 and int8 streams' lengths,
# and the bar of a chunk's conditioning against the whole utterance's, as a
# share of the chunk's largest |value| (the export's aux features reach
# |x| 243; the two are computed at different lengths)
STREAM_CHUNK = 4
STREAM_MAX_LENGTH = 400
STREAM_MAX_LENGTH_INT8 = 160
STREAM_COND = 1e-4
# phase 8: the forward model's mel on the card against the same model on
# the CPU, max |d| (float32 on both, TF32 off; values of unit scale); the
# frames a token lasts under the seeded duration head (about 150 ms at a
# 12.5 ms hop); the forward stream's text; the conv-decoder AR model's
# max_length
FWD_TOL = 1e-3
FWD_FRAMES_PER_TOKEN = 12.0
FWD_STREAM_TEXT = "Hello there."
FWD_STREAM_CHUNK = 40      # frames a vocoder chunk, 0.5 s, as phase 7's
CONV_MAX_LENGTH = 200
# phase 9: the card's train step against the CPU's from the same weights
# and batch (float32, TF32 off): the loss relative, each gradient
# ||d|| <= RTOL * ||g|| + ATOL (ATOL for the gradients that are zero in
# exact arithmetic, a key bias under the softmax and a conv bias before a
# BatchNorm on batch statistics, which rounding leaves at noise); the
# driver's steps, the first run's and the resumed one's; the trained
# export's decode length
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_ATOL = 1e-6
TRAIN_STEPS = (20, 30)
TRAIN_CORPUS = 64
TRAIN_MAX_LENGTH = 200
# phase 10: GST-Tacotron (configs/default, seeded weights) on the card
# against the same port code on the CPU, float32 on both (TF32 off), max
# |d| on values of unit scale: the reference mel and the encoder output;
# every decode step teacher-fed from the CPU run's carry and input (the
# frames, the alignment and the carry it leaves); the free-running frames
# (printed: the first step past the bar); the post CBHG + linear head on
# the same mel; the wav after 2 Griffin-Lim iterations and de-emphasis on
# the same spectrogram, and de-emphasis alone on the same wav, as shares of
# the wav's peak; the stop check's decode length and step
TACO_TOL = 1e-4
TACO_WAV_RTOL = 1e-4
TACO_DEEMPH_RTOL = 1e-6
TACO_SEED = 12
TACO_STOP = (300, 137)
# phase 11: the forward model's training flow on phase 9's corpus. The AR
# model trained FT_AR_STEPS steps at r = 1; the test split the corpus's
# last FT_VAL utterances; extraction card against CPU on FT_CPU_ROWS rows:
# the last block's attention within FT_ATT_TOL (max |d|), the durations
# equal but at a rounding tie (the normalised duration within FT_TIE of a
# half-integer); one forward train step card against CPU on FT_CPU_ROWS
# rows with tests/torch_parity.py::assert_step_close's bars: the loss
# FT_LOSS_TOL relative, each gradient ||d|| <= FT_GRAD_RTOL * ||g|| +
# FT_GRAD_ATOL (FT_GRAD_ATOL for those zero in exact arithmetic), the
# BatchNorm statistics FT_STATS_TOL (max |d|); the driver's steps (a run,
# then resumed); the sentence served
FT_AR_STEPS = 10
FT_VAL = 8
FT_CPU_ROWS = 2
FT_ATT_TOL = 1e-5
FT_TIE = 1e-5
FT_LOSS_TOL = 1e-5
FT_GRAD_RTOL = 1e-4
FT_GRAD_ATOL = 1e-7
FT_STATS_TOL = 1e-6
FT_STEPS = (20, 30)
FT_TEXT = "Hello there."
# phase 12: the vocoder's training flow. VT_UTTS seeded wavs of
# VT_SECONDS (a batch of voc_batch_size 64 crops takes one crop of each of
# 64 training utterances, and voc_test_samples are held out); the card's
# train step against the CPU's on VT_CPU_ROWS crops; the driver's steps (a
# run, then resumed) and its checkpoint cadence; make_gta card against CPU
# on VT_CPU_ROWS rows within VT_GTA_TOL (max |d| of the [0, 1] mels); the
# GTA run's steps and batch; the deterministic runs' steps (a multiple of
# VT_CKPT, so that the in-process run has a checkpoint at that step; cut
# from 20 to make room for phase 15, the bars unchanged). The one-step
# check needs an export trained this far: the float32-activation control
# read 4.1e-2 against the 1.5e-2 bar at step 30, 1.6-1.8e-2 at step 20
# and 9.8e-3 (cleared) at step 12 on the H100
VT_UTTS = 72
VT_SECONDS = (1.0, 3.0)
VT_CPU_ROWS = 2
VT_STEPS = (20, 30)
VT_CKPT = 10
VT_GTA_TOL = 1e-5
VT_GTA_STEPS = 3
VT_GTA_BATCH = 16
VT_DET_STEPS = 10
# the trained export's one-step check (one_step_check in MOL on the
# conditioning of its test utterances): steps, the bar of the kernel's
# state and the margin of its share of samples within STEP_TOL of the
# exact sums' below the float32 plain version's. On the H100 (the step-30
# export, 13 rows, 1000 steps) the state read 5.406e-3 in the kernel and
# in the float32 plain version alike (a turned rounding, on conditioning
# that reaches |x| 38), the control 4.088e-2; the samples 0.981769
# (kernel), 0.990615 (plain), 0.352308 (control): the mma's float32 sums
# turn a rounding more often than the plain version's, the bf16 rounding
# left out moves most samples
VT_ONE_STEP = 1000
STATE_TOL_TRAINED = 1.5e-2
SAMPLE_MARGIN_TRAINED = 0.03
# the float32 step at the driver's batch (64 crops, MOL) against the
# card's float64 step, on two crop draws, the card's and the CPU's: the
# worst gradient's ||d|| / ||g|| (TRAIN_GRAD_ATOL) within VT_F32_GRAD,
# and the card's step with TF32 on (the control) past it
VT_F32_GRAD = 2e-2
# phase 13: the TTS stores and GST-Tacotron's training flow. TT_UTTS seeded
# wavs of TT_SECONDS in the LJSpeech layout, TT_TEST of them the AR store's
# test split (n_test, from 100: the corpus holds 48); both stores card
# against CPU: the metafiles and train.txt byte for byte, the AR mels
# within AR_MEL_TOL (tests/test_torch_vocoder_data.py's MEL_TOL) and the
# Tacotron spectrograms within TACO_STORE_TOL (max |d|, values in [-4, 4]
# and [0, 1]); train_autoregressive TT_AR_STEPS steps on the AR store; one
# Tacotron train step card against CPU on TT_CPU_ROWS utterances at the
# FT_* bars in float64; the driver's steps (a run, then resumed) and its
# checkpoint cadence (checkpoint_interval, from 1000); the deterministic
# runs' steps (a run, then resumed, against one run)
TT_UTTS = 48
TT_SECONDS = (1.5, 4.0)
TT_TEST = 8
AR_MEL_TOL = 1e-5
TACO_STORE_TOL = 1e-5
TT_AR_STEPS = 5
TT_CPU_ROWS = 2
# the float32 step on TT_CPU_ROWS utterances against the card's float64
# step, the card's and the CPU's: the worst gradient's ||d|| / ||g||
# (TRAIN_GRAD_ATOL) within TT_F32_GRAD, and the card's step with TF32 on
# (the control) past it. Read on an H100 before the bar was set: card
# 1.23e-3, CPU 3.49e-6, control 1.79e-1
TT_F32_GRAD = 2e-2
TT_STEPS = (10, 20)
TT_CKPT = 10
TT_DET_STEPS = (4, 8)
TT_WORDS = ("the quick brown fox jumps over a lazy dog while birds fly "
            "south in winter and children play in the park as rain falls "
            "on the roof of an old house near the river").split()


# phase 14: precision bfloat16, configs/default with the key written into
# a copy of its configs. Serving: the 14k export's bf16 model through the
# fused decode against the same model's plain bf16 decode on the card, and
# the float32 model's the same way (the control), each as (frames apart in
# length, mean |d| of the mel over the frames both have, in [-4, 4]); the
# forward pass at max_frames 1280, bf16 against float32 on the same
# durations, norm-relative; one AR and one forward train step on
# BF16_CPU_ROWS rows, the card's bf16 gradients against the CPU's, each
# tensor within BF16_GRAD_RTOL of the CPU's norm or BF16_NOISE times the
# CPU's own bf16-vs-float32 distance, whichever is larger (a gradient that
# nearly cancels, a key's or one zero in exact arithmetic, is bf16 noise on
# both devices), and the card's distance from the CPU's float32 step
# within a factor BF16_DIST of the CPU's (a card that skipped the bf16
# casts would sit at float32's); the driver's steps, the forward driver's.
# Read on the H100 before these bars were set: the decode 0.0135 (control
# 0.0094); the forward pass 2.12e-2; the gradients, against the CPU's norm
# alone, 0.129 (AR, `wq.bias`) and 0.288 (forward, `wk.weight`), each
# device's distance from float32 4.32e-2 and 4.37e-2 (AR), 1.320e-1 and
# 1.330e-1 (forward)
BF16_DECODE_LEN = 0.1      # share of the plain decode's frames
BF16_DECODE_MEAN = 0.05
BF16_FWD_TOL = 5e-2
BF16_GRAD_RTOL = 5e-2
BF16_NOISE = 3.0
BF16_DIST = 2.0
BF16_CPU_ROWS = 2
BF16_TRAIN_STEPS = 32
BF16_TRACE = (10, 30)
BF16_FWD_STEPS = 5
# phase 9's float32 run (median ms/step, target frames/s, peak GiB),
# printed beside phase 14's bf16 run
F32_TRAIN = {}
# phase 15: the evaluation suite on the corpus the 14k export was trained
# on (make_synth_corpus at its defaults: EV_UTTS utterances, seed 0; the
# store's split holds out 20). Cuts: the char-CTC transcriber on
# EV_CTC_UTTS training utterances (from all) for EV_CTC_STEPS steps (from
# 600; 200 took 55-82 s in its process of its own, where the rest of the
# phase that runs beside it takes about 45), its card-CPU float64 step on
# EV_CTC_CPU_ROWS of them at phase 11's FT_* bars, its float32 step timed
# over EV_CTC_TIMED steps;
# EV_SENTENCES held-out sentences a regime (from 20), at most
# EV_MAX_LENGTH frames each; the fresh critics EV_CRITIC_STEPS steps (from
# 600) on EV_BATCHES batches (from 16), one seed (from 3); expressive
# control on EV_EXPR_UTTS sentences (from 6). The export's step sets r and
# the prenet dropout from the corpus's schedules
EV_UTTS = 300
EV_STEP = 14000
EV_CTC_UTTS = 64
EV_CTC_STEPS = 120
EV_CTC_CPU_ROWS = 8
EV_CTC_TIMED = 5
EV_SENTENCES = 6
EV_MAX_LENGTH = 600        # eval_soak.py's cap, which etts' record used
EV_CRITIC_STEPS = 100
EV_BATCHES = 4
EV_EXPR_UTTS = 2
# etts' own record of this evaluation (a TPU run), printed beside
EV_ETTS_CURVE = ROOT / "artifacts/soak/eval_curve.csv"
# phases 13 and 15 run in a process of their own beside phase 12 (each
# phase host-bound, the card idle most of the time); the seconds that
# process may run on once phase 12 has ended
SIDE_TIMEOUT = 300
# phase 16: data parallelism, two gloo ranks sharing the one card (NCCL
# refuses two ranks on one GPU) and one NCCL rank. Vocoding: DP_MEL_FRAMES
# seeded mels of 1-2 s through generate_batch_sharded on the 26k export,
# seed DP_SEED. Training: train_autoregressive on phase 9's corpus and
# config (full width, its cuts) for DP_STEPS steps on 2 gloo ranks, on 1
# NCCL rank and plain; the first step's loss (the global batch's, before
# any update: the same dropout, HeadDrop and BatchNorm statistics) within
# DP_LOSS_TOL relative of the plain driver's. The bar is set from the
# float64 control: the plain float32 step's loss, a float32 computation
# ordered otherwise than the ranks', reads about 1e-7 from the card's
# float64 step on the same batch and draws; a rank's local BatchNorm
# statistics or its own dropout draws move the loss by 1e-3 or more at the
# CPU test's width. Each spawned rank gets DP_TIMEOUT s
DP_MEL_FRAMES = (96, 152)
DP_SEED = 16
DP_STEPS = 3
DP_LOSS_TOL = 1e-5
DP_TIMEOUT = 300
DP_RANK = "--dp-rank"
# phase 16, tensor and sequence parallelism on the same two gloo ranks:
# the forward, AR and WaveRNN train steps at configs/default's full width
# (heads 4, d 256, FFN 1024; rnn 512, fc 512) on a (data 1, model 2) mesh,
# on a seeded global batch of TP_B rows (the forward model's TP_FWD_FRAMES
# frames, cut from its 1280; the AR's TP_AR_FRAMES at r = TP_R; crops of
# TP_VOC_HOPS hops), dropout, prenet dropout and HeadDrop on. In float64
# every gradient, BatchNorm statistic and updated parameter is held
# within TP_GRAD_TOL of the tensor's largest magnitude (plus TP_GRAD_ATOL
# for the gradients zero in exact arithmetic, whose parameters Adam moves
# by noise: within the learning rate) of the step in this process on the
# whole model; float32's distance is printed, not held. Then B1 vocodes a
# seeded mel from the gathered float32 WaveRNN on each rank (fold
# TP_FOLD), its kernel held against the plain version as phase 3 holds
# it; and train_autoregressive runs with sequence_parallel: 2 for
# DP_STEPS steps, its first loss within DP_LOSS_TOL of the plain
# driver's.
TP_B = 4
TP_FWD_FRAMES = 400
TP_AR_FRAMES = 201
TP_R = 10
TP_VOC_HOPS = 2
TP_GRAD_TOL = 1e-5
TP_GRAD_ATOL = 1e-12
TP_LR = 1e-3
TP_FOLD = (2000, 100)
TP_SEED = 5
# ``chip_smoke.py --nccl-cards``: data parallelism over every card of the
# host, one NCCL rank a card (not part of the one-card run)
NCCL_CARDS = "--nccl-cards"
TP_RANK = "--tp-rank"       # a rank of --nccl-cards' (2, 2) TP step


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def say(card_line, msg):
    print(f"[{card_line}] {msg}", flush=True)


def cuda_ms(fn, reps, warm=True):
    """Mean CUDA-event time in ms of ``reps`` calls of fn (after one
    warm-up call when ``warm``), and the last call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def _counted():
    """Each kernel of the kernels line: the wrapper and the attribute that
    counts its launches."""
    from etts_torch.ops.kernels import decoder_step as dstep
    from etts_torch.ops.kernels import wavernn_cell as wcell
    loop = wcell.wavernn_sample_loop
    return {"fused_decode": (dstep.fused_decode, "launches"),
            "wavernn_sample_loop": (loop, "launches"),
            "wavernn_sample_loop_int8": (loop, "launches_int8"),
            "wavernn_sample_loop_int8_mxu": (loop, "launches_int8_mxu")}


def zero_launches():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    """{kernel name: launches since the last zero_launches()}."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _counted().items()}


def bound(n_bytes, n_ops, peak=PEAK_BF16):
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def decode_bound(w, steps):
    """The fused decode's bound for ``steps`` steps of these weights: the
    weights read once, the positional rows read and the frames written;
    multiply-adds per step for the prenet, blocks and FinalProj once, the
    postnet convs and the stop head once for each of the r new frames,
    attention over t + 1 cached rows and n_enc encoder rows."""
    d, n_enc = w.d, w.ck.shape[1]
    per_step = sum(x.numel() for x in (w.pw1, w.pw2, w.wqkv, w.wos, w.wqc,
                                        w.woc, w.f1, w.f2, w.fpw))
    per_frame = sum(x.numel() for x in (w.pc0, w.pcm, w.pcl, w.stopw))
    n_ops = sum(2 * (per_step + w.r * per_frame)
                + 4 * d * w.n_blocks * (t + 1 + n_enc) for t in range(steps))
    n_bytes = w.weight_bytes() + steps * d * 4 + steps * w.r * w.mel * 4
    return bound(n_bytes, n_ops)


def loop_bound(w, weight_dtype, cond, noise):
    """The sample loop's bound on these inputs: the weights (their stored
    width), the conditioning at the function's bf16 width and the uniforms
    read once, one float32 sample per step and row written; a multiply-add
    per weight, step and row, at the rate of the mode's product type."""
    T, B, _ = cond.shape
    n_bytes = w.n_bytes() + cond.numel() * 2 + noise.numel() * 4 + T * B * 4
    n_ops = 2 * sum(x.numel() for x in w.tensors() if x.dim() == 2) * T * B
    return bound(n_bytes, n_ops,
                 PEAK_INT8 if weight_dtype == "int8_mxu" else PEAK_BF16)


def n_folds(total_len, target, overlap):
    """Fold rows of a waveform of total_len samples (fold_with_overlap)."""
    n = (total_len - overlap) // (target + overlap)
    return n + (total_len - (n * (overlap + target) + overlap) != 0)


def ref_wav(seed=0, seconds=2.0, sr=16000):
    """Seeded vowel-like reference: a gliding harmonic tone plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 12))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t) ** 2)
    wav = wav + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


def random_sample_weights(like, n_out, dev, seed=0):
    """Sample-path weights of the flagship widths drawn from a seed
    (normal, 1/sqrt(fan-in)), for a kernel check whose samples spread over
    (-1, 1) and, in RAW mode, over 512 classes: (bf16 SampleLoopWeights,
    Int8SampleLoopWeights quantized from the same float32 draw)."""
    import torch
    from etts_torch.ops.kernels.wavernn_cell import (Int8SampleLoopWeights,
                                                     SampleLoopWeights)
    g = torch.Generator().manual_seed(seed)
    d, fc, feat, adim = like.d, like.fc, like.feat, like.adim

    def w(n_in, n_o):
        return torch.randn(n_in, n_o, generator=g) / n_in ** 0.5

    def b(n):
        return 0.1 * torch.randn(n, generator=g)
    # small logits; for MOL (n_out = 30) log-scales near -3, so that most
    # samples fall inside (-1, 1) rather than on the clip
    bf3 = b(n_out)
    if n_out == 30:
        bf3[20:] -= 3.0
    args = (w(1 + feat + adim, d), b(d), w(d, 3 * d), w(d, 3 * d), b(3 * d),
            b(3 * d), w(d + adim, 3 * d), w(d, 3 * d), b(3 * d), b(3 * d),
            w(d + adim, fc), b(fc), w(fc + adim, fc), b(fc),
            0.1 * w(fc, n_out), bf3)
    return (SampleLoopWeights.from_flax_layout(*args, feat=feat,
                                               dtype=torch.bfloat16,
                                               device=dev),
            Int8SampleLoopWeights.from_flax_layout(*args, feat=feat,
                                                   device=dev))


def attention_at_end(w):
    """A copy of the decode weights whose last block's cross-attention
    looks at the last encoder row from the first step on: its query is a
    bias of ones alone, and only that row's key answers it, with a score of
    4 in every head. So the attention-completion stop must fire."""
    import dataclasses
    last = w.n_blocks - 1
    depth = w.d // w.n_heads
    wqc, bqc, ck = w.wqc.clone(), w.bqc.clone(), w.ck.clone()
    wqc[last] = 0
    bqc[last] = 1
    ck[last] = 0
    ck[last, -1] = 4 / depth ** 0.5
    return dataclasses.replace(w, wqc=wqc, bqc=bqc, ck=ck)


def interior_stop_weights(w, max_steps):
    """A copy of the decode weights whose stop class first fires inside an
    r-frame group after the first steps, and the length it must stop at.

    The postnet's last layer and the output norm are made neutral, so the
    kernel's output frames are the pre-postnet frames that the stop head
    reads; one run without the stop gives them. The stop head is then
    rebuilt: the other classes' logits are 0, and the stop logit is a.x -
    thr, with a solved (least norm) so that a.x is one higher on the
    target frame than on each frame before it, and thr halfway between
    that frame's a.x and the largest before it. Target frames are the
    middle of a group from the fourth step on, with fewer frames before
    them than mel channels; the first whose gap survives a's bf16 rounding
    is taken."""
    import dataclasses
    import torch
    from etts_torch.ops.kernels import decoder_step as dstep
    psh = w.psh.clone()
    psh[-1] = 0
    nw = dataclasses.replace(w, pcl=torch.zeros_like(w.pcl), psh=psh,
                             outs=torch.ones_like(w.outs),
                             outb=torch.zeros_like(w.outb))
    mlin, _, _ = dstep.fused_decode(nw, max_steps=max_steps,
                                    prenet_dropout=0.0, stop_enabled=False)
    x = mlin.double().cpu()
    r, s = w.r, w.stop_index
    for i in range(3 * r + r // 2, min(w.mel, max_steps * r), r):
        a = torch.linalg.pinv(x[i] - x[:i]) @ torch.ones(i, dtype=x.dtype)
        a = a.to(w.stopw.dtype)
        score = x[:i + 1] @ a.double()
        below = float(score[:i].max())
        gap = float(score[i]) - below
        if gap > 1e-2 and gap > 1e-3 * float(score.abs().max()):
            stopw = torch.zeros_like(w.stopw)
            stopw[s] = a.to(stopw.device)
            stopb = torch.zeros_like(w.stopb)
            stopb[s] = -(below + float(score[i])) / 2
            return dataclasses.replace(nw, stopw=stopw, stopb=stopb), i + 1
    raise RuntimeError("no target frame's stop score stands apart from the "
                       "frames before it")


def dequantized(w8):
    """float32 SampleLoopWeights with the int8 weights' values q * s: the
    int8 kernel's function with float32 activations and no bf16 stream,
    the control of its one-step check."""
    import torch
    from etts_torch.ops.kernels.wavernn_cell import (MATRICES,
                                                     SampleLoopWeights)
    kw = {f.name: getattr(w8, f.name)
          for f in dataclasses.fields(SampleLoopWeights)}
    for k in MATRICES:
        kw[k] = getattr(w8, k).float() * getattr(w8, "s_" + k)[:, None]
    return SampleLoopWeights(**kw)


def f32_activations(w):
    """``w`` with float32 matrices: the bf16 kernel's function with the
    activations left in float32 (no bf16 rounding before a product, no
    bf16 stream), the control of its one-step check."""
    from etts_torch.ops.kernels.wavernn_cell import MATRICES
    return dataclasses.replace(w, **{k: getattr(w, k).float()
                                     for k in MATRICES})


def one_step_check(cl, name, wk, control, exact_fn, weight_dtype, cond_all,
                   all_b, state_tol, margin, failures, n_steps=200,
                   mode="RAW", n_classes=512, seed=50):
    """One step at a time from the same state: the kernel run one step a
    call (exact, as the chunked check shows) and the plain versions
    started from the kernel's state each step, so what differs is the step
    itself. Each is read against exact_fn(cond), the plain step with exact
    (float64) sums and the same roundings, which neither float32 sum order
    is nearer to by construction: the float32 state the kernel's step
    leaves (h1, h2) must be within state_tol of it. A float32 sum ending
    an ulp apart now and then turns a bf16 rounding of an activation,
    which moves the sample (a peaky RAW argmax over 512 logits, or a MOL
    mixture pick and its logistic) in either float32 version; the
    kernel's share of samples within STEP_TOL of the exact sums' must be
    no worse than the float32 plain version's by more than ``margin``,
    over all B. ``control`` (the activations left in float32) is run in
    the plain version's place beside it: both bars must reject it."""
    import torch
    from etts_torch.ops.kernels import wavernn_cell as wcell
    dev = cond_all.device
    names = ("kernel", "plain", "control")
    pooled = dict.fromkeys(names, 0)
    control_dh = 0.0
    for B in all_b:
        cond = cond_all[:n_steps, :B].contiguous()
        g = torch.Generator(dev).manual_seed(seed + B)
        u = torch.rand(n_steps, B, wcell.n_draw(mode, n_classes, wk.n_out),
                       device=dev, generator=g)
        kw = dict(mode=mode, n_classes=n_classes)
        exact = exact_fn(cond)
        st = wcell.init_state(B, wk.d, dev)
        near = {nm: torch.zeros((), device=dev) for nm in names}
        dh = {nm: torch.zeros((), device=dev) for nm in names}
        mean_dh = {nm: torch.zeros((), device=dev) for nm in names}
        for t in range(n_steps):
            c_t, u_t = cond[t:t + 1], u[t:t + 1]
            k, st_k = wcell.wavernn_sample_loop(c_t, wk, noise=u_t, state=st,
                                                weight_dtype=weight_dtype,
                                                **kw)
            got = {"kernel": (k[0], st_k)}
            for nm, w_, wdt in (("plain", wk, weight_dtype),
                                ("control", control, None)):
                o, st_o = wcell.wavernn_sample_loop_plain(
                    c_t, w_, noise=u_t, state=st, weight_dtype=wdt, **kw)
                got[nm] = (o[0], st_o)
            logits, h1_r, h2_r = exact(t, st["x"].double(), st["h1"].double(),
                                       st["h2"].double())
            r = wcell._sample(logits, u_t[0], mode, n_classes)
            for nm, (o, st_o) in got.items():
                near[nm] += ((o - r).abs() <= STEP_TOL).sum()
                d_h = torch.maximum((st_o["h1"] - h1_r).abs(),
                                    (st_o["h2"] - h2_r).abs())
                dh[nm] = torch.maximum(dh[nm], d_h.max())
                mean_dh[nm] += d_h.mean() / n_steps
            st = st_k
        near = {nm: int(v) for nm, v in near.items()}
        dh = {nm: float(v) for nm, v in dh.items()}
        for nm in names:
            pooled[nm] += near[nm]
        control_dh = max(control_dh, dh["control"])
        say(cl, f"wavernn_sample_loop {name}, one step from the same state "
                f"({mode}), B={B}, {n_steps} steps "
                f"({-(-B // wcell.TILE_ROWS)} blocks of {wcell.TILE_ROWS} "
                f"rows), against exact sums: h1, h2 max |d| kernel "
                f"{dh['kernel']:.3e} (tol {state_tol}), plain "
                f"{dh['plain']:.3e}, control {dh['control']:.3e}; mean |d| "
                + ", ".join(f"{nm} {float(mean_dh[nm]):.3e}" for nm in names)
                + f"; share of samples within {STEP_TOL}: "
                + ", ".join(f"{nm} {near[nm] / (n_steps * B):.6f}"
                            for nm in names))
        if not dh["kernel"] <= state_tol:
            failures.append(f"wavernn_sample_loop {name} one step, same "
                            f"state (B={B})")
    n = n_steps * sum(all_b)
    share = {nm: v / n for nm, v in pooled.items()}
    say(cl, f"wavernn_sample_loop {name} ({mode}), {n} samples one step "
            f"from the same state: within {STEP_TOL} of the exact sums' "
            f"kernel {share['kernel']:.6f}, plain {share['plain']:.6f} (bar "
            f"{share['plain'] - margin:.6f} = plain - {margin}), control "
            f"{share['control']:.6f}, control state max |d| "
            f"{control_dh:.3e}")
    if share["kernel"] < share["plain"] - margin:
        failures.append(f"wavernn_sample_loop {name} one-step samples")
    if (share["control"] >= share["plain"] - margin
            or control_dh <= state_tol):
        failures.append(f"the float32-activation control of {name} clears "
                        "a one-step bar")


def stream_phase(cl, tts, voc, ref_mel, spk, mel, failures):
    """Phase 7 (see the module docstring); ``mel`` is phase 4's. Failed
    checks are appended to ``failures``. Returns each stream's launches
    ({path: read_launches()})."""
    import numpy as np
    import torch
    from etts_torch import streaming
    from etts_torch.models.autoregressive import (autoregressive_predict,
                                                  make_chunk_decoder,
                                                  streaming_decode_init)
    from etts_torch.models.wavernn import (_conditioning_streams,
                                           _upsample_fold)
    from etts_torch.ops.kernels import wavernn_cell as wcell
    from etts_torch.ops.normalizers import mu_law_decode
    dev = tts.device
    vm, m, r = voc.model, tts.model, tts.r
    hop, sr = vm.hop_length, tts.config["sampling_rate"]
    frames = STREAM_CHUNK * r
    kw = dict(mel_chunk=STREAM_CHUNK, seed=0)
    n_steps = None          # the bf16 stream's decode steps

    def stream(flag, max_length, first_only=False):
        """One stream from the call: (wav chunks, host seconds from the call
        to each chunk, each kernel's launches in it)."""
        zero_launches()
        chunks, times = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = tts.stream(SENTENCE, voc, ref_mel, spk, max_length=max_length,
                         int8_weights=flag, **kw)
        for c in gen:       # each chunk is on the host: synchronised
            times.append(time.perf_counter() - t0)
            chunks.append(c)
            if first_only:
                gen.close()
                break
        return chunks, times, read_launches()

    stream(False, 2 * frames)               # warm-up, both weight modes
    stream(True, 2 * frames)
    inp, ref, spk_t = tts._stream_inputs(SENTENCE, ref_mel, spk)
    paths = {}
    for label, flag, max_length, counter, wdt in (
            ("bf16", False, STREAM_MAX_LENGTH, "wavernn_sample_loop", None),
            ("int8_weights='mxu'", "mxu", STREAM_MAX_LENGTH_INT8,
             "wavernn_sample_loop_int8", "int8")):
        chunks, times, ran = stream(flag, max_length)
        paths[f"stream_{wdt or 'bf16'}"] = ran
        firsts = [times[0]]
        if wdt is None:     # first audio, best of 3
            firsts += [stream(flag, max_length, True)[1][0] for _ in range(2)]
        wav = np.concatenate(chunks)
        audio_s = wav.shape[0] / sr
        want = {k: 0 for k in ran} | {counter: len(chunks)}
        if ran != want:
            failures.append(f"stream ({label}) launches {ran}, want {want}")
        if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
            failures.append(f"stream ({label}) wav not finite or outside "
                            "[-1, 1]")
        gaps = np.diff(times)
        say(cl, f"stream ({label}), mel_chunk {STREAM_CHUNK} at r = {r} "
                f"({frames} frames, {frames * hop / sr:.2f} s a chunk), "
                f"max_length {max_length}: {len(chunks)} chunks, "
                f"{wav.shape[0]} samples ({audio_s:.3f} s) in "
                f"{times[-1]:.3f} s, stream RTF {times[-1] / audio_s:.4f}; "
                f"first audio {min(firsts):.4f} s (best of {len(firsts)}: "
                f"{', '.join(f'{x:.4f}' for x in firsts)}); later chunks "
                f"{', '.join(f'{x:.4f}' for x in gaps)} s; launches {ran}")

        # the mel: the stream's decode against autoregressive_predict
        mels = list(tts.stream_mels(SENTENCE, ref_mel, spk,
                                    max_length=max_length, **kw))
        mel_s = np.concatenate(mels)
        with torch.no_grad():
            out = autoregressive_predict(
                m, inp, ref, spk_t, r=r, max_length=max_length,
                prenet_dropout=tts.prenet_dropout,
                generator=torch.Generator(dev).manual_seed(0))
        mel_p = out["mel"][0, :out["mel_length"]].cpu().numpy()
        steps_s = -(-mel_s.shape[0] // r)
        same = mel_s.shape == mel_p.shape and steps_s == out["steps"]
        d_mel = (float(np.abs(mel_s - mel_p).max()) if same
                 else float("inf"))
        say(cl, f"stream ({label}) mel vs autoregressive_predict (same "
                f"seed): {mel_s.shape[0]} vs {mel_p.shape[0]} frames, steps "
                f"{steps_s} vs {out['steps']}, max |dmel| {d_mel:.3e} (tol 0)")
        if not (same and d_mel == 0.0) or mel_s.shape[0] * hop != wav.shape[0]:
            failures.append(f"stream ({label}) mel")
        n_steps = n_steps or steps_s

        # each chunk's conditioning against the whole utterance's, and the
        # streamed samples against one launch over the chunks' conditioning
        vmels = [(x + 4.0) / 8.0 for x in mels]
        weights = voc._loop_args(flag)["weights"]
        with torch.no_grad():
            full = _conditioning_streams(*_upsample_fold(
                vm, torch.from_numpy(np.concatenate(vmels)).to(dev)[None],
                False, 0, 0))
            conds, off, d_cond = [], 0, 0.0
            for ctx, n in streaming._chunk_contexts(vmels, frames, vm.pad,
                                                    vm.feat_dims, dev):
                c = streaming._chunk_cond(vm, ctx)
                conds.append(c[:n * hop])      # what the stream's loop ran
                a, b = c[:n * hop], full[off:off + n * hop]
                d_cond = max(d_cond, float((a - b).abs().max()
                                           / b.abs().max()))
                off += n * hop
        one, _ = wcell.wavernn_sample_loop(
            torch.cat(conds), weights, mode=vm.mode, n_classes=vm.n_classes,
            seed=1, weight_dtype=wdt)
        one = one[:off, 0]
        if voc._pick(None, "mu_law", True) and vm.mode == "RAW":
            one = mu_law_decode(one, vm.n_classes, from_labels=False)
        one = one.cpu().numpy()
        d_wav = (float(np.abs(wav - one).max()) if one.shape == wav.shape
                 else float("inf"))
        say(cl, f"stream ({label}) conditioning: {len(conds)} chunks against "
                f"the whole utterance's, max |d| / chunk max {d_cond:.3e} "
                f"(tol {STREAM_COND}); samples against one launch over the "
                f"chunks' conditioning (seed 1): max |d| {d_wav:.3e} (tol 0)")
        if not d_cond <= STREAM_COND:
            failures.append(f"stream ({label}) conditioning")
        if d_wav != 0.0:
            failures.append(f"stream ({label}) state carry")

        # the sample loop alone at one row on an interior chunk's
        # conditioning
        c = conds[min(1, len(conds) - 1)]
        ms, _ = cuda_ms(lambda: wcell.wavernn_sample_loop(
            c, weights, mode=vm.mode, n_classes=vm.n_classes, seed=1,
            state=wcell.init_state(1, vm.rnn_dims, dev), weight_dtype=wdt), 3)
        say(cl, f"wavernn_sample_loop {wdt or 'bf16'} at one row (B = 1), "
                f"a stream chunk of T = {c.shape[0]}: {ms:.3f} ms "
                f"({ms / c.shape[0] * 1e3:.2f} us/step; real time at {sr} Hz "
                f"needs at most {1e6 / sr:.1f})")

    # the plain chunked decode's time a step (host clock, synchronised),
    # the encode and carry built before the clock starts
    with torch.no_grad():
        st = streaming_decode_init(m, inp, ref, spk_t, r=r,
                                   max_length=STREAM_MAX_LENGTH,
                                   generator=torch.Generator(dev))
        dec = make_chunk_decoder(m, chunk=STREAM_CHUNK, r=r,
                                 prenet_dropout=tts.prenet_dropout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while st["i"] < n_steps:        # steps past max_steps cost nothing
            st, _ = dec(st)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    say(cl, f"plain chunked decode: {ms:.3f} ms/step over {n_steps} steps at "
            f"r = {r}")

    # Griffin-Lim on phase 4's mel on the card, warm
    mel_t = torch.from_numpy(mel.T).to(dev)
    tts.audio.reconstruct_waveform(mel_t, n_iter=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gl = tts.audio.reconstruct_waveform(mel_t, n_iter=32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(gl).all())
    say(cl, f"Griffin-Lim (reconstruct_waveform, 32 iterations) on a "
            f"{mel.shape[0]}-frame mel: {ms:.1f} ms, "
            f"{gl.shape[0]} samples ({gl.shape[0] / sr:.3f} s), finite "
            f"{finite}")
    if not finite or gl.shape[0] != (mel.shape[0] - 1) * hop:
        failures.append("Griffin-Lim")
    return paths


def held(cl, vm, label, cond, wts, wdt, failures, state=None, seed=8):
    """The sample loop of vocoder model ``vm`` on ``cond`` from ``state``,
    against its plain version fed the kernel's samples, shared uniforms:
    phase 3's bar (STEP_AGREE_BF16 of the steps within STEP_TOL; the int8
    kernel's too, as phase 3b holds it). A failure goes to ``failures``.
    Returns the kernel's max |d| from the plain version."""
    import torch
    from etts_torch.ops.kernels import wavernn_cell as wcell
    dev = cond.device
    T, B, _ = cond.shape
    u = torch.rand(T, B, wcell.n_draw(vm.mode, vm.n_classes, wts.n_out),
                   device=dev, generator=torch.Generator(dev).manual_seed(
                       seed))
    kw = dict(mode=vm.mode, n_classes=vm.n_classes, noise=u,
              weight_dtype=wdt, state=state)
    ms, (k_out, _) = cuda_ms(
        lambda: wcell.wavernn_sample_loop(cond, wts, **kw), 1, warm=False)
    t_out, _ = wcell.wavernn_sample_loop_plain(cond, wts, teacher=k_out,
                                               **kw)
    diff = (k_out - t_out).abs()
    agree = float((diff <= STEP_TOL).float().mean())
    say(cl, f"wavernn_sample_loop {wdt or 'bf16'} vs plain ({label}), "
            f"B={B} T={T}: per-step (same history) max |d| "
            f"{float(diff.max()):.3e}, {agree:.6f} of steps within "
            f"{STEP_TOL} (bar {STEP_AGREE_BF16}); "
            f"{float((k_out.abs() < 1).float().mean()):.4f} of samples "
            f"inside (-1, 1); kernel {ms:.2f} ms")
    if agree < STEP_AGREE_BF16 or not bool(torch.isfinite(k_out).all()):
        failures.append(f"wavernn_sample_loop {wdt or 'bf16'} vs plain "
                        f"({label})")
    return float(diff.max())


def vocoder_cond(voc, mel):
    """The sample loop's conditioning for a TTS mel (t, n_mels) in [-4,
    4], folded as VocoderSynthesizer.generate folds it."""
    import torch
    import torch.nn.functional as F
    from etts_torch.models.wavernn import (_clamp_mels, _conditioning_streams,
                                           fold_with_overlap)
    vm = voc.model
    target = voc.config.get("voc_target", 11000)
    overlap = voc.config.get("voc_overlap", 550)
    with torch.no_grad():
        vmel = _clamp_mels(torch.from_numpy((mel + 4.0) / 8.0).to("cuda"))
        up, aux = vm.upsample(F.pad(vmel[None], (0, 0, vm.pad, vm.pad)))
        return _conditioning_streams(fold_with_overlap(up, target, overlap),
                                     fold_with_overlap(aux, target, overlap))


def forward_phase(cl, voc, ref_mel, spk, seeded, failures):
    """Phase 8: the forward (duration) model of configs/default's
    forward_config.yaml (d 256, 4 + 4 dense blocks, FFN 1024, max_frames
    1280, mel 80, postnet 5 x 256) on seeded weights
    (``etts_torch.convert.seeded_flat``), the duration head's bias set to
    FWD_FRAMES_PER_TOKEN, so that a token lasts about 12 frames (about 150
    ms of a phoneme at a 12.5 ms hop) and SENTENCE (76 tokens) expands to
    about 900 of the 1280 frames; then a conv-decoder AR model with prosody
    statistics. ``seeded``: phase 3's seeded MOL sample-loop weights,
    {None: bf16, "int8": int8}, whose samples do not all clip.
    Failed checks are appended to ``failures``. Returns each run's
    launches ({path: read_launches()})."""
    import numpy as np
    import torch
    import yaml
    from etts_torch import streaming
    from etts_torch.api import TTSSynthesizer
    from etts_torch.convert import seeded_flat
    from etts_torch.models.autoregressive import autoregressive_predict
    from etts_torch.ops.kernels import wavernn_cell as wcell
    from etts_torch.ops.normalizers import mu_law_decode
    from etts_torch.utils.config import (build_forward, build_tts,
                                         load_config, text_pipeline)
    dev = torch.device("cuda")
    vm = voc.model
    sr, hop = voc.config["sampling_rate"], vm.hop_length
    mu_law = voc._pick(None, "mu_law", True) and vm.mode == "RAW"
    paths = {}

    cfg = load_config(CONFIG, "forward")
    vocab = text_pipeline(cfg, "grapheme", "forward").tokenizer.vocab_size
    flat = seeded_flat(build_forward(cfg, vocab), 11)
    flat["['dur_pred']['linear']['bias']"][:] = FWD_FRAMES_PER_TOKEN
    kw = dict(phonemizer_backend="grapheme", model_kind="forward")
    fwd = TTSSynthesizer(CONFIG, flat, "cuda", **kw)
    fwd_cpu = TTSSynthesizer(CONFIG, flat, "cpu", **kw)
    ids = torch.from_numpy(fwd.encode_text(SENTENCE))[None].to(dev)
    cap = int(cfg["max_frames"])

    # text -> mel -> wav, warm, the counts read around it
    fwd.predict(SENTENCE)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = fwd.predict(SENTENCE)["mel"]
    t_mel = time.perf_counter() - t0
    wav = voc.generate((mel + 4.0) / 8.0, seed=0)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    ran = paths["forward"] = read_launches()
    audio_s = wav.shape[0] / sr
    want = {k: 0 for k in ran} | {"wavernn_sample_loop": 1}
    if ran != want:
        failures.append(f"forward path launches {ran}, want {want}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
            and wav.shape[0] == (mel.shape[0] - 1) * hop):
        failures.append("forward path wav")
    with torch.no_grad():
        fwd_ms, out = cuda_ms(lambda: fwd.model(ids, max_frames=cap), 5)
        dur = out["duration"][0, :, 0]
    # the sample loop alone at the forward path's conditioning, folded as
    # VocoderSynthesizer.generate folds it: timed as generate calls it, and
    # held against its plain version at these shapes on the vocoder's
    # weights and on the seeded MOL weights, whose samples do not all clip
    cond = vocoder_cond(voc, mel)
    b1_ms, _ = cuda_ms(lambda: wcell.wavernn_sample_loop(
        cond, voc.weights, mode=vm.mode, n_classes=vm.n_classes, seed=0), 1,
        warm=False)
    for label, wts in (("the forward path's shapes, the vocoder's weights",
                        voc.weights),
                       ("the forward path's shapes, seeded random weights",
                        seeded[None])):
        held(cl, vm, label, cond, wts, None, failures)
    say(cl, f"forward path: {ids.shape[1]} tokens, durations "
            f"{float(dur.min()):.2f}-{float(dur.max()):.2f} frames -> "
            f"{mel.shape[0]} of {cap} frames -> {wav.shape[0]} samples "
            f"({audio_s:.3f} s); launches {ran}")
    say(cl, f"forward path: text -> wav {e2e:.3f} s, RTF "
            f"{e2e / audio_s:.4f}; predict {t_mel * 1e3:.1f} ms (host); "
            f"forward pass {fwd_ms:.3f} ms (CUDA events, mean of 5); "
            f"wavernn_sample_loop bf16 {b1_ms:.2f} ms for T={cond.shape[0]} "
            f"x B={cond.shape[1]}; the rest (upsampling, fold, finalize, "
            f"copies, host) {(e2e * 1e3 - fwd_ms - b1_ms):.1f} ms")

    # the card against the same model on the CPU, float32
    mel_cpu = fwd_cpu.predict(SENTENCE)["mel"]
    d_mel = (float(np.abs(mel - mel_cpu).max())
             if mel.shape == mel_cpu.shape else float("inf"))
    say(cl, f"forward predict, card vs CPU (float32): {mel.shape[0]} vs "
            f"{mel_cpu.shape[0]} frames, max |dmel| {d_mel:.3e} (tol "
            f"{FWD_TOL})")
    if not d_mel <= FWD_TOL:
        failures.append("forward predict, card vs CPU")

    # the stream of a short text, bf16 and int8 ("mxu" runs "int8")
    smel = fwd.predict(FWD_STREAM_TEXT)["mel"]

    def stream(flag, first_only=False):
        zero_launches()
        chunks, times = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = fwd.stream(FWD_STREAM_TEXT, voc, mel_chunk=FWD_STREAM_CHUNK,
                         seed=0, int8_weights=flag)
        for c in gen:
            times.append(time.perf_counter() - t0)
            chunks.append(c)
            if first_only:
                gen.close()
                break
        return chunks, times, read_launches()

    stream(False, True)                     # warm-up
    stream(True, True)
    n_chunks = -(-smel.shape[0] // (FWD_STREAM_CHUNK))
    for label, flag, counter, wdt in (("bf16", False, "wavernn_sample_loop",
                                       None),
                                      ("int8_weights=True", True,
                                       "wavernn_sample_loop_int8", "int8")):
        chunks, times, ran = stream(flag)
        paths[f"forward_stream_{wdt or 'bf16'}"] = ran
        firsts = [times[0]]
        if wdt is None:
            firsts += [stream(flag, True)[1][0] for _ in range(2)]
        want = {k: 0 for k in ran} | {counter: n_chunks}
        if ran != want:
            failures.append(f"forward stream ({label}) launches {ran}, "
                            f"want {want}")
        wav = np.concatenate(chunks)
        audio_s = wav.shape[0] / sr
        if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
                and wav.shape[0] == smel.shape[0] * hop):
            failures.append(f"forward stream ({label}) wav")
        # the streamed samples against one launch over the chunks'
        # conditioning, seed 1 (the stream's seed + 1)
        with torch.no_grad():
            conds = [streaming._chunk_cond(vm, ctx)[:n * hop] for ctx, n in
                     streaming._chunk_contexts([(smel + 4.0) / 8.0],
                                               FWD_STREAM_CHUNK, vm.pad,
                                               vm.feat_dims, dev)]
        wts = voc._loop_args(flag)["weights"]
        one, _ = wcell.wavernn_sample_loop(
            torch.cat(conds), wts, mode=vm.mode, n_classes=vm.n_classes,
            seed=1, weight_dtype=wdt)
        one = one[:, 0]
        if mu_law:
            one = mu_law_decode(one, vm.n_classes, from_labels=False)
        one = one.cpu().numpy()
        d_wav = (float(np.abs(wav - one).max()) if one.shape == wav.shape
                 else float("inf"))
        if d_wav != 0.0:
            failures.append(f"forward stream ({label}) samples")
        say(cl, f"forward stream ({label}) of {FWD_STREAM_TEXT!r}: "
                f"{smel.shape[0]} frames in {len(chunks)} chunks of "
                f"{FWD_STREAM_CHUNK}, {audio_s:.3f} s in {times[-1]:.3f} s, "
                f"stream RTF {times[-1] / audio_s:.4f}; first audio "
                f"{min(firsts):.4f} s (best of {len(firsts)}: "
                f"{', '.join(f'{x:.4f}' for x in firsts)}); samples against "
                f"one launch over the chunks' conditioning: max |d| "
                f"{d_wav:.3e} (tol 0); launches {ran}")
        # the second chunk (interior, one row) against the plain version,
        # from the state the kernel leaves after the first, on the seeded
        # weights: the vocoder's clip every sample of this chunk
        sw = seeded[wdt]
        u0 = torch.rand(conds[0].shape[0], 1,
                        wcell.n_draw(vm.mode, vm.n_classes, sw.n_out),
                        device=dev, generator=torch.Generator(dev).manual_seed(
                            9))
        _, st = wcell.wavernn_sample_loop(conds[0], sw, mode=vm.mode,
                                          n_classes=vm.n_classes, noise=u0,
                                          weight_dtype=wdt)
        held(cl, vm, "the forward stream's second chunk, from the first's "
             "state, seeded random weights", conds[1], sw, wdt, failures,
             state=st)

    # a conv-decoder AR model with prosody statistics (configs/default's AR
    # widths, 2 dense + 2 conv blocks in the encoder and the decoder),
    # seeded weights, a stop head that never fires
    cfg = load_config(CONFIG, "autoregressive")
    cfg.update(encoder_dense_blocks=2, decoder_dense_blocks=2,
               use_prosody_stats=True)
    cdir = ROOT / "build" / "phase8_config"
    cdir.mkdir(parents=True, exist_ok=True)
    (cdir / "data_config.yaml").write_text(
        (CONFIG / "data_config.yaml").read_text())
    (cdir / "autoregressive_config.yaml").write_text(yaml.safe_dump(cfg))
    vocab = text_pipeline(cfg, "grapheme").tokenizer.vocab_size
    flat = seeded_flat(build_tts(cfg, vocab), 12)
    flat["['Postnet']['stop_linear']['kernel']"][:] = 0.0
    flat["['Postnet']['stop_linear']['bias']"][:] = [10.0, 0.0, -10.0]
    conv = TTSSynthesizer(cdir, flat, "cuda", step=14000,
                          phonemizer_backend="grapheme")
    r = conv.r
    conv.predict(SENTENCE, ref_mel, spk, max_length=CONV_MAX_LENGTH)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = conv.predict(SENTENCE, ref_mel, spk, max_length=CONV_MAX_LENGTH,
                       seed=0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / out["steps"] * 1e3
    ran = paths["conv_ar"] = read_launches()
    if any(ran.values()):
        failures.append(f"conv-decoder predict launches {ran}")
    mel_s = np.concatenate(list(conv.stream_mels(
        SENTENCE, ref_mel, spk, mel_chunk=STREAM_CHUNK,
        max_length=CONV_MAX_LENGTH, seed=0)))
    inp, ref, spk_t = conv._stream_inputs(SENTENCE, ref_mel, spk)
    with torch.no_grad():
        ap = autoregressive_predict(
            conv.model, inp, ref, spk_t, r=r, max_length=CONV_MAX_LENGTH,
            prenet_dropout=conv.prenet_dropout,
            generator=torch.Generator(dev).manual_seed(0))
    mel_p = ap["mel"][0, :ap["mel_length"]].cpu().numpy()
    same = (mel_s.shape == mel_p.shape == out["mel"].shape
            and np.array_equal(mel_s, mel_p)
            and np.array_equal(out["mel"], mel_p))
    say(cl, f"conv-decoder AR model (2 dense + 2 conv blocks, prosody "
            f"statistics, r = {r}): {out['steps']} steps, "
            f"{out['mel'].shape[0]} frames, predict {step_ms:.3f} ms/step "
            f"(host, synchronised); launches {ran}; stream_mels (chunks of "
            f"{STREAM_CHUNK} steps) and predict against "
            f"autoregressive_predict, bit for bit: {same}")
    if not same or not np.isfinite(mel_p).all():
        failures.append("conv-decoder chunked stream vs autoregressive_predict")
    return paths


def write_corpus(d: Path, n: int, seed: int = 0):
    """A corpus in create_dataset.py's layout: ``train_metafile.txt``
    (``id|text|phonemes``), ``mels/{id}.npy`` (t, 80) in [-4, 4] with t in
    120-1000 (1.5-12.5 s at a 12.5 ms hop), ``spk_embeds/{id}.npy`` (256,),
    15-110 phoneme symbols an utterance; smooth seeded mels (slow sinusoids
    over time and frequency plus noise)."""
    import numpy as np
    from etts_torch.text.symbols import _phonemes
    rng = np.random.default_rng(seed)
    (d / "mels").mkdir(parents=True, exist_ok=True)
    (d / "spk_embeds").mkdir(exist_ok=True)
    alpha = sorted(_phonemes)
    lines = []
    for i in range(n):
        t = int(rng.integers(120, 1001))
        ph = rng.uniform(0, 2 * np.pi, 3)
        f = np.arange(80)[None] / 80.0
        tt = np.arange(t)[:, None] / 100.0
        mel = (2.5 * np.sin(2 * np.pi * (0.7 * tt + f) + ph[0])
               * np.cos(2 * np.pi * 2 * f + ph[1])
               - 1.0 + 0.3 * rng.standard_normal((t, 80)))
        np.save(d / "mels" / f"utt{i:03d}.npy",
                np.clip(mel, -4, 4).astype(np.float32))
        spk = rng.standard_normal(256).astype(np.float32)
        np.save(d / "spk_embeds" / f"utt{i:03d}.npy", spk / np.linalg.norm(spk))
        phon = "".join(rng.choice(alpha, int(rng.integers(15, 111))))
        lines.append(f"utt{i:03d}|Utterance number {i}.|{phon}\n")
    (d / "train_metafile.txt").write_text("".join(lines))


def step_split(cl, label, state, run, reps=5, prof_steps=3):
    """Where a train step's time goes, on the card: ``reps`` calls of
    ``run``, one Adam step of the ``TrainState`` ``state`` each (after 2
    warm-up steps), each split by the host clock, synchronised, into the
    gradient (``torch.autograd.grad``), the Adam update and the rest (the
    forward pass and the losses); then ``prof_steps`` steps under
    ``torch.profiler``:
    the device's busy time (the sum of the kernels' times) over the
    profiled and over the unprofiled step, the kernels a step, and the five
    kernels that take the most device time. Returns the split's medians
    in ms (step, forward and losses, gradient, Adam)."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize
    split = {"grad": 0.0, "adam": 0.0}

    def timed(fn, key):
        def wrapped(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            split[key] += time.perf_counter() - t0
            return out
        return wrapped

    for _ in range(2):
        run()
    grad = torch.autograd.grad
    state.apply_gradients = timed(state.apply_gradients, "adam")
    rows = []
    try:
        torch.autograd.grad = timed(grad, "grad")
        for _ in range(reps):
            split.update(grad=0.0, adam=0.0)
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            total = time.perf_counter() - t0
            rows.append((total, split["grad"], split["adam"]))
    finally:
        torch.autograd.grad = grad
    del state.apply_gradients
    med = [statistics.median(x) * 1e3 for x in zip(*rows)]
    split_ms = (med[0], med[0] - med[1] - med[2], med[1], med[2])
    say(cl, f"{label} split (median of {reps}, host clock, synchronised "
            f"around each part): {med[0]:.2f} ms = forward and losses "
            f"{split_ms[1]:.2f} + gradient {med[1]:.2f} + Adam "
            f"{med[2]:.2f}")
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            run()
        sync()
    wall = (time.perf_counter() - t0) / prof_steps * 1e3
    # device-side events, not the annotation ranges the profiler also
    # puts on the device's timeline (``Optimizer.step#Adam.step``)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    busy = sum(e.device_time for e in kernels) / prof_steps / 1e3
    if not kernels:
        say(cl, f"{label} under torch.profiler: no device time recorded "
                "(device busy share not measured)")
        return split_ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.device_time / prof_steps / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say(cl, f"{label} under torch.profiler ({prof_steps} steps): "
            f"{wall:.2f} ms/step "
            f"wall, device busy {busy:.2f} ms/step ({busy / wall:.1%} of it, "
            f"{busy / med[0]:.1%} of the unprofiled step), "
            f"{len(kernels) / prof_steps:.0f} kernels a step; most device "
            "time: "
            + "; ".join(f"{n[:60]} {t:.2f} ms" for n, t in top))
    return split_ms


def run_main(main, argv):
    """Run an entry point's ``main(argv)`` in this process (a process of
    its own takes some 8 s to reach the card), its stdout kept. Returns
    (seconds, stdout, the bytes the process held on the card before it):
    a driver's logged ``max_memory_allocated`` less these is its own
    peak."""
    import contextlib
    import io
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, buf.getvalue(), base


def grad_capture(model, schedule):
    """A ``TrainState`` of ``model`` whose ``apply_gradients`` keeps the
    gradients on the CPU (``.grads``, in ``.names``' order) and updates
    nothing."""
    from etts_torch.train.state import TrainState

    class Grads(TrainState):
        def apply_gradients(self, grads):
            self.grads = [g.detach().cpu() for g in grads]
            self.step += 1
    return Grads(model, schedule)


def worst_grad(names, got, want, atol):
    """(the largest (||got - want|| - atol) / ||want|| over the
    gradients, its parameter's name): within RTOL where every gradient
    has ||d|| <= RTOL * ||want|| + atol."""
    return max(((float((a - b).norm()) - atol) / max(float(b.norm()), 1e-30),
                n) for n, a, b in zip(names, got, want))


def phase9_config():
    """Phase 9's corpus (``write_corpus``, TRAIN_CORPUS utterances) and its
    config dir, configs/default's with phase 9's cuts, written anew under
    build/ (the logs emptied); returns (corpus, config dir). Phases 11-14
    and 16 read both."""
    import shutil
    import yaml
    build = ROOT / "build"
    corpus, cdir = build / "phase9_corpus", build / "phase9_config"
    logs = build / "phase9_logs"
    for x in (corpus, cdir, logs):
        shutil.rmtree(x, ignore_errors=True)
    write_corpus(corpus, TRAIN_CORPUS)
    cdir.mkdir(parents=True)
    data = yaml.safe_load((CONFIG / "data_config.yaml").read_text())
    data.update(train_data_directory=str(corpus), log_directory=str(logs))
    (cdir / "data_config.yaml").write_text(yaml.safe_dump(data))
    cfg = yaml.safe_load((CONFIG / "autoregressive_config.yaml").read_text())
    cfg.update(use_mine=True, mine_batch_size_schedule=[[0, 8]],
               weights_save_frequency=10, prediction_frequency=10,
               prediction_start_step=0)
    (cdir / "autoregressive_config.yaml").write_text(yaml.safe_dump(cfg))
    return corpus, cdir


def train_phase(cl, ref_mel, spk, failures):
    """Phase 9: training configs/default's AR model (d 256, 4 + 4 blocks,
    FFN 1024, GST, postnet 5 x 256, r = 10 from the schedule,
    tts_batch_size 8) with ``use_mine`` and the three default pairs (KL,
    the first-order critic) on a seeded corpus of TRAIN_CORPUS utterances
    (``write_corpus``). Cut for the smoke test: mine_batch_size_schedule
    [[0, 8]] (from 256: the corpus holds 64), weights_save_frequency and
    prediction_frequency 10 (from 10 000), prediction_start_step 0 (from
    20 000). Failed checks go to ``failures``; returns the launches of the
    trained export's decode ({"train_serve": read_launches()})."""
    import statistics
    import numpy as np
    import torch
    from etts_torch.api import TTSSynthesizer
    from etts_torch.convert import export_flat
    from etts_torch.data.dataset import DataPrepper, Dataset, load_files
    from etts_torch.models.init import init_flax
    from etts_torch.ops.kernels import decoder_step as dstep
    from etts_torch.text import default_tokenizer
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import make_autoregressive_train_step
    from etts_torch.train_autoregressive import SEED, to_device
    from etts_torch.utils.config import ConfigManager, build_tts
    from etts_torch.utils.logging import read_scalars
    dev = torch.device("cuda")
    corpus, cdir = phase9_config()
    cm = ConfigManager(cdir, "autoregressive", "phase9")
    c = cm.config
    tok = default_tokenizer(True)
    samples, _ = load_files(corpus / "train_metafile.txt", corpus / "mels",
                            corpus / "spk_embeds")

    # one step on the card against the CPU, dropout 0, from the same init
    host = Dataset(samples, DataPrepper(c, tok), c["tts_batch_size"],
                   mel_channels=c["mel_channels"]).next_batch()
    r = c["reduction_factor_schedule"][0][1]
    runs = {}
    for where in ("cpu", "cuda"):
        model = build_tts(dict(c, dropout_rate=0.0), tok.vocab_size)
        init_flax(model, torch.Generator().manual_seed(SEED)).to(where)
        state = grad_capture(model, c["learning_rate_tts_schedule"])
        t0 = time.perf_counter()
        met, _ = make_autoregressive_train_step(
            model, stop_scaling=c["stop_loss_scaling"])(
            state, to_device(host, where), 0.0, 0, r=r, prenet_dropout=0.0)
        runs[where] = (float(met["loss"]), state.grads,
                       time.perf_counter() - t0)
        n_params = sum(p.numel() for p in model.parameters())
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = runs["cpu"], runs["cuda"]
    d_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = worst_grad(state.names, g_gpu, g_cpu, TRAIN_GRAD_ATOL)
    ok = d_loss <= TRAIN_LOSS_TOL and worst[0] <= TRAIN_GRAD_RTOL
    say(cl, f"train step, card vs CPU (float32, TF32 off, {n_params} "
            f"parameters, batch {host[0].shape}, r = {r}): loss {l_gpu:.7f} "
            f"vs {l_cpu:.7f} (relative {d_loss:.2e}, tol {TRAIN_LOSS_TOL}); "
            f"worst gradient {worst[1]}: (|d| - {TRAIN_GRAD_ATOL}) / |g| "
            f"{worst[0]:.2e} (tol {TRAIN_GRAD_RTOL}); first step {s_gpu:.3f} "
            f"s on the card, {s_cpu:.3f} s on the CPU")
    if not ok:
        failures.append("train step, card vs CPU")
    state = TrainState(model, c["learning_rate_tts_schedule"])
    ar_step = make_autoregressive_train_step(
        model, stop_scaling=c["stop_loss_scaling"])
    batch = to_device(host, "cuda")
    step_split(cl, "train step", state, lambda: ar_step(
        state, batch, 0.0, 0, r=r, prenet_dropout=0.0))

    # the driver: 20 steps, then resumed to 30
    from etts_torch.train_autoregressive import main as train_main
    outs, bases = [], {}
    for steps in TRAIN_STEPS:
        secs, out, bases[steps - 1] = run_main(train_main, [
            "--config", str(cdir), "--session_name", "phase9",
            "--max_steps", str(steps)])
        outs.append(out)
        say(cl, f"train_autoregressive --max_steps {steps}: {secs:.1f} s; "
                + " | ".join(out.strip().splitlines()[-4:]))
    if f"restored TTS weights at step {TRAIN_STEPS[0]}" not in outs[1]:
        failures.append("the resumed run did not restore step 20")
    sc = read_scalars(cm.log_dir)
    losses = sc["train/loss"]
    span = range(5, TRAIN_STEPS[0])
    step_ms = [sc["time/step_ms"][i] for i in span]
    frames = sum(sc["meta/target_frames"][i] for i in span)
    mine_ms = statistics.median(sc["time/mine_ms"][i] for i in span)
    peak = sc.get("meta/max_memory_allocated", {})
    if sorted(peak) != [n - 1 for n in TRAIN_STEPS]:
        failures.append("the driver logged no peak memory")
    say(cl, f"training, steps 5-{TRAIN_STEPS[0]} (host clock, synchronised):"
            f" median {statistics.median(step_ms):.2f} ms/step (min "
            f"{min(step_ms):.2f}, max {max(step_ms):.2f}); "
            f"{frames / sum(step_ms) * 1e3:.0f} target frames/s; MINE zoo "
            f"{mine_ms:.2f} ms/step; peak memory of the run "
            + ", ".join(f"{(v - bases.get(k, 0)) / 2**30:.3f} GiB (run to "
                        f"{k + 1})" for k, v in sorted(peak.items()))
            + f"; losses {dict(sorted(losses.items()))}")
    if not (sorted(losses) == [0, 10, 19, 20, 29]
            and all(math.isfinite(v) for v in losses.values())):
        failures.append(f"training losses {losses}")
    if TRAIN_STEPS[0] - 1 in peak:
        F32_TRAIN["autoregressive"] = {
            "ms": statistics.median(step_ms),
            "fps": frames / sum(step_ms) * 1e3,
            "gib": (peak[TRAIN_STEPS[0] - 1] - bases[TRAIN_STEPS[0] - 1])
            / 2**30}

    # the trained statistics, and the export through the fused decode
    tree = torch.load(cm.weights_dir / f"ckpt-{TRAIN_STEPS[1]}.pt",
                      map_location="cpu", weights_only=True)
    model = build_tts(c, tok.vocab_size)
    model.load_state_dict(tree["model"])
    init = {"running_mean": 0.0, "running_var": 1.0}
    stale = [k for k, v in tree["model"].items()
             if k.rsplit(".", 1)[-1] in init
             and bool((v == init[k.rsplit(".", 1)[-1]]).all())]
    n_bn = sum(k.rsplit(".", 1)[-1] in init for k in tree["model"])
    say(cl, f"after {tree['step']} steps: {n_bn - len(stale)} of {n_bn} "
            f"BatchNorm statistics moved from their init")
    if stale or tree["step"] != TRAIN_STEPS[1]:
        failures.append(f"BatchNorm statistics at their init: {stale[:4]}")
    tts = TTSSynthesizer(cdir, export_flat(model), "cuda",
                         step=TRAIN_STEPS[1], phonemizer_backend="grapheme")
    zero_launches()
    out = tts.predict(SENTENCE, ref_mel, spk, max_length=TRAIN_MAX_LENGTH,
                      seed=0)
    torch.cuda.synchronize()
    ran = read_launches()
    m = tts.model
    with torch.no_grad():
        ids = torch.from_numpy(tts.encode_text(SENTENCE))[None].to(dev)
        ref = m.encode_ref(torch.from_numpy(ref_mel).to(dev), tts.r)
        enc = m.encode(ids, ref, torch.from_numpy(spk).to(dev)[None, None])[0]
    w = dstep.decode_weights(m, enc, tts.r, torch.bfloat16)
    max_steps = TRAIN_MAX_LENGTH // tts.r + 1
    kw = dict(max_steps=max_steps, prenet_dropout=tts.prenet_dropout)
    ok = np.isfinite(out["mel"]).all()
    # as predict decodes, and with the stop off, so that every step runs
    # the trained postnet
    for label, stop in (("as predict", True), ("stop off", False)):
        k_mel, k_len, _ = dstep.fused_decode(w, stop_enabled=stop, **kw)
        p_mel, p_len, _ = dstep.fused_decode_plain(w, teacher=k_mel,
                                                   stop_enabled=stop, **kw)
        n = max(k_len, p_len)
        err = float((k_mel[:n] - p_mel[:n]).abs().max())
        say(cl, f"trained export, fused_decode vs plain ({label}): length "
                f"{k_len} vs {p_len}, max |dmel| {err:.3e} (tol "
                f"{DECODE_TOL})")
        ok = ok and k_len == p_len and err <= DECODE_TOL
        if stop:
            same = np.array_equal(out["mel"], k_mel[:k_len].cpu().numpy())
        else:
            ok = ok and k_len == max_steps * tts.r
    say(cl, f"trained export (step {TRAIN_STEPS[1]}, r = {tts.r}, prenet "
            f"dropout {tts.prenet_dropout}): predict -> {out['mel'].shape[0]}"
            f" frames in {out['steps']} steps, launches {ran}; predict's mel "
            f"is the kernel's: {same}")
    want = {k: int(k == "fused_decode") for k in ran}
    if not (ok and ran == want and same):
        failures.append("the trained export through the fused decode")
    return {"train_serve": ran}


def forward_train_phase(cl, voc, failures):
    """Phase 11: the forward model's training flow, the reference's own
    (train the AR model down to r = 1, extract durations, train the
    forward model), at configs/default's full widths on phase 9's seeded
    corpus, each entry point's ``main`` run in this process (a process of
    its own takes some 8 s to reach the card):
      1. ``train_autoregressive`` (d 256, 4 + 4 blocks, FFN 1024, GST,
         postnet 5 x 256, batch 8) for FT_AR_STEPS steps, cut to
         ``reduction_factor_schedule`` [[0, 1]] (from [[0, 10], [80000,
         1]]), ``use_mine`` False, ``weights_save_frequency`` FT_AR_STEPS;
      2. ``extract_durations`` on the card: the triple count of each split
         (the test split: the corpus's last FT_VAL utterances, also in the
         training split) against its metafile, every triple's durations
         summing to its mel's frames; then the card against the CPU on
         FT_CPU_ROWS rows from the same checkpoint (FT_ATT_TOL, FT_TIE);
      3. one forward train step (forward_config.yaml: d 256, 4 + 4 blocks,
         FFN 1024, postnet 5 x 256, ``max_frames`` 1280), the card against
         the CPU on FT_CPU_ROWS triples, dropout 0, the same init: in
         float64 at FT_LOSS_TOL, FT_GRAD_* and FT_STATS_TOL, and in float32
         at phase 9's TRAIN_* bars and FT_STATS_TOL, each float32 side also
         held against the CPU's float64 step at FT_GRAD_RTOL (the
         attention's renormalised softmax keeps ``wk``'s nearly cancelling
         gradient there), and again with the attention's softmax in
         float64 on the card and plain float32 ``torch.softmax`` on both
         devices (printed, not checks); the step's split at
         ``tts_batch_size`` 16;
      4. ``train_forward`` to FT_STEPS[0] steps, then resumed to
         FT_STEPS[1], against one run to FT_STEPS[1]: the restore, the
         step time, target frames a second, peak memory, and the largest
         difference of the two sessions' weights at FT_STEPS[0] (two
         uninterrupted runs: the gather's backward sums by atomics on the
         card) and at FT_STEPS[1] (one resumed); cuts:
         ``prediction_frequency`` and ``weights_save_frequency`` 10 (from
         10 000);
      5. the step-30 export through TTSSynthesizer(model_kind="forward")
         and the bf16 vocoder: text -> wav for FT_TEXT, the launches read
         around it (the sample loop once, nothing else), that sample-loop
         call held against its plain version (phase 3's bar), the RTF.
    The losses, durations and wav say nothing of quality (seeded mels).
    Failed checks go to ``failures``; returns {"forward_train_serve":
    read_launches()}."""
    import contextlib
    import io
    import shutil
    import statistics
    import numpy as np
    import torch
    import yaml
    from etts_torch import extract_durations, train_autoregressive
    from etts_torch import train_forward
    from etts_torch.align import normalized_durations
    from etts_torch.api import TTSSynthesizer
    from etts_torch.convert import export_flat
    from etts_torch.data.dataset import (DataPrepper, Dataset,
                                         ForwardDataPrepper, load_files)
    from etts_torch.models.init import init_flax
    from etts_torch.text import default_tokenizer
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import (make_autoregressive_val_step,
                                        make_forward_train_step)
    from etts_torch.utils.config import ConfigManager, build_forward
    from etts_torch.utils.logging import read_scalars
    build = ROOT / "build"
    corpus = build / "phase9_corpus"
    cdir, logs = build / "phase11_config", build / "phase11_logs"
    for x in (cdir, logs, corpus / "forward_data"):
        shutil.rmtree(x, ignore_errors=True)
    lines = (corpus / "train_metafile.txt").read_text().splitlines(True)
    (corpus / "test_metafile.txt").write_text("".join(lines[-FT_VAL:]))
    cdir.mkdir(parents=True)
    for kind, over in (
            ("data", dict(train_data_directory=str(corpus),
                          log_directory=str(logs))),
            ("autoregressive", dict(reduction_factor_schedule=[[0, 1]],
                                    use_mine=False,
                                    weights_save_frequency=FT_AR_STEPS)),
            ("forward", dict(prediction_frequency=10,
                             weights_save_frequency=10))):
        cfg = yaml.safe_load((CONFIG / f"{kind}_config.yaml").read_text())
        cfg.update(over)
        (cdir / f"{kind}_config.yaml").write_text(yaml.safe_dump(cfg))

    def entry(main, *args):
        return run_main(main, ["--config", str(cdir), *args])

    # 1. the AR model to r = 1
    secs, out, _ = entry(train_autoregressive.main, "--session_name",
                         "phase11", "--max_steps", str(FT_AR_STEPS))
    cm = ConfigManager(cdir, "autoregressive", "phase11")
    ar_ms = read_scalars(cm.log_dir)["time/step_ms"]
    say(cl, f"train_autoregressive at r = 1, {FT_AR_STEPS} steps: "
            f"{secs:.1f} s, median {statistics.median(ar_ms.values()):.1f} "
            f"ms/step (first {ar_ms[0]:.1f}); "
            + " | ".join(out.strip().splitlines()[-2:]))

    # 2. the durations, on the card, then card against CPU on a few rows
    secs, out, _ = entry(extract_durations.main, "--session_name",
                         "phase11")
    n_utt, bad_sums = 0, []
    for split, metafile in extract_durations.SPLITS:
        want = len((corpus / metafile).read_text().splitlines())
        files = sorted((corpus / "forward_data" / split).glob("*.npy"))
        n_utt += len(files)
        if len(files) != want:
            failures.append(f"extract_durations: {len(files)} {split} "
                            f"triples for {want} rows")
        for f in files:
            mel, ids, dur = np.load(f, allow_pickle=True)
            if not (dur.sum() == mel.shape[0] and dur.shape == ids.shape
                    and np.isfinite(mel).all()):
                bad_sums.append(f.name)
    if bad_sums:
        failures.append(f"extract_durations: triples {bad_sums[:4]}")
    say(cl, f"extract_durations on the card: {n_utt} utterances in "
            f"{secs:.2f} s, {secs / max(n_utt, 1) * 1e3:.2f} ms an "
            f"utterance (host clock, the checkpoint's load included); "
            + " | ".join(ln for ln in out.splitlines() if "wrote" in ln)
            + f"; every triple's durations sum to its frames: "
            f"{not bad_sums}")
    samples, _ = load_files(corpus / "train_metafile.txt", corpus / "mels",
                            corpus / "spk_embeds")
    host = Dataset(samples[:FT_CPU_ROWS],
                   DataPrepper(cm.config, default_tokenizer(True)),
                   FT_CPU_ROWS, shuffle=False,
                   mel_channels=cm.config["mel_channels"]).next_batch()
    got = {}
    for where in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            model = cm.load_model(device=where)[0]
        val_step = make_autoregressive_val_step(
            model, stop_scaling=cm.config["stop_loss_scaling"])
        got[where] = extract_durations.extract_batch(val_step, host, where)
    (att_g, tri_g), (att_c, tri_c) = got["cuda"], got["cpu"]
    d_att = float(np.abs(att_g - att_c).max())
    mel_lens = (np.abs(host[0]).sum(-1) != 0).sum(-1)
    phon_lens = (host[1] != 0).sum(-1)
    off, ties = 0, True
    for i in range(FT_CPU_ROWS):
        k = np.nonzero(tri_g[i][2] != tri_c[i][2])[0]
        norm = normalized_durations(att_c[i], int(mel_lens[i]),
                                    int(phon_lens[i]), weighted=True)[k]
        off += k.size
        ties = ties and bool((np.abs(norm - np.floor(norm) - 0.5)
                              <= FT_TIE).all())
    say(cl, f"extraction, card vs CPU ({FT_CPU_ROWS} rows of "
            f"{mel_lens.tolist()} frames, float32): last block's attention "
            f"max |d| {d_att:.3e} (tol {FT_ATT_TOL}); durations differing "
            f"at {off} tokens, each at a rounding tie (within {FT_TIE} of a "
            f"half-integer): {ties}")
    if not (d_att <= FT_ATT_TOL and ties):
        failures.append("extraction, card vs CPU")

    # 3. one forward train step, card against CPU, in float64 (the bars)
    # and in float32 (phase 9's bars); the step's split
    cmf = ConfigManager(cdir, "forward", "phase11")
    cf = cmf.config
    cap = int(cf["max_frames"])
    vocab = default_tokenizer(False).vocab_size
    files = sorted((corpus / "forward_data" / "train").glob("*.npy"))
    fhost = Dataset(files[:FT_CPU_ROWS], ForwardDataPrepper(), FT_CPU_ROWS,
                    shuffle=False, mel_channels=cf["mel_channels"],
                    pad_mel_multiple=cap).next_batch()
    runs = {}
    for dt in (torch.float64, torch.float32):
        for where in ("cpu", "cuda"):
            model = build_forward(cf, vocab, dropout_rate=0.0)
            init_flax(model, torch.Generator().manual_seed(
                train_autoregressive.SEED)).to(where, dt)
            state = grad_capture(model, cf["learning_rate_tts_schedule"])
            mel, ids, dur = train_forward.to_device(fhost, where)
            t0 = time.perf_counter()
            met = make_forward_train_step(model, cap)(
                state, (mel.to(dt), ids, dur.to(dt)), 0)
            stats = {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            runs[where, dt] = (float(met["loss"]), state.grads, stats,
                               time.perf_counter() - t0)
    n_params = sum(p.numel() for p in model.parameters())
    exact = runs["cpu", torch.float64][1]
    for dt, loss_tol, rtol, atol in (
            (torch.float64, FT_LOSS_TOL, FT_GRAD_RTOL, FT_GRAD_ATOL),
            (torch.float32, TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)):
        (l_c, g_c, st_c, s_c), (l_g, g_g, st_g, s_g) = (runs["cpu", dt],
                                                        runs["cuda", dt])
        d_loss = abs(l_g - l_c) / abs(l_c)
        worst = worst_grad(state.names, g_g, g_c, atol)
        d_stats = max(float((st_g[k] - st_c[k]).abs().max()) for k in st_c)
        line = (f"forward train step, card vs CPU ({dt}, TF32 off, "
                f"{n_params} parameters, batch {fhost[0].shape}): loss "
                f"{l_g:.7f} vs {l_c:.7f} (relative {d_loss:.2e}, tol "
                f"{loss_tol}); worst gradient {worst[1]}: (|d| - {atol}) / "
                f"|g| {worst[0]:.2e} (tol {rtol}); BatchNorm statistics max "
                f"|d| {d_stats:.2e} (tol {FT_STATS_TOL}); first step "
                f"{s_g:.3f} s on the card, {s_c:.3f} s on the CPU")
        vs64 = 0.0
        if dt == torch.float32:
            # each side against the CPU's float64 step: the card's float32
            # rounding beside the CPU's
            vs = {w: worst_grad(state.names,
                                [g.double() for g in runs[w, dt][1]], exact,
                                atol)[0] for w in ("cuda", "cpu")}
            vs64 = max(vs.values())
            line += (f"; worst against the CPU's float64 step (tol "
                     f"{FT_GRAD_RTOL}): " + ", ".join(
                         f"{w} {e:.2e}" for w, e in vs.items()))
        say(cl, line)
        if not (d_loss <= loss_tol and worst[0] <= rtol
                and d_stats <= FT_STATS_TOL and vs64 <= FT_GRAD_RTOL):
            failures.append(f"forward train step, card vs CPU ({dt}): loss "
                            f"{d_loss:.2e}, gradient {worst[0]:.2e} "
                            f"({worst[1]}), statistics {d_stats:.2e}, "
                            f"against float64 {vs64:.2e}")
    # the float32 step again with other softmaxes in the attention
    # (models/layers.py::attention), against the CPU's float64 step: in
    # float64 on the card (what is left of the float32 rounding once the
    # softmax is exact), and float32 torch.softmax without the attention's
    # renormalisation on both devices (the attention before it)
    from etts_torch.models import layers

    def softmax_as(mode):
        def attend(q, k, v, mask=None):
            logits = q @ k.transpose(-1, -2) / (k.shape[-1] ** 0.5)
            if mask is not None:
                logits = logits + mask * -1e9
            w = (torch.softmax(logits.double(), dim=-1).float()
                 if mode == "float64" else torch.softmax(logits, dim=-1))
            return w @ v, w
        return attend
    reads = []
    for mode, where in (("float64", "cuda"), ("plain float32", "cuda"),
                        ("plain float32", "cpu")):
        attention, layers.attention = layers.attention, softmax_as(mode)
        try:
            model = build_forward(cf, vocab, dropout_rate=0.0)
            init_flax(model, torch.Generator().manual_seed(
                train_autoregressive.SEED)).to(where)
            state = grad_capture(model, cf["learning_rate_tts_schedule"])
            make_forward_train_step(model, cap)(
                state, train_forward.to_device(fhost, where), 0)
        finally:
            layers.attention = attention
        reads.append("{} softmax on the {} {:.2e}".format(
            mode, "card" if where == "cuda" else "CPU", worst_grad(
                state.names, [g.double() for g in state.grads], exact,
                TRAIN_GRAD_ATOL)[0]))
    say(cl, "forward train step in float32, the attention's softmax "
            "replaced: worst gradient against the CPU's float64 step: "
            + ", ".join(reads) + " (not a check)")
    model = build_forward(cf, vocab)
    init_flax(model, torch.Generator().manual_seed(0)).to("cuda")
    state = TrainState(model, cf["learning_rate_tts_schedule"])
    fstep = make_forward_train_step(model, cap)
    batch = train_forward.to_device(Dataset(
        files, ForwardDataPrepper(), cf["tts_batch_size"], shuffle=False,
        mel_channels=cf["mel_channels"], pad_mel_multiple=cap).next_batch(),
        "cuda")
    step_split(cl, "forward train step", state,
               lambda: fstep(state, batch, 0))
    del model, state, batch

    # 4. the driver: a run, then resumed, against one uninterrupted run
    outs, bases = [], {}
    for steps, session in ((FT_STEPS[0], "phase11"), (FT_STEPS[1], "phase11"),
                           (FT_STEPS[1], "phase11_once")):
        secs, out, base = entry(train_forward.main, "--session_name", session,
                                "--max_steps", str(steps))
        bases.setdefault(steps - 1, base)
        outs.append(out)
        say(cl, f"train_forward --max_steps {steps} ({session}): "
                f"{secs:.1f} s; " + " | ".join(out.strip().splitlines()[-3:]))
    if f"restored weights at step {FT_STEPS[0]}" not in outs[1]:
        failures.append(f"train_forward: no restore at step {FT_STEPS[0]}")
    sc = read_scalars(cmf.log_dir)
    span = range(5, FT_STEPS[0])
    step_ms = [sc["time/step_ms"][i] for i in span]
    frames = sum(sc["meta/target_frames"][i] for i in span)
    peak = sc.get("meta/max_memory_allocated", {})
    losses = sc["train/loss"]
    say(cl, f"forward training, steps 5-{FT_STEPS[0]} (host clock, "
            f"synchronised): median {statistics.median(step_ms):.2f} ms/step"
            f" (min {min(step_ms):.2f}, max {max(step_ms):.2f}); "
            f"{frames / sum(step_ms) * 1e3:.0f} target frames/s; "
            f"peak memory of the run "
            + ", ".join(f"{(v - bases[k]) / 2**30:.3f} GiB (run to {k + 1})"
                        for k, v in sorted(peak.items()))
            + f"; losses {dict(sorted(losses.items()))}; val loss "
            f"{dict(sorted(sc.get('val/loss', {}).items()))}")
    hist = sorted(p.name for p in cmf.log_dir.glob("val_durations_*.npy"))
    if not (sorted(losses) == [0, 10, 19, 20, 29]
            and all(math.isfinite(v) for v in losses.values())
            and sorted(peak) == [n - 1 for n in FT_STEPS]
            and sorted(sc.get("val/loss", {})) == [9, 19, 29]
            and len(hist) == 3):
        failures.append(f"forward training log: losses {losses}, peak "
                        f"{sorted(peak)}, histograms {hist}")
    once = ConfigManager(cdir, "forward", "phase11_once").weights_dir
    is_stat = lambda k: k.endswith(("running_mean", "running_var"))

    def apart(step):
        """Weights and statistics at ``step`` of the two sessions: (bit
        for bit equal, (largest difference of a weight, its name), (of a
        statistic, its name), tensors that differ, tensors)."""
        x, y = (torch.load(d / f"ckpt-{step}.pt", map_location="cpu",
                           weights_only=True)["model"]
                for d in (cmf.weights_dir, once))
        gaps = {k: float((x[k].double() - y[k].double()).abs().max())
                for k in x if x[k].is_floating_point()}
        top = [max(((v, k) for k, v in gaps.items() if is_stat(k) == st),
                   default=(0.0, "-")) for st in (False, True)]
        return (all(torch.equal(x[k], y[k]) for k in x), *top,
                sum(v > 0 for v in gaps.values()), len(gaps))

    for step, what in ((FT_STEPS[0], "two uninterrupted runs"),
                       (FT_STEPS[1], f"resumed at {FT_STEPS[0]} against "
                                     "uninterrupted")):
        same, w, st, n_diff, n = apart(step)
        say(cl, f"forward training, {what}, step {step}: bit-equal {same}; "
                f"largest difference of a weight {w[0]:.3e} ({w[1]}), of a "
                f"BatchNorm statistic {st[0]:.3e} ({st[1]}); {n_diff} of {n} "
                f"tensors differ")

    # 5. the step-30 export, text -> wav through the sample loop
    with contextlib.redirect_stdout(io.StringIO()):
        model, step, _ = cmf.load_model()
    tts = TTSSynthesizer(cdir, export_flat(model), "cuda",
                         phonemizer_backend="grapheme", model_kind="forward")
    tts.predict(FT_TEXT)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = tts.predict(FT_TEXT)["mel"]
    wav = voc.generate((mel + 4.0) / 8.0, seed=0)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    ran = read_launches()
    hop = voc.model.hop_length
    audio_s = wav.shape[0] / voc.config["sampling_rate"]
    want = {k: 0 for k in ran} | {"wavernn_sample_loop": 1}
    if ran != want:
        failures.append(f"trained forward export launches {ran}, want "
                        f"{want}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
            and wav.shape[0] == (mel.shape[0] - 1) * hop):
        failures.append("trained forward export wav")
    say(cl, f"trained forward export (step {step}): {FT_TEXT!r} -> "
            f"{mel.shape[0]} frames -> {wav.shape[0]} samples "
            f"({audio_s:.3f} s) in {e2e:.3f} s, RTF {e2e / audio_s:.4f}; "
            f"launches {ran}")
    held(cl, voc.model, "the trained forward export's mel",
         vocoder_cond(voc, mel), voc.weights, None, failures)
    return {"forward_train_serve": ran}


def _vocoder_step_check(cl, cdir, store, failures):
    """One vocoder train step, card against CPU on VT_CPU_ROWS crops from
    the same init (``init_flax``, seed 0), in MOL (the config's mode) and
    RAW (512 classes, the labels the mu-law of the same crops): in float64
    at the FT_* bars (the loss, each gradient, the BatchNorm statistics
    after the step within FT_STATS_TOL of their largest |value|); in
    float32 the loss at TRAIN_LOSS_TOL, the gradients printed beside each
    side's distance from the CPU's float64 step (at VT_CPU_ROWS rows the
    BatchNorms normalise 10 positions a channel and float32 leaves 2-5e-2
    of the gradients on either device). Then at the driver's batch (64
    crops, MOL), on two crop draws, the card's and the CPU's float32
    steps against the card's float64 step within VT_F32_GRAD, and the
    card's step with TF32 on past it: the MelResNet's BatchNorm biases,
    whose gradients nearly cancel, keep 2-3 digits in float32, on either
    device by turns."""
    import numpy as np
    import torch
    from etts_torch.data.dataset import VocoderDataset, collate_vocoder
    from etts_torch.models.init import init_flax
    from etts_torch.ops.normalizers import mu_law_encode
    from etts_torch.train.steps import make_wavernn_train_step
    from etts_torch.train_wavernn import INIT_SEED, to_device, vocoder_ids
    from etts_torch.utils.config import build_vocoder, load_config
    from etts_torch.utils.precision import pin_float32
    c = load_config(cdir, "wavernn")
    ids = vocoder_ids(store, c, False)

    def crops(rows, seed=0):
        ds = VocoderDataset(ids[:rows], store)
        return collate_vocoder([ds[i] for i in range(rows)],
                               c["voc_seq_len_hops"] * c["hop_length"],
                               c["hop_length"], c["voc_pad"],
                               mode=c["voc_mode"], bits=c["bits"],
                               rng=np.random.default_rng(seed))

    def step(mode, dt, where, batch, tf32=False):
        """(loss, gradients, statistics, seconds, parameter names); with
        ``tf32`` the card's matmuls and convolutions in TF32."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return _step(mode, dt, where, batch)
        finally:
            pin_float32()

    def _step(mode, dt, where, batch):
        model = build_vocoder(dict(c, voc_mode=mode))
        init_flax(model, torch.Generator().manual_seed(INIT_SEED)).to(
            where, dt)
        state = grad_capture(model, [[0, 1e-4]])
        x, y, mels = to_device(batch, where)
        y = (mu_law_encode(y, 2 ** c["bits"]).long() if mode == "RAW"
             else y.to(dt))
        t0 = time.perf_counter()
        met = make_wavernn_train_step(model)(state,
                                             (x.to(dt), y, mels.to(dt)))
        stats = {k: v.cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return (float(met["loss"]), [g.double() for g in state.grads],
                stats, time.perf_counter() - t0, state.names)

    host = crops(VT_CPU_ROWS)
    for mode in ("MOL", "RAW"):
        runs = {(w, dt): step(mode, dt, w, host)
                for dt in (torch.float64, torch.float32)
                for w in ("cpu", "cuda")}
        names = runs["cpu", torch.float64][4]
        for dt in (torch.float64, torch.float32):
            (l_c, g_c, st_c, s_c, _), (l_g, g_g, st_g, s_g, _) = (
                runs["cpu", dt], runs["cuda", dt])
            d_loss = abs(l_g - l_c) / abs(l_c)
            f64 = dt == torch.float64
            atol = FT_GRAD_ATOL if f64 else TRAIN_GRAD_ATOL
            worst = worst_grad(names, g_g, g_c, atol)
            d_stats = max(float((st_g[k] - st_c[k]).abs().max())
                          / float(st_c[k].abs().max()) for k in st_c)
            line = (f"vocoder train step, card vs CPU ({mode}, {dt}, TF32 "
                    f"off, x {tuple(host[0].shape)}, mels "
                    f"{tuple(host[2].shape)}): loss {l_g:.7f} vs {l_c:.7f} "
                    f"(relative {d_loss:.2e}, tol "
                    f"{FT_LOSS_TOL if f64 else TRAIN_LOSS_TOL}); worst "
                    f"gradient {worst[1]}: (|d| - {atol}) / |g| "
                    f"{worst[0]:.2e} (tol {FT_GRAD_RTOL if f64 else 'none'})"
                    f"; BatchNorm statistics max |d| / max |stat| "
                    f"{d_stats:.2e} (tol {FT_STATS_TOL if f64 else 'none'})"
                    f"; first step {s_g:.3f} s on the card, {s_c:.3f} s on "
                    "the CPU")
            if not f64:
                line += "; worst against the CPU's float64 step: " + ", ".join(
                    "{} {:.2e}".format(w, worst_grad(
                        names, runs[w, dt][1], runs["cpu", torch.float64][1],
                        atol)[0]) for w in ("cuda", "cpu"))
            say(cl, line)
            ok = (d_loss <= FT_LOSS_TOL and worst[0] <= FT_GRAD_RTOL
                  and d_stats <= FT_STATS_TOL) if f64 else (
                      d_loss <= TRAIN_LOSS_TOL)
            if not ok:
                failures.append(f"vocoder train step, card vs CPU ({mode}, "
                                f"{dt})")
    for seed in (0, 1):
        batch = crops(c["voc_batch_size"], seed)
        f64 = step("MOL", torch.float64, "cuda", batch)
        worst, line = {}, []
        for where, tf32 in (("cuda", False), ("cpu", False), ("cuda", True)):
            f32 = step("MOL", torch.float32, where, batch, tf32)
            name = where + (" TF32 (control)" if tf32 else "")
            worst[name] = worst_grad(f32[4], f32[1], f64[1], TRAIN_GRAD_ATOL)
            line.append(f"{name}: loss relative "
                        f"{abs(f32[0] - f64[0]) / abs(f64[0]):.2e}, worst "
                        f"gradient {worst[name][1]} {worst[name][0]:.2e}")
        say(cl, f"vocoder float32 train step at {c['voc_batch_size']} crops "
                f"(MOL, crop draw {seed}) against the card's float64 step "
                f"(tol {VT_F32_GRAD}; the control past it): "
                + "; ".join(line))
        if not (worst["cuda"][0] <= VT_F32_GRAD
                and worst["cpu"][0] <= VT_F32_GRAD
                and worst["cuda TF32 (control)"][0] > VT_F32_GRAD):
            failures.append(f"vocoder float32 train step at "
                            f"{c['voc_batch_size']} crops (draw {seed})")


def _deterministic_process(module, argv):
    """Start ``etts_torch.{module}``'s ``main(argv)`` in a process of its
    own under ``torch.use_deterministic_algorithms(True)``, cuDNN
    deterministic and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (read when
    cuBLAS starts, so set before the process touches the card)."""
    import os
    code = ("import sys, torch\n"
            "torch.use_deterministic_algorithms(True)\n"
            "torch.backends.cudnn.deterministic = True\n"
            "torch.backends.cudnn.benchmark = False\n"
            f"from etts_torch.{module} import main\n"
            "main(sys.argv[1:])\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(ROOT))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, argv)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _deterministic_runs(cdir, store):
    """Start VT_DET_STEPS-step ``train_wavernn`` runs, sessions "det_a"
    and "det_b", each in a process of its own
    (``_deterministic_process``). Returns the processes."""
    return [_deterministic_process("train_wavernn", [
        "--config", cdir, "--data", store, "--session_name", name,
        "--max_steps", VT_DET_STEPS]) for name in ("det_a", "det_b")]


def _refused_or_crashed(procs) -> tuple:
    """Wait for ``procs``: (the ops whose error is torch's RuntimeError
    "<op> does not have a deterministic implementation", the other
    failures' return codes and error tails)."""
    refused, crashed = [], []
    for p in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode == 0:
            continue
        last = (err.strip().splitlines() or [""])[-1]
        m = re.match(r"RuntimeError: (\S+) does not have a deterministic "
                     r"implementation", last)
        if m:
            refused.append(m.group(1))
        else:
            crashed.append(f"return code {p.returncode}: {err[-2000:]}")
    return refused, crashed


def _deterministic_outcome(cl, cdir, cm, det, failures):
    """Wait for ``_deterministic_runs``' processes and hold their
    step-VT_DET_STEPS checkpoints bit for bit (weights, statistics, Adam
    state); print how far the in-process run of session ``cm`` (default
    algorithms) is from them. A process whose error ends in torch's
    RuntimeError "<op> does not have a deterministic implementation" names
    that op (no failure: the check cannot be made); any other nonzero
    return goes to ``failures``."""
    import torch
    from etts_torch.utils.config import ConfigManager
    refused, crashed = _refused_or_crashed(det)
    if crashed:
        say(cl, "deterministic vocoder runs failed: " + " | ".join(crashed))
        failures.append("deterministic vocoder runs failed")
        return
    if refused:
        say(cl, "deterministic vocoder runs: ops without a deterministic "
                f"implementation on the card: {sorted(set(refused))}")
        return
    a, b = (torch.load(ConfigManager(cdir, "wavernn", n).weights_dir
                       / f"ckpt-{VT_DET_STEPS}.pt", map_location="cpu",
                       weights_only=True) for n in ("det_a", "det_b"))
    default = torch.load(cm.weights_dir / f"ckpt-{VT_DET_STEPS}.pt",
                         map_location="cpu", weights_only=True)
    same = lambda x, y: all(torch.equal(x["model"][k], y["model"][k])
                            for k in x["model"])
    opt = lambda o: [t for s in o["state"].values() for t in s.values()]
    bit_equal = same(a, b) and all(
        torch.equal(x, y) for x, y in zip(opt(a["optimizer"]),
                                          opt(b["optimizer"])))
    gap = max(float((a["model"][k].double()
                     - default["model"][k].double()).abs().max())
              for k in a["model"] if a["model"][k].is_floating_point())
    say(cl, f"two train_wavernn runs of {VT_DET_STEPS} steps under "
            "torch.use_deterministic_algorithms(True), cuDNN deterministic, "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 (each in a process of its "
            f"own): weights, statistics and Adam state bit-equal "
            f"{bit_equal}; the in-process run (default algorithms) at that "
            f"step bit-equal {same(a, default)}, largest difference "
            f"{gap:.3e}")
    if not bit_equal:
        failures.append("deterministic vocoder runs differ")


def vocoder_train_phase(cl, voc26, failures):
    """Phase 12: the vocoder's training flow, the reference's own (wavs ->
    store -> train -> checkpoints -> vocode; GTA mels of an AR checkpoint
    -> train on them), at configs/default's full width (MOL, rnn and fc
    512, compute and res_out 128, 10 res blocks, upsample (5, 5, 8), hop
    200, batch 64 crops of 5 hops), each entry point's ``main`` run in
    this process:
      1. VT_UTTS seeded wavs (``ref_wav``, VT_SECONDS long) through
         ``preprocess_wavernn`` on the card;
      2. one train step card against CPU (``_vocoder_step_check``) and
         the step's split at batch 64;
      3. ``train_wavernn`` for VT_STEPS[0] steps, then resumed to
         VT_STEPS[1], cut to ``voc_checkpoint_every`` VT_CKPT (from
         25 000), ``voc_gen_at_checkpoint`` 1 (from 5),
         ``voc_test_samples`` 4 (from 50): the restore, the utterances of
         every step against the permutation stream replayed, the step
         time, target samples a second, peak memory, a wav a checkpoint
         (B1);
      4. the last checkpoint's export (``export_flat``, with its moved
         ``batch_stats:``) through VocoderSynthesizer (bf16) on a held-out
         utterance, timed: the launches read around it (B1 once), the
         share of samples at |x| >= 0.999 beside the 26k export's on the
         same mel;
      5. two deterministic VT_DET_STEPS-step runs in processes of their
         own (``_deterministic_runs``), started here and read at the end
         (5-7 share the card with them: the times 6 and 7 print are read
         as such); B1 on the conditioning of the test utterances, one
         step at a time from the same state against exact sums
         (``one_step_check`` in MOL, with its float32-activation control:
         STATE_TOL_TRAINED, SAMPLE_MARGIN_TRAINED);
      6. ``gen_wavernn --data`` (the store's last 2) and ``--file``;
      7. ``make_gta`` on phase 11's r = 1 AR session over phase 9's corpus,
         card against CPU on VT_CPU_ROWS rows (VT_GTA_TOL); a store of the
         GTA mels with seeded audio of each mel's length (``quant/`` and
         ``dataset.pkl`` written here), and ``train_wavernn --gta`` for
         VT_GTA_STEPS steps at ``--batch_size`` VT_GTA_BATCH (the corpus
         holds 64 utterances);
      8. the deterministic runs' step-VT_DET_STEPS checkpoints held bit for
         bit (an op that refuses deterministic mode is named instead).
    The losses and wavs say nothing of quality (seeded audio). Failed
    checks go to ``failures``; returns {path: read_launches()} for
    "vocoder_train", "vocoder_export", "gen_wavernn" and "gta_train"."""
    import contextlib
    import io
    import pickle
    import shutil
    import statistics
    import numpy as np
    import torch
    import yaml
    from etts_torch import (gen_wavernn, make_gta, preprocess_wavernn,
                            train_wavernn)
    from etts_torch.api import VocoderSynthesizer
    from etts_torch.convert import export_flat
    from etts_torch.data.audio_io import load_wav, save_wav
    from etts_torch.data.builders import _quantize
    from etts_torch.data.dataset import (DataPrepper, Dataset, load_files)
    from etts_torch.models.init import init_flax
    from etts_torch.text import default_tokenizer
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import (make_autoregressive_val_step,
                                        make_wavernn_train_step)
    from etts_torch.utils.config import ConfigManager, build_vocoder
    from etts_torch.ops.kernels import wavernn_cell as wcell
    from etts_torch.utils.logging import read_scalars
    build = ROOT / "build"
    root = build / "phase12"
    shutil.rmtree(root, ignore_errors=True)
    cdir, wavs, store = root / "config", root / "wavs", root / "store"
    for x in (cdir, wavs):
        x.mkdir(parents=True)
    for kind, over in (
            ("data", dict(log_directory=str(root / "logs"))),
            ("wavernn", dict(voc_checkpoint_every=VT_CKPT,
                             voc_gen_at_checkpoint=1, voc_test_samples=4))):
        cfg = yaml.safe_load((CONFIG / f"{kind}_config.yaml").read_text())
        cfg.update(over)
        (cdir / f"{kind}_config.yaml").write_text(yaml.safe_dump(cfg))
    paths = {}
    det = []

    def entry(main, *args):
        return run_main(main, ["--config", str(cdir), *args])
    try:
        # 1. wavs -> the store, on the card
        rng = np.random.default_rng(12)
        seconds = rng.uniform(*VT_SECONDS, VT_UTTS)
        for i, sec in enumerate(seconds):
            save_wav(ref_wav(100 + i, float(sec)), wavs / f"v{i:03d}.wav",
                     16000)
        secs, out, _ = entry(preprocess_wavernn.main, "--wav_dir", str(wavs),
                             "--out_dir", str(store), "--njobs", "4")
        index = pickle.load(open(store / "dataset.pkl", "rb"))
        say(cl, f"preprocess_wavernn: {len(index)} wavs ({seconds.sum():.1f}"
                f" s of audio) in {secs:.2f} s; " + out.strip())
        if len(index) != VT_UTTS:
            failures.append(f"preprocess_wavernn wrote {len(index)} items")

        # 2. the step, card against CPU; the split at batch 64
        _vocoder_step_check(cl, cdir, store, failures)
        cm = ConfigManager(cdir, "wavernn", "phase12")
        c = cm.config
        model = build_vocoder(c)
        init_flax(model, torch.Generator().manual_seed(0)).to("cuda")
        state = TrainState(model, [[0, 1e-4]])
        vstep = make_wavernn_train_step(model)
        ids = train_wavernn.vocoder_ids(store, c, False)
        ds = train_wavernn.VocoderDataset(ids, store)
        batch = train_wavernn.to_device(next(train_wavernn.vocoder_batches(
            ds, c["voc_batch_size"], c["voc_seq_len_hops"] * c["hop_length"],
            c["hop_length"], c["voc_pad"], c["voc_mode"], c["bits"],
            np.random.default_rng(0), np.random.default_rng(1))), "cuda")
        step_split(cl, "vocoder train step", state,
                   lambda: vstep(state, batch), reps=3, prof_steps=1)
        del model, state, batch

        # 3. the driver: a run, then resumed; the utterances each step read
        seen = {}

        class Recorded(train_wavernn.VocoderDataset):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.log = seen.setdefault(len(seen), [])

            def __getitem__(self, index):
                self.log.append(self.metadata[index])
                return super().__getitem__(index)

        dataset_cls = train_wavernn.VocoderDataset
        train_wavernn.VocoderDataset = Recorded
        outs, bases, streams = [], {}, []
        try:
            zero_launches()
            for steps in VT_STEPS:
                seen.clear()
                secs, out, bases[steps - 1] = entry(
                    train_wavernn.main, "--data", str(store),
                    "--session_name", "phase12", "--max_steps", str(steps))
                torch.cuda.synchronize()
                streams.append(seen[0])
                outs.append(out)
                say(cl, f"train_wavernn --max_steps {steps}: {secs:.1f} s; "
                        + " | ".join(out.strip().splitlines()[-3:]))
            paths["vocoder_train"] = read_launches()
        finally:
            train_wavernn.VocoderDataset = dataset_cls
        if f"restored vocoder weights at step {VT_STEPS[0]}" not in outs[1]:
            failures.append(f"train_wavernn: no restore at {VT_STEPS[0]}")
        # the permutation stream replayed: batch k is the first 64 of the
        # k-th epoch's permutation (one batch an epoch)
        test_ids, train_ids = train_wavernn.split_ids(ids, 4)
        perm = np.random.default_rng(train_wavernn.PERM_SEED)
        bs = c["voc_batch_size"]
        want = [[train_ids[j] for j in perm.permutation(len(train_ids))[:bs]]
                for _ in range(VT_STEPS[1])]
        got = [streams[0][k * bs:(k + 1) * bs] for k in range(VT_STEPS[0])]
        got += [streams[1][k * bs:(k + 1) * bs]
                for k in range(VT_STEPS[1] - VT_STEPS[0])]
        stream_ok = got == want
        say(cl, f"train_wavernn: {len(train_ids)} training and "
                f"{len(test_ids)} test utterances; the utterances of steps "
                f"0-{VT_STEPS[1] - 1} (the resumed run's too) are the "
                f"permutation stream's: {stream_ok}")
        if not stream_ok:
            failures.append("train_wavernn: the batches left the "
                            "permutation stream")
        sc = read_scalars(cm.log_dir)
        span = range(3, VT_STEPS[0])
        step_ms = [sc["time/step_ms"][i] for i in span]
        samples = sum(sc["meta/target_samples"][i] for i in span)
        peak = sc.get("meta/max_memory_allocated", {})
        losses = sc["train/loss"]
        gens = sorted(p.name for p in cm.log_dir.glob("gen_*.wav"))
        say(cl, f"vocoder training, steps 3-{VT_STEPS[0] - 1} (host "
                f"clock, "
                f"synchronised): median {statistics.median(step_ms):.2f} "
                f"ms/step (min {min(step_ms):.2f}, max {max(step_ms):.2f}); "
                f"{samples / sum(step_ms) * 1e3:.0f} target samples/s; peak "
                "memory of the run "
                + ", ".join(f"{(v - bases[k]) / 2**30:.3f} GiB (run to "
                            f"{k + 1})" for k, v in sorted(peak.items()))
                + f"; losses {dict(sorted(losses.items()))}; wavs {gens}; "
                f"launches {paths['vocoder_train']}")
        want_gens = sorted(f"gen_{n}_0.wav"
                           for n in range(VT_CKPT, VT_STEPS[1] + 1, VT_CKPT))
        sync_every = c["metrics_sync_frequency"]
        want_losses = sorted({k for k in range(VT_STEPS[1])
                              if k % sync_every == 0}
                             | {n - 1 for n in VT_STEPS})
        if not (sorted(losses) == want_losses
                and all(math.isfinite(v) for v in losses.values())
                and sorted(peak) == [n - 1 for n in VT_STEPS]
                and gens == want_gens
                and paths["vocoder_train"]["wavernn_sample_loop"]
                == len(want_gens)):
            failures.append(f"vocoder training log: losses {losses}, peak "
                            f"{sorted(peak)}, wavs {gens}, launches "
                            f"{paths['vocoder_train']}")

        # 4. the last checkpoint's export through VocoderSynthesizer and B1
        with contextlib.redirect_stdout(io.StringIO()):
            trained, step, _ = cm.load_model()
        flat = export_flat(trained)
        stats = {k: v for k, v in flat.items() if k.startswith("batch_stats")}
        moved = sum(not (np.all(v == 0) or np.all(v == 1))
                    for v in stats.values())
        voc = VocoderSynthesizer(cdir, flat, "cuda")
        mel = np.load(store / "mel" / f"{test_ids[0]}.npy").T
        voc.generate(mel, seed=0)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = voc.generate(mel, seed=0)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        paths["vocoder_export"] = ran = read_launches()
        wav26 = voc26.generate(mel, seed=0)
        sat = lambda w: float((np.abs(w) >= 0.999).mean())
        audio_s = wav.shape[0] / c["sampling_rate"]
        say(cl, f"trained vocoder export (step {step}): {len(stats)} "
                f"batch_stats arrays, {moved} moved from their init; "
                f"{test_ids[0]} ({mel.shape[0]} frames) -> {wav.shape[0]} "
                f"samples ({audio_s:.3f} s) in {e2e:.3f} s, RTF "
                f"{e2e / audio_s:.4f}; launches {ran}; samples at |x| >= "
                f"0.999: {sat(wav):.4f} (the 26k export on the same mel: "
                f"{sat(wav26):.4f})")
        want = {k: 0 for k in ran} | {"wavernn_sample_loop": 1}
        if not (ran == want and len(stats) == 2 * (1 + 2 * c["voc_res_blocks"])
                and moved == len(stats) and np.isfinite(wav).all()
                and wav.shape[0] == (mel.shape[0] - 1) * c["hop_length"]):
            failures.append(f"trained vocoder export: launches {ran}, "
                            f"{moved} of {len(stats)} statistics moved")
        # 5. the deterministic runs, in processes of their own, started
        # after the timed runs and the export's timed call; B1 one step at
        # a time on the export
        det = _deterministic_runs(cdir, store)
        cond = torch.cat([vocoder_cond(voc, np.load(
            store / "mel" / f"{i}.npy").T * 8.0 - 4.0) for i in test_ids], 1)
        say(cl, f"the trained export's conditioning, its {len(test_ids)} "
                f"test utterances folded: {tuple(cond.shape)}, max |value| "
                f"{float(cond.abs().max()):.3f}")
        wts = voc.weights
        one_step_check(cl, "bf16 (the trained vocoder export)", wts,
                       f32_activations(wts),
                       lambda c_: wcell._bf16_step(c_, wts, torch.float64),
                       None, cond, (cond.shape[1],), STATE_TOL_TRAINED,
                       SAMPLE_MARGIN_TRAINED, failures, n_steps=VT_ONE_STEP,
                       mode=voc.model.mode, n_classes=voc.model.n_classes)

        # 6. gen_wavernn on the session: the store's last 2, and one file
        out_dir = root / "gen"
        zero_launches()
        secs = 0.0
        for args in (["--data", str(store), "--samples", "2"],
                     ["--file", str(store / "mel" / f"{test_ids[1]}.npy")]):
            s_, out, _ = entry(gen_wavernn.main, "--session_name", "phase12",
                               "--out_dir", str(out_dir), *args)
            secs += s_
        torch.cuda.synchronize()
        paths["gen_wavernn"] = ran = read_launches()
        frames = dict(index)
        names = [i for i, _ in index[-2:]] + [test_ids[1]]
        lens = {n: load_wav(out_dir / f"{n}_batched.wav")[0].shape[0]
                for n in names}
        ok = (all(lens[n] == (frames[n] - 1) * c["hop_length"] for n in names)
              and ran["wavernn_sample_loop"] == 3)
        say(cl, f"gen_wavernn --data (2) and --file (the card shared with "
                f"the deterministic runs): {secs:.2f} s, samples "
                f"{lens}, launches {ran}")
        if not ok:
            failures.append(f"gen_wavernn: {lens}, launches {ran}")

        # 7. GTA mels of phase 11's AR session, card against CPU; then
        # train on them
        acfg = build / "phase11_config"
        corpus = build / "phase9_corpus"
        gta_store = root / "gta_store"
        secs, out, _ = run_main(make_gta.main, [
            "--config", str(acfg), "--session_name", "phase11",
            "--voc_data", str(gta_store)])
        gta = sorted((gta_store / "gta").glob("*.npy"))
        say(cl, f"make_gta on the card (shared with the deterministic "
                f"runs): {len(gta)} mels in {secs:.2f} s; "
                + out.strip().splitlines()[-1])
        acm = ConfigManager(acfg, "autoregressive", "phase11")
        samples_, _ = load_files(corpus / "train_metafile.txt",
                                 corpus / "mels", corpus / "spk_embeds")
        host = Dataset(samples_[:VT_CPU_ROWS],
                       DataPrepper(acm.config, default_tokenizer(True)),
                       VT_CPU_ROWS, shuffle=False,
                       mel_channels=acm.config["mel_channels"]).next_batch()
        rows = {}
        for where in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                model, _, sched = acm.load_model(device=where)
            rows[where] = make_gta.gta_batch(
                make_autoregressive_val_step(model), host, where,
                sched["reduction_factor"])
        d_gta = max(float(np.abs(a - b).max()) / 8.0
                    for a, b in zip(rows["cuda"], rows["cpu"]))
        shapes = all(np.load(p).shape == np.load(
            corpus / "mels" / p.name).shape[::-1] for p in gta)
        say(cl, f"make_gta, card vs CPU ({VT_CPU_ROWS} rows of "
                f"{[r.shape[0] for r in rows['cpu']]} frames): max |d| "
                f"{d_gta:.3e} in the vocoder's [0, 1] (tol {VT_GTA_TOL}); "
                f"every file (n_mels, its mel's frames): {shapes}")
        if not (len(gta) == len(samples_) and d_gta <= VT_GTA_TOL
                and shapes):
            failures.append("make_gta")
        (gta_store / "quant").mkdir()
        qrng = np.random.default_rng(5)
        gindex = []
        for p in gta:
            t = np.load(p).shape[1]
            y = 0.3 * np.tanh(qrng.standard_normal(t * c["hop_length"]))
            np.save(gta_store / "quant" / p.name,
                    _quantize(y.astype(np.float32), "MOL", 9, True, False))
            gindex.append((p.stem, t))
        with open(gta_store / "dataset.pkl", "wb") as f:
            pickle.dump(gindex, f)
        zero_launches()
        secs, out, _ = entry(train_wavernn.main, "--data", str(gta_store),
                             "--gta", "--session_name", "phase12_gta",
                             "--batch_size", str(VT_GTA_BATCH),
                             "--max_steps", str(VT_GTA_STEPS))
        torch.cuda.synchronize()
        paths["gta_train"] = ran = read_launches()
        gsc = read_scalars(ConfigManager(cdir, "wavernn",
                                         "phase12_gta").log_dir)
        g_loss = gsc["train/loss"]
        say(cl, f"train_wavernn --gta, {VT_GTA_STEPS} steps at batch "
                f"{VT_GTA_BATCH} (the card shared with the deterministic "
                f"runs): {secs:.1f} s, median "
                f"{statistics.median(gsc['time/step_ms'].values()):.2f} "
                f"ms/step; losses {dict(sorted(g_loss.items()))}; launches "
                f"{ran}")
        if not (sorted(g_loss) == [0, VT_GTA_STEPS - 1]
                and all(math.isfinite(v) for v in g_loss.values())
                and ran["wavernn_sample_loop"] == 1):
            failures.append(f"train_wavernn --gta: {g_loss}, {ran}")

        # 8. the deterministic runs
        _deterministic_outcome(cl, cdir, cm, det, failures)
    finally:
        for p in det:
            if p.poll() is None:
                p.kill()
                p.wait()
    return paths


def _sync_ms(fn):
    """Host milliseconds of fn(), synchronised before and after, and its
    result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def tacotron_phase(cl, wav_ref, failures):
    """Phase 10: GST-Tacotron serving (``TacotronSynthesizer``) at
    configs/default's full width (embed 256, CBHG 128, attention and LSTMs
    256, 4 x 10 style tokens, mel 80, num_freq 1025, r = 2, max_iters
    1000, 60 Griffin-Lim iterations) on seeded weights and BatchNorm
    statistics (``convert.seeded_flat``; no trained export exists), the
    linear head's bias 0.5. The seeded decoder never emits an all-zero
    step, so each decode runs all 1000 steps: 2000 frames, 25 s of audio.
    The reference mel is the
    seeded wav's (``taco_linear_and_mel``, on the card). Held against the
    same port code on the CPU with the TACO_* bars; a stop check (a
    frame_proj whose frames are all 0 at step TACO_STOP[1] alone) and the
    random style without a reference run once. Failed checks go to
    ``failures``; returns the launches of the text -> wav run
    ({"tacotron": read_launches()}), all 0: the path runs no kernel of
    the port."""
    import statistics
    import numpy as np
    import torch
    from etts_torch.api import TacotronSynthesizer
    from etts_torch.convert import seeded_flat
    from etts_torch.data.taco_audio import taco_linear_and_mel
    from etts_torch.ops.griffin_lim import griffin_lim
    from etts_torch.ops.normalizers import (db_to_amp, deemphasis,
                                            denormalize_db)
    from etts_torch.utils.config import build_tacotron, load_config
    dev = torch.device("cuda")
    flat = seeded_flat(build_tacotron(load_config(CONFIG, "tacotron")),
                       TACO_SEED)
    # the linear head's outputs centred in [0, 1], the range of its
    # normalised dB, so that few bins clip at the floor
    flat["['linear_proj']['bias']"][:] = 0.5
    taco = TacotronSynthesizer(CONFIG, flat, "cuda")
    host = TacotronSynthesizer(CONFIG, flat, "cpu")
    m, mh, c = taco.model, host.model, taco.config
    sr, steps = c["sampling_rate"], m.max_iters

    def check(label, err, bar):
        say(cl, f"tacotron {label}, card vs CPU: max |d| {err:.3e} (bar "
                f"{bar:g})")
        if not err <= bar:
            failures.append(f"tacotron {label}")

    d = lambda a, b: float((a.cpu() - b.cpu()).abs().max())
    _, ref = taco_linear_and_mel(torch.from_numpy(wav_ref).to(dev), c)
    ids = torch.from_numpy(taco.encode_text(SENTENCE))[None]
    n = torch.tensor([ids.shape[1]])
    u = mh.draw_uniforms(1, ids.shape[1], steps, seed=0)
    ug = {k: v.to(dev) for k, v in u.items()}

    # times first, before the CPU side computes (host clock, synchronised,
    # warm, the median of 3): text -> wav, the counts read around it; then
    # its parts
    def median_ms(fn):
        fn()
        runs = [_sync_ms(fn) for _ in range(3)]
        return statistics.median(ms for ms, _ in runs), runs

    zero_launches()
    e2e_ms, runs = median_ms(lambda: taco.synthesize(SENTENCE, ref))
    ran = read_launches()
    wav, align = runs[-1][1]
    audio_s = wav.shape[0] / sr
    say(cl, f"tacotron text -> wav: {ids.shape[1]} ids, {steps} steps, "
            f"{wav.shape[0]} samples ({audio_s:.3f} s) in "
            f"{', '.join(f'{ms:.1f}' for ms, _ in runs)} ms (median "
            f"{e2e_ms:.1f}), RTF {e2e_ms / 1e3 / audio_s:.4f}; launches "
            f"{ran} (4 runs)")
    if (ran != {k: 0 for k in ran} or not np.isfinite(wav).all()
            or wav.shape[0] != (steps * m.r - 1) * c["hop_length"]
            or align.shape != (steps, ids.shape[1])):
        failures.append("tacotron text -> wav")

    def inv(linear, n_iter):
        """The linear spectrogram's magnitude, then Griffin-Lim."""
        S = denormalize_db(linear.T, c.get("min_level_db", -100))
        mag = db_to_amp(S + c.get("ref_level_db", 20)) ** c.get("power", 1.5)
        return griffin_lim(mag, c["n_fft"], c["hop_length"], c["win_length"],
                           n_iter=n_iter)

    gl_iters = c.get("griffin_lim_iters", 60)
    with torch.no_grad():
        enc_ms, _ = median_ms(lambda: m.encode(ids.to(dev), ref[None], ug))
        gen_ms, runs = median_ms(lambda: m.generate(
            ids.to(dev), n.to(dev), ref[None], uniforms=ug))
        mel = runs[-1][1]["mel_outputs"]
        head_ms, runs = median_ms(lambda: m.linear_proj(m.post_cbhg(mel)))
        linear = runs[-1][1][0]
        gl_ms, runs = median_ms(lambda: inv(linear, gl_iters))
        gl_wav = runs[-1][1]
        de_ms, _ = median_ms(lambda: deemphasis(gl_wav))
    dec_ms = gen_ms - enc_ms - head_ms
    say(cl, f"tacotron times (host, synchronised, warm, median of 3): "
            f"encode {enc_ms:.2f} ms; decode {dec_ms / steps:.4f} ms/step "
            f"({dec_ms:.1f} ms for {steps} steps: generate {gen_ms:.1f} ms "
            f"less encode and head); post CBHG + linear {head_ms:.1f} ms; "
            f"Griffin-Lim ({gl_iters} iterations, with the dB to magnitude) "
            f"{gl_ms:.1f} ms; de-emphasis ({wav.shape[0]} samples) "
            f"{de_ms:.2f} ms; text -> wav {e2e_ms:.1f} ms for "
            f"{audio_s:.3f} s of audio, RTF {e2e_ms / 1e3 / audio_s:.4f}")

    # the reference mel on the CPU from the same wav
    check("reference mel", d(ref, taco_linear_and_mel(wav_ref, c)[1]),
          TACO_TOL)

    # the free-running decode on both sides, the same uniforms (drawn on
    # the CPU from the seed), the CPU's cell steps recorded
    rec = []
    hook = mh.decoder_cell.register_forward_hook(
        lambda mod, args, out: rec.append((args[0], args[1], args[5], out)))
    out_h = mh.generate(ids, n, ref.cpu()[None], uniforms=u)
    hook.remove()
    out_g = m.generate(ids.to(dev), n.to(dev), ref.cpu()[None].to(dev),
                       uniforms=ug)
    per_step = lambda o: torch.cat(
        [o["mel_outputs"][0].cpu().reshape(steps, -1),
         o["alignments"][0].cpu()], -1)
    free = (per_step(out_g) - per_step(out_h)).abs().amax(-1)
    past = torch.nonzero(free > TACO_TOL)
    say(cl, f"tacotron free-running decode, card vs CPU (same uniforms): "
            f"within {TACO_TOL:g} for "
            + (f"steps 0-{int(past[0]) - 1}; first step past the bar "
               f"{int(past[0])} (max |d| there {float(free[past[0]]):.3e})"
               if len(past) else f"all {steps} steps")
            + f"; max |d| over the run {float(free.max()):.3e}")

    # the encoder output, then every step teacher-fed: the card's cell from
    # the CPU run's carry, fed-back frame and uniforms, on the CPU's keys
    def leaves(x):
        return [x] if torch.is_tensor(x) else [y for z in x for y in leaves(z)]

    def to_card(x):
        return x.to(dev) if torch.is_tensor(x) else tuple(map(to_card, x))

    with torch.no_grad():
        enc_h = mh.encode(ids, ref.cpu()[None], u)[0]
        enc_g = m.encode(ids.to(dev), ref[None], ug)
        check("encoder output", d(enc_g[0], enc_h), TACO_TOL)
        keys, values = to_card((mh.memory_proj(enc_h), enc_h))
        mask = torch.ones(1, ids.shape[1], dtype=torch.bool, device=dev)
        w = m.decoder_cell.stacked()
        err = 0.0
        for carry, prev, ut, out in rec:
            got = m.decoder_cell(*to_card((carry, prev)), keys, values, mask,
                                 ut.to(dev), w)
            err = max(err, max(d(a, b) for a, b in zip(leaves(got),
                                                       leaves(out))))
        check(f"decode, each of {len(rec)} steps teacher-fed (frames, "
              "alignment, carry)", err, TACO_TOL)
        # the post CBHG + linear head on the CPU run's mel
        check("post CBHG + linear head", d(m.linear_proj(m.post_cbhg(
            out_h["mel_outputs"].to(dev))), out_h["linear_outputs"]),
            TACO_TOL)

    # Griffin-Lim (2 iterations) and de-emphasis on the CPU run's linear
    # spectrogram, on both sides; then de-emphasis alone on one wav
    lin_h = out_h["linear_outputs"][0]
    gl_h, gl_g = inv(lin_h, 2), inv(lin_h.to(dev), 2)
    wav_h, wav_g = deemphasis(gl_h), deemphasis(gl_g)
    peak = float(wav_h.abs().max())
    check("wav after 2 Griffin-Lim iterations and de-emphasis, share of "
          f"its peak {peak:.3e}", d(wav_g, wav_h) / peak, TACO_WAV_RTOL)
    check("de-emphasis alone, share of the wav's peak",
          d(deemphasis(gl_h.to(dev)), wav_h) / peak, TACO_DEEMPH_RTOL)

    # the stop: frames all 0 at step TACO_STOP[1] alone; every later step
    # zeroed on both sides, though their frame_proj emits frames again
    n_stop, at = TACO_STOP

    class ZeroAt(torch.nn.Module):
        """A frame_proj whose frames are all 0 at step ``at`` of a decode
        (it counts its calls on the device: no host read)."""

        def __init__(self, proj):
            super().__init__()
            self.proj = proj
            self.calls = torch.zeros((), dtype=torch.long,
                                     device=proj.weight.device)

        def forward(self, x):
            y = self.proj(x) * (self.calls != at)
            self.calls += 1
            return y

    zeroed = {}
    for side, model in (("card", m), ("CPU", mh)):
        cell = model.decoder_cell
        proj, cell.frame_proj = cell.frame_proj, ZeroAt(cell.frame_proj)
        dv = proj.weight.device
        o = model.generate(ids.to(dv), n.to(dv), ref[None].to(dv),
                           max_iters=n_stop, seed=0)
        cell.frame_proj = proj
        zeroed[side] = (o["mel_outputs"][0].reshape(n_stop, -1) == 0).all(
            -1).cpu()
    want = torch.arange(n_stop) >= at
    first = lambda z: int(torch.nonzero(z)[0]) if z.any() else None
    say(cl, f"tacotron stop check ({n_stop} steps, frames all 0 at step "
            f"{at}): zeroed steps card {int(zeroed['card'].sum())} from "
            f"{first(zeroed['card'])}, CPU {int(zeroed['CPU'].sum())} from "
            f"{first(zeroed['CPU'])} (want {n_stop - at} from {at})")
    if not (torch.equal(zeroed["card"], want)
            and torch.equal(zeroed["CPU"], want)):
        failures.append("tacotron stop check")

    # no reference: the random style from the seed, the same on both sides
    with torch.no_grad():
        sty_g = m.encode(ids.to(dev), None, ug)[1]
        sty_h = mh.encode(ids, None, u)[1]
    check("random style (no reference)", d(sty_g, sty_h), TACO_TOL)
    wav0, _ = taco.synthesize(SENTENCE, None, seed=1)
    if not (np.isfinite(wav0).all() and wav0.shape == wav.shape):
        failures.append("tacotron without a reference")
    return {"tacotron": ran}


def _taco_corpus(root, n, seed=13):
    """``n`` seeded wavs (``ref_wav``, TT_SECONDS long) in the LJSpeech
    layout under ``root``: ``wavs/`` and ``metadata.csv`` (``id|text|text``,
    seeded sentences of 4-14 words of TT_WORDS). Returns the seconds of
    audio."""
    import numpy as np
    from etts_torch.data.audio_io import save_wav
    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    seconds = rng.uniform(*TT_SECONDS, n)
    lines = []
    for i, sec in enumerate(seconds):
        save_wav(ref_wav(200 + i, float(sec)), root / "wavs" / f"lj{i:03d}.wav",
                 16000)
        text = " ".join(rng.choice(TT_WORDS, int(rng.integers(4, 15))))
        text = text[0].upper() + text[1:] + "."
        lines.append(f"lj{i:03d}|{text}|{text}\n")
    (root / "metadata.csv").write_text("".join(lines))
    return float(seconds.sum())


def _max_rel(a, b) -> float:
    """max |a - b| over max |b|, float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _taco_step_check(cl, cdir, failures):
    """One full-width Tacotron train step (``make_tacotron_train_step``,
    the teacher-forced forward with zoneout's masks and BatchNorm on batch
    statistics, the loss, ``torch.autograd.grad``), card against CPU on
    the store's first TT_CPU_ROWS utterances from the same init
    (``init_flax``, seed 0) and uniforms (step 0's, drawn on the CPU): in
    float64 the loss, each gradient and each BatchNorm statistic after the
    step at the FT_* bars (the statistics' max |d| over their max
    |value|); then the float32 step on the card and on the CPU, and on the
    card with TF32 on (the control), each against the card's float64 step:
    the worst gradient within TT_F32_GRAD on the card and the CPU, the
    control's past it."""
    import numpy as np
    import torch
    from etts_torch.models.init import init_flax
    from etts_torch.train.steps import fold_in, make_tacotron_train_step
    from etts_torch.train_tacotron import (INIT_SEED, SEED, load_taco_metadata,
                                           taco_batches, to_device)
    rng = fold_in(SEED, 0)
    from etts_torch.utils.config import ConfigManager, build_tacotron
    from etts_torch.utils.precision import pin_float32
    cm = ConfigManager(cdir, "tacotron", "phase13")
    c = cm.config
    rows = load_taco_metadata(cm.train_datadir)[:TT_CPU_ROWS]
    host, _ = next(taco_batches(rows, cm.train_datadir, TT_CPU_ROWS,
                                c["outputs_per_step"], [c["cleaners"]],
                                np.random.default_rng(0)))
    def step(dt, where, tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            model = build_tacotron(c)
            init_flax(model, torch.Generator().manual_seed(INIT_SEED)).to(
                where, dt)
            state = grad_capture(model, [[0, 1e-3]])
            batch = tuple(x if x.dtype == torch.int64 else x.to(dt)
                          for x in to_device(host, where))
            t0 = time.perf_counter()
            met = make_tacotron_train_step(model)(state, batch, rng)
            stats = {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            return (float(met["loss"]), [g.double() for g in state.grads],
                    stats, time.perf_counter() - t0, state.names)
        finally:
            pin_float32()

    f64 = {w: step(torch.float64, w) for w in ("cuda", "cpu")}
    (l_g, g_g, st_g, s_g, names), (l_c, g_c, st_c, s_c, _) = (
        f64["cuda"], f64["cpu"])
    d_loss = abs(l_g - l_c) / abs(l_c)
    worst = worst_grad(names, g_g, g_c, FT_GRAD_ATOL)
    d_stats = max(_max_rel(st_g[k], st_c[k]) for k in st_c)
    say(cl, f"tacotron train step, card vs CPU (float64, {len(names)} "
            f"parameters, ids {tuple(host[0].shape)}, mels "
            f"{tuple(host[2].shape)}, linears {tuple(host[3].shape)}): "
            f"loss {l_g:.9f} vs {l_c:.9f} (relative {d_loss:.2e}, tol "
            f"{FT_LOSS_TOL}); worst gradient {worst[1]}: (|d| - "
            f"{FT_GRAD_ATOL}) / |g| {worst[0]:.2e} (tol {FT_GRAD_RTOL}); "
            f"{len(st_c)} BatchNorm statistics, max |d| / max |stat| "
            f"{d_stats:.2e} (tol {FT_STATS_TOL}); first step {s_g:.3f} s on "
            f"the card, {s_c:.3f} s on the CPU")
    if not (d_loss <= FT_LOSS_TOL and worst[0] <= FT_GRAD_RTOL
            and d_stats <= FT_STATS_TOL):
        failures.append("tacotron train step, card vs CPU (float64)")
    worst, line = {}, []
    for where, tf32 in (("cuda", False), ("cpu", False), ("cuda", True)):
        l32, g32, st32, _, _ = step(torch.float32, where, tf32)
        name = where + (" TF32 (control)" if tf32 else "")
        w32 = worst[name] = worst_grad(names, g32, g_g, TRAIN_GRAD_ATOL)
        line.append(f"{name}: loss relative {abs(l32 - l_g) / abs(l_g):.2e}"
                    f", worst gradient {w32[1]} {w32[0]:.2e}, statistics "
                    f"{max(_max_rel(st32[k], st_g[k]) for k in st_g):.2e}")
        if not math.isfinite(l32):
            failures.append(f"tacotron float32 train step ({name}): loss")
    say(cl, "tacotron float32 train step against the card's float64 step "
            f"(gradients (|d| - {TRAIN_GRAD_ATOL}) / |g|, tol {TT_F32_GRAD}; "
            "the control past it): " + "; ".join(line))
    if not (worst["cuda"][0] <= TT_F32_GRAD
            and worst["cpu"][0] <= TT_F32_GRAD
            and worst["cuda TF32 (control)"][0] > TT_F32_GRAD):
        failures.append("tacotron float32 train step against float64")


def taco_train_phase(cl, wav_ref, failures):
    """Phase 13: the TTS stores and GST-Tacotron's training flow, each
    entry point's ``main`` run in this process:
      1. TT_UTTS seeded wavs of TT_SECONDS in the LJSpeech layout
         (``_taco_corpus``; LJSpeech's utterances reach 10 s);
      2. ``create_dataset --phonemizer_backend rule`` on the card and on
         the CPU (n_test TT_TEST): both metafiles and ``phonemes.npy``
         equal, the mels within AR_MEL_TOL; ``train_autoregressive``
         (configs/default's model at full width, batch 8) TT_AR_STEPS
         steps on the card's store with seeded ``spk_embeds/`` beside it:
         finite losses;
      3. ``build_tacotron_dataset`` on the card and on the CPU:
         ``train.txt`` equal, the spectrograms within TACO_STORE_TOL;
      4. ``train_tacotron`` at configs/default's full width (batch 8, r =
         2; ``checkpoint_interval`` TT_CKPT) for TT_STEPS[0] steps, then
         resumed to TT_STEPS[1]: the restore, the rows of every step
         against the permutation stream replayed, the step time (median of
         steps 5 to TT_STEPS[0] - 1), target frames a second, own peak
         memory, the losses, the BatchNorm statistics moved;
      5. the step-TT_STEPS[1] checkpoint's export (``export_flat``)
         through ``TacotronSynthesizer``: SENTENCE and the reference wav's
         mel -> a wav, 1000 decode steps and 60 Griffin-Lim iterations,
         timed, the launches read around it (none);
      6. the step split (``step_split``) at the driver's first batch;
      7. two runs under deterministic algorithms (``_deterministic_process``):
         TT_DET_STEPS[0] steps resumed to TT_DET_STEPS[1], against
         TT_DET_STEPS[1] steps, each in a process of its own, started here
         and read at the end: weights, statistics and Adam state bit for
         bit (an op that refuses deterministic mode is named instead);
      8. meanwhile one train step card against CPU (``_taco_step_check``).
    Failed checks go to ``failures``; returns {path: read_launches()} for
    "taco_train" and "taco_export"."""
    import contextlib
    import io
    import shutil
    import statistics
    import numpy as np
    import torch
    import yaml
    from etts_torch import create_dataset, train_autoregressive, train_tacotron
    from etts_torch.api import TacotronSynthesizer
    from etts_torch.convert import export_flat
    from etts_torch.data.taco_audio import taco_linear_and_mel
    from etts_torch.data.taco_builders import build_tacotron_dataset
    from etts_torch.train.steps import make_tacotron_train_step
    from etts_torch.utils.config import ConfigManager
    from etts_torch.utils.logging import read_scalars
    root = ROOT / "build" / "phase13"
    shutil.rmtree(root, ignore_errors=True)
    corpus = root / "corpus"
    paths, det = {}, []
    data0 = yaml.safe_load((CONFIG / "data_config.yaml").read_text())

    def config_dir(name, models, **data):
        d = root / name
        d.mkdir(parents=True)
        (d / "data_config.yaml").write_text(yaml.safe_dump(dict(
            data0, data_directory=str(corpus), n_test=TT_TEST,
            log_directory=str(root / "logs"), **data)))
        for kind, over in models.items():
            cfg = yaml.safe_load((CONFIG / f"{kind}_config.yaml").read_text())
            (d / f"{kind}_config.yaml").write_text(yaml.safe_dump(
                dict(cfg, **over)))
        return d

    try:
        # 1. the corpus
        audio_s = _taco_corpus(corpus, TT_UTTS)

        # 2. the AR store on the card and on the CPU; a few AR steps on it
        stores, ar_dirs = {}, {}
        for where in ("cuda", "cpu"):
            stores[where] = root / f"ar_store_{where}"
            d = ar_dirs[where] = config_dir(
                f"ar_{where}", {"autoregressive": {}},
                train_data_directory=str(stores[where]))
            secs, out, _ = run_main(create_dataset.main, [
                "--config", str(d), "--phonemizer_backend", "rule",
                "--njobs", "8", "--device", where])
            say(cl, f"create_dataset on the {where}: {TT_UTTS} wavs "
                    f"({audio_s:.1f} s of audio) in {secs:.2f} s")
            if yaml.safe_load((d / "data_config.yaml").read_text()).get(
                    "phonemizer_backend") != "rule":
                failures.append("create_dataset: backend not recorded")
        a, b = stores["cuda"], stores["cpu"]
        same = all((a / f).read_bytes() == (b / f).read_bytes() for f in (
            "train_metafile.txt", "test_metafile.txt", "phonemes.npy"))
        mels = sorted(p.name for p in (b / "mels").glob("*.npy"))
        d_mel = max(float(np.abs(np.load(a / "mels" / m)
                                 - np.load(b / "mels" / m)).max())
                    for m in mels)
        n_train = len((a / "train_metafile.txt").read_text().splitlines())
        say(cl, f"the AR store, card vs CPU: metafiles and phonemes.npy "
                f"equal {same} ({n_train} train, {TT_TEST} test rows); "
                f"{len(mels)} mels, max |d| {d_mel:.3e} (tol {AR_MEL_TOL})")
        if not (same and len(mels) == TT_UTTS and d_mel <= AR_MEL_TOL
                and n_train == TT_UTTS - TT_TEST - 1):
            failures.append("the AR store, card vs CPU")
        (a / "spk_embeds").mkdir()
        srng = np.random.default_rng(14)
        for m in mels:
            v = srng.standard_normal(256).astype(np.float32)
            np.save(a / "spk_embeds" / m, v / np.linalg.norm(v))
        secs, out, _ = run_main(train_autoregressive.main, [
            "--config", str(ar_dirs["cuda"]), "--session_name", "phase13",
            "--max_steps", str(TT_AR_STEPS)])
        ar_losses = read_scalars(ConfigManager(
            ar_dirs["cuda"], "autoregressive", "phase13").log_dir).get(
                "train/loss", {})
        say(cl, f"train_autoregressive on the store, {TT_AR_STEPS} steps: "
                f"{secs:.1f} s; losses {ar_losses}")
        if not (ar_losses and all(math.isfinite(v)
                                  for v in ar_losses.values())):
            failures.append(f"train_autoregressive on the store: "
                            f"{ar_losses}")

        # 3. the Tacotron store on the card and on the CPU
        taco_cfg = yaml.safe_load((CONFIG / "tacotron_config.yaml")
                                  .read_text())
        tstores = {}
        for where in ("cuda", "cpu"):
            tstores[where] = root / f"taco_store_{where}"
            t0 = time.perf_counter()
            build_tacotron_dataset(
                {**taco_cfg, **data0, "data_directory": str(corpus)},
                out_dir=tstores[where], njobs=8, device=where)
            say(cl, f"build_tacotron_dataset on the {where}: "
                    f"{time.perf_counter() - t0:.2f} s")
        a, b = tstores["cuda"], tstores["cpu"]
        same = (a / "train.txt").read_bytes() == (b / "train.txt").read_bytes()
        files = sorted(p.name for p in b.glob("taco-*.npy"))
        d_spec = max(float(np.abs(np.load(a / f) - np.load(b / f)).max())
                     for f in files)
        rows = train_tacotron.load_taco_metadata(a)
        frames = [int(r[2]) for r in rows]
        say(cl, f"the Tacotron store, card vs CPU: train.txt equal {same} "
                f"({len(rows)} rows, {min(frames)}-{max(frames)} frames); "
                f"{len(files)} spectrograms, max |d| {d_spec:.3e} (tol "
                f"{TACO_STORE_TOL})")
        if not (same and len(rows) == TT_UTTS and len(files) == 2 * TT_UTTS
                and d_spec <= TACO_STORE_TOL):
            failures.append("the Tacotron store, card vs CPU")

        # 4. the driver: a run, then resumed; the rows each step read
        cdir = config_dir("taco", {"tacotron": {
            "checkpoint_interval": TT_CKPT}}, train_data_directory=str(a))
        cm = ConfigManager(cdir, "tacotron", "phase13")
        c = cm.config
        seen, outs, bases = [], [], {}
        batches0 = train_tacotron.taco_batches

        def recorded(*args, **kw):
            for batch, idx in batches0(*args, **kw):
                seen.append(list(idx))
                yield batch, idx
        train_tacotron.taco_batches = recorded
        try:
            zero_launches()
            for steps in TT_STEPS:
                secs, out, bases[steps - 1] = run_main(train_tacotron.main, [
                    "--config", str(cdir), "--session_name", "phase13",
                    "--max_steps", str(steps)])
                outs.append(out)
                say(cl, f"train_tacotron --max_steps {steps}: {secs:.1f} s; "
                        + " | ".join(out.strip().splitlines()[-3:]))
            paths["taco_train"] = read_launches()
        finally:
            train_tacotron.taco_batches = batches0
        if f"restored weights at step {TT_STEPS[0]}" not in outs[1]:
            failures.append(f"train_tacotron: no restore at {TT_STEPS[0]}")
        perm, bs = np.random.default_rng(train_tacotron.SEED), c["batch_size"]
        want = []
        while len(want) < TT_STEPS[1]:
            order = perm.permutation(len(rows))
            want += [list(order[i:i + bs])
                     for i in range(0, len(rows) - bs + 1, bs)]
        stream_ok = seen == want[:TT_STEPS[1]]
        sc = read_scalars(cm.log_dir)
        span = range(5, TT_STEPS[0])
        step_ms = [sc["time/step_ms"][i] for i in span]
        tframes = sum(sc["meta/target_frames"][i] for i in span)
        peak = sc.get("meta/max_memory_allocated", {})
        losses = {k: dict(sorted(sc[f"train/{k}"].items())) for k in
                  ("loss", "mel_loss", "linear_loss", "ref_enc_loss")}
        with contextlib.redirect_stdout(io.StringIO()):
            trained, step, _ = cm.load_model()
        flat = export_flat(trained)
        stats = {k: v for k, v in flat.items() if k.startswith("batch_stats")}
        moved = sum(not (np.all(v == 0) or np.all(v == 1))
                    for v in stats.values())
        ckpts = sorted(int(p.stem.split("-")[1])
                       for p in cm.weights_dir.glob("ckpt-*.pt"))
        aligns = sorted(p.name for p in cm.log_dir.glob("train_alignment_*"))
        say(cl, f"tacotron training (configs/default, batch {bs}, r = "
                f"{c['outputs_per_step']}), steps 5-{TT_STEPS[0] - 1} (host "
                f"clock, synchronised): median {statistics.median(step_ms):.2f}"
                f" ms/step (min {min(step_ms):.2f}, max {max(step_ms):.2f}); "
                f"{tframes / sum(step_ms) * 1e3:.0f} target frames/s; peak "
                "memory of the run "
                + ", ".join(f"{(v - bases[k]) / 2**30:.3f} GiB (run to "
                            f"{k + 1})" for k, v in sorted(peak.items()))
                + f"; the rows of steps 0-{TT_STEPS[1] - 1} (the resumed "
                f"run's too) the permutation stream's: {stream_ok}; losses "
                f"{losses}; checkpoints {ckpts}; alignments {aligns}; "
                f"{moved} of {len(stats)} BatchNorm statistics moved; "
                f"launches {paths['taco_train']}")
        want_losses = sorted({k for k in range(TT_STEPS[1])
                              if k % c["metrics_sync_frequency"] == 0}
                             | {n - 1 for n in TT_STEPS})
        if not (stream_ok and step == TT_STEPS[1]
                and sorted(losses["loss"]) == want_losses
                and all(math.isfinite(v) for v in losses["loss"].values())
                and ckpts == list(range(TT_CKPT, TT_STEPS[1] + 1, TT_CKPT))
                and len(aligns) == len(ckpts) and stats
                and moved == len(stats)
                and sorted(peak) == [n - 1 for n in TT_STEPS]
                and not any(paths["taco_train"].values())):
            failures.append("train_tacotron")

        # 5. the trained export served
        taco = TacotronSynthesizer(cdir, flat, "cuda")
        _, ref = taco_linear_and_mel(torch.from_numpy(wav_ref).cuda(), c)
        taco.synthesize(SENTENCE, ref)
        zero_launches()
        e2e, (wav, align) = _sync_ms(lambda: taco.synthesize(SENTENCE, ref))
        paths["taco_export"] = ran = read_launches()
        wav_s = wav.shape[0] / c["sampling_rate"]
        say(cl, f"the step-{step} export through TacotronSynthesizer: "
                f"SENTENCE and the reference mel ({ref.shape[0]} frames) -> "
                f"{wav.shape[0]} samples ({wav_s:.3f} s) in {e2e:.1f} ms, RTF "
                f"{e2e / 1e3 / wav_s:.4f}; alignment {align.shape}; launches "
                f"{ran}")
        if any(ran.values()) or not np.isfinite(wav).all():
            failures.append(f"the trained Tacotron export: launches {ran}")
        del taco

        # 6. the step's split at the driver's first batch
        from etts_torch.models.init import init_flax
        from etts_torch.utils.config import build_tacotron
        model = build_tacotron(c)
        init_flax(model, torch.Generator().manual_seed(0)).to("cuda")
        state = train_tacotron.train_state(model, c)
        tstep = make_tacotron_train_step(model)
        host, _ = next(train_tacotron.taco_batches(
            rows, a, bs, model.r, [c["cleaners"]], np.random.default_rng(42)))
        batch = train_tacotron.to_device(host, "cuda")
        step_split(cl, f"tacotron train step (ids {tuple(host[0].shape)}, "
                       f"mels {tuple(host[2].shape)})", state,
                   lambda: tstep(state, batch, 0), reps=3, prof_steps=1)
        del model, state, batch

        # 7. the deterministic runs, in processes of their own; 8. the step
        # card against CPU meanwhile
        run_det = lambda name, n: _deterministic_process("train_tacotron", [
            "--config", cdir, "--session_name", name, "--max_steps", n])
        det = [run_det("det_cut", TT_DET_STEPS[0]),
               run_det("det_one", TT_DET_STEPS[1])]
        _taco_step_check(cl, cdir, failures)
        refused, crashed = _refused_or_crashed(det[:1])
        if not (refused or crashed):
            det[0] = run_det("det_cut", TT_DET_STEPS[1])
            refused, crashed = _refused_or_crashed(det)
        if crashed:
            say(cl, "deterministic tacotron runs failed: "
                    + " | ".join(crashed))
            failures.append("deterministic tacotron runs failed")
        elif refused:
            say(cl, "deterministic tacotron runs: ops without a "
                    "deterministic implementation on the card: "
                    f"{sorted(set(refused))}")
        else:
            x, y = (torch.load(ConfigManager(cdir, "tacotron", n).weights_dir
                               / f"ckpt-{TT_DET_STEPS[1]}.pt",
                               map_location="cpu", weights_only=True)
                    for n in ("det_cut", "det_one"))
            opt = lambda o: [t for s in o["state"].values()
                             for t in s.values()]
            bit_equal = all(torch.equal(x["model"][k], y["model"][k])
                            for k in y["model"]) and all(
                torch.equal(p, q) for p, q in zip(opt(x["optimizer"]),
                                                  opt(y["optimizer"])))
            say(cl, f"train_tacotron under torch.use_deterministic_algorithms"
                    f"(True), cuDNN deterministic, CUBLAS_WORKSPACE_CONFIG="
                    f":4096:8, each run in a process of its own: "
                    f"{TT_DET_STEPS[0]} steps resumed to {TT_DET_STEPS[1]} "
                    f"against {TT_DET_STEPS[1]}: weights, statistics and Adam "
                    f"state bit-equal {bit_equal}")
            if not bit_equal:
                failures.append("deterministic tacotron runs differ")
    finally:
        for p in det:
            if p.poll() is None:
                p.kill()
                p.wait()
    return paths


def _bf16_copy(src: Path, dst: Path, kinds, log_directory=None, **over):
    """Copy ``data_config.yaml`` and the ``kinds``' configs of config dir
    ``src`` into ``dst``, each model config with ``precision: bfloat16``
    and ``over``, the data config with ``log_directory`` where given."""
    import shutil
    import yaml
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for kind in ("data", *kinds):
        cfg = yaml.safe_load((src / f"{kind}_config.yaml").read_text())
        if kind != "data":
            cfg.update(over, precision="bfloat16")
        elif log_directory is not None:
            cfg["log_directory"] = log_directory
        (dst / f"{kind}_config.yaml").write_text(yaml.safe_dump(cfg))
    return dst


def bf16_grad_check(names, card_g, cpu_g, f32_g):
    """The card's bf16 gradients against the CPU's: (the worst tensor's
    ||d|| / max(BF16_GRAD_RTOL * ||g||, BF16_NOISE * ||g - g_f32||), g the
    CPU's bf16 gradient and g_f32 its float32 one, and the tensor's name;
    the card's and the CPU's norm-relative distance from the CPU's float32
    step over all the gradients). Within the bars where the first is at
    most 1 and the card's distance within a factor BF16_DIST of the
    CPU's."""
    import torch
    worst = (0.0, "-")
    for n, a, b, f in zip(names, card_g, cpu_g, f32_g):
        a, b, f = a.double(), b.double(), f.double()
        bar = max(BF16_GRAD_RTOL * float(b.norm()),
                  BF16_NOISE * float((b - f).norm()), 1e-30)
        worst = max(worst, (float((a - b).norm()) / bar, n))
    flat = lambda g: torch.cat([x.double().ravel() for x in g])
    f = flat(f32_g)
    dist = [float((flat(g) - f).norm() / f.norm()) for g in (card_g, cpu_g)]
    return worst, dist


def bf16_phase(cl, tts32, voc, ref_mel, spk, batch_s, failures):
    """Phase 14: ``precision: bfloat16`` (bf16 compute on float32
    parameters) in the AR and forward models, configs/default with the key
    written into a copy of its configs under ``build/``:
      1. the 14k export in the bf16 model: SENTENCE through the fused
         decode and B1 (the launches read around it), against the bf16
         model's plain decode on the card (BF16_DECODE_LEN,
         BF16_DECODE_MEAN), the float32 model's (``tts32``, phase 4's)
         distance beside it as the control; text -> wav RTF;
         ``predict_many`` on the 8 serving texts (no kernel launch; phase
         6's float32 decode time ``batch_s`` beside); a bf16 stream of
         STREAM_CHUNK-step chunks at phase 7's STREAM_MAX_LENGTH, its mel
         against the plain decode's, bit for bit;
      2. the forward model (seeded, as phase 8's) at max_frames 1280, bf16
         against float32 on the same durations (BF16_FWD_TOL), each pass
         timed by CUDA events;
      3. ``train_autoregressive`` on phase 9's corpus and config in bf16
         for BF16_TRAIN_STEPS steps with ``--profile_dir`` (the trace of
         steps 10-30, each a span) and prediction audio every 10 steps
         from step 0 (the wavs finite, at the config's rate); ms/step,
         target frames/s and peak memory beside phase 9's float32 run;
         ``train_forward`` on phase 11's durations in bf16 for
         BF16_FWD_STEPS steps beside phase 11's float32 run;
      4. one AR and one forward bf16 train step on the BF16_CPU_ROWS
         shortest rows, dropout 0, the card's gradients against the CPU's
         (``bf16_grad_check``: BF16_GRAD_RTOL, BF16_NOISE, BF16_DIST).
    Failed checks go to ``failures``; returns the bf16 runs' launches
    ({path: read_launches()})."""
    import statistics
    import numpy as np
    import torch
    from etts_torch import train_autoregressive, train_forward
    from etts_torch.api import TTSSynthesizer
    from etts_torch.convert import load_into, seeded_flat
    from etts_torch.data.audio_io import load_wav
    from etts_torch.data.dataset import (DataPrepper, Dataset,
                                         ForwardDataPrepper, load_files)
    from etts_torch.models.autoregressive import autoregressive_predict
    from etts_torch.models.init import init_flax
    from etts_torch.ops.normalizers import vocoder_mel
    from etts_torch.text import default_tokenizer
    from etts_torch.train.steps import (make_autoregressive_train_step,
                                        make_forward_train_step)
    from etts_torch.utils.config import (ConfigManager, build_forward,
                                         build_tts, load_config,
                                         text_pipeline)
    from etts_torch.utils.logging import read_scalars
    dev = torch.device("cuda")
    build = ROOT / "build"
    paths = {}
    sr = voc.config["sampling_rate"]

    # 1. serving
    cdir = _bf16_copy(CONFIG, build / "phase14_config",
                      ("autoregressive", "forward"))
    tts = TTSSynthesizer(cdir, TTS_W, "cuda", step=14000,
                         phonemizer_backend="grapheme")
    if tts.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in tts.model.parameters()):
        failures.append("bf16 config: not bf16 compute on float32 weights")
    tts.predict(SENTENCE, ref_mel, spk, max_length=1000, seed=0)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tts.predict(SENTENCE, ref_mel, spk, max_length=1000, seed=0)
    mel = out["mel"]
    wav = voc.generate(vocoder_mel(torch.from_numpy(mel),
                                   tts.mel_dtype).numpy(), seed=0)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    ran = paths["bf16_main"] = read_launches()
    audio_s = wav.shape[0] / sr
    want = {k: int(k in ("fused_decode", "wavernn_sample_loop")) for k in ran}
    if ran != want:
        failures.append(f"bf16 main path launches {ran}, want {want}")
    if not (np.isfinite(mel).all() and np.isfinite(wav).all()
            and np.abs(wav).max() <= 1.0):
        failures.append("bf16 main path: mel or wav not finite")

    def fused_vs_plain(t):
        """(B2's mel, the model's plain decode's mel, frames apart, mean
        |d| over the frames both have)."""
        with torch.no_grad():
            k_mel = t.predict(SENTENCE, ref_mel, spk, max_length=1000,
                              seed=0)["mel"]
            inp, ref, spk_t = t._stream_inputs(SENTENCE, ref_mel, spk)
            o = autoregressive_predict(
                t.model, inp, ref, spk_t, r=t.r, max_length=1000,
                prenet_dropout=t.prenet_dropout,
                generator=torch.Generator(dev).manual_seed(0))
        p_mel = o["mel"][0, :o["mel_length"]].float().cpu().numpy()
        n = min(len(k_mel), len(p_mel))
        return (len(k_mel), len(p_mel), abs(len(k_mel) - len(p_mel)),
                float(np.abs(k_mel[:n] - p_mel[:n]).mean()),
                float(np.abs(k_mel[:n] - p_mel[:n]).max()))
    b16, f32 = fused_vs_plain(tts), fused_vs_plain(tts32)
    say(cl, f"bf16 model (14k export): SENTENCE -> {mel.shape[0]} frames in "
            f"{out['steps']} steps -> {wav.shape[0]} samples; text -> wav "
            f"{e2e:.3f} s, RTF {e2e / audio_s:.4f}; launches {ran}")
    say(cl, "fused decode against the plain decode on the card: bf16 model "
            f"{b16[0]} vs {b16[1]} frames, mean |dmel| {b16[3]:.4f} over the "
            f"common frames (max {b16[4]:.3f}; bars: frames apart <= "
            f"{BF16_DECODE_LEN} of the plain decode's, mean "
            f"{BF16_DECODE_MEAN}); float32 model (the control) {f32[0]} vs "
            f"{f32[1]} frames, mean |dmel| {f32[3]:.4f} (max {f32[4]:.3f})")
    if not (b16[2] <= BF16_DECODE_LEN * b16[1] and b16[3] <= BF16_DECODE_MEAN):
        failures.append("bf16 fused decode against the plain bf16 decode")

    zero_launches()
    ms, mels = cuda_ms(lambda: tts.predict_many(
        SERVING_TEXTS, ref_mel, spk, max_length=1000, seed=0), 1, warm=False)
    ran = paths["bf16_serving_decode"] = read_launches()
    if any(ran.values()) or not all(np.isfinite(x).all() for x in mels):
        failures.append(f"bf16 predict_many: launches {ran} or not finite")
    say(cl, f"bf16 predict_many: {len(SERVING_TEXTS)} texts -> "
            f"{[x.shape[0] for x in mels]} frames in one decode, {ms / 1e3:.3f}"
            f" s (float32, phase 6: {batch_s:.3f} s); launches {ran}")

    kw = dict(max_length=STREAM_MAX_LENGTH, mel_chunk=STREAM_CHUNK, seed=0)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = list(tts.stream(SENTENCE, voc, ref_mel, spk, **kw))
    st_s = time.perf_counter() - t0
    ran = paths["bf16_stream"] = read_launches()
    swav = np.concatenate(chunks)
    mel_s = np.concatenate(list(tts.stream_mels(SENTENCE, ref_mel, spk,
                                                **kw)))
    inp, ref, spk_t = tts._stream_inputs(SENTENCE, ref_mel, spk)
    with torch.no_grad():
        o = autoregressive_predict(
            tts.model, inp, ref, spk_t, r=tts.r,
            max_length=STREAM_MAX_LENGTH, prenet_dropout=tts.prenet_dropout,
            generator=torch.Generator(dev).manual_seed(0))
    mel_p = o["mel"][0, :o["mel_length"]].float().cpu().numpy()
    same = mel_s.shape == mel_p.shape and bool((mel_s == mel_p).all())
    want = {k: 0 for k in ran} | {"wavernn_sample_loop": len(chunks)}
    say(cl, f"bf16 stream, mel_chunk {STREAM_CHUNK} at r = {tts.r}, "
            f"max_length {STREAM_MAX_LENGTH}: {len(chunks)} chunks, "
            f"{swav.shape[0]} samples in {st_s:.3f} s, stream RTF "
            f"{st_s / (swav.shape[0] / sr):.4f}; launches {ran}; its mel "
            f"equal to the plain bf16 decode's: {same}")
    if not (ran == want and same and np.isfinite(swav).all()
            and mel_s.shape[0] * voc.model.hop_length == swav.shape[0]):
        failures.append("bf16 stream")

    # 2. the forward model at 1280 frames, bf16 against float32
    models = {}
    for label, d in (("bf16", cdir), ("float32", CONFIG)):
        cfg = load_config(d, "forward")
        vocab = text_pipeline(cfg, "grapheme", "forward").tokenizer.vocab_size
        flat = seeded_flat(build_forward(cfg, vocab), 11)
        flat["['dur_pred']['linear']['bias']"][:] = FWD_FRAMES_PER_TOKEN
        models[label] = load_into(build_forward(cfg, vocab), flat).to(dev)
    pipe = text_pipeline(cfg, "grapheme", "forward")
    ids = torch.tensor(pipe(SENTENCE))[None].to(dev)
    cap = int(cfg["max_frames"])
    with torch.no_grad():
        f_ms = {k: cuda_ms(lambda: m(ids, max_frames=cap), 5)[0]
                for k, m in models.items()}
        dur = torch.round(models["float32"](ids, max_frames=cap)["duration"])
        o16, o32 = (models[k](ids, dur, max_frames=cap)
                    for k in ("bf16", "float32"))
    d_fwd = float((o16["mel"].float() - o32["mel"]).norm()
                  / o32["mel"].norm())
    say(cl, f"forward model at max_frames {cap} ({int(o32['mel_lengths'][0])}"
            f" frames of SENTENCE): bf16 {f_ms['bf16']:.3f} ms, float32 "
            f"{f_ms['float32']:.3f} ms a pass (CUDA events, mean of 5); bf16 "
            f"mel against float32 on the same durations, norm-relative "
            f"{d_fwd:.3e} (tol {BF16_FWD_TOL})")
    if not (d_fwd <= BF16_FWD_TOL and o16["mel"].dtype == torch.bfloat16):
        failures.append("bf16 forward model against float32")
    del models, o16, o32

    # 3. the drivers
    tdir = _bf16_copy(build / "phase9_config", build / "phase14_train",
                      ("autoregressive",), str(build / "phase14_logs"),
                      audio_start_step=0, audio_prediction_frequency=10)
    prof = build / "phase14_trace"
    secs, outp, base = run_main(train_autoregressive.main, [
        "--config", str(tdir), "--session_name", "phase14", "--max_steps",
        str(BF16_TRAIN_STEPS), "--profile_dir", str(prof)])
    cm = ConfigManager(tdir, "autoregressive", "phase14")
    trace = prof / f"trace_steps_{BF16_TRACE[0]}-{BF16_TRACE[1]}.json"
    spans = set()
    if trace.exists():
        spans = set(re.findall(r'"name": "(step \d+)"', trace.read_text()))
    want_spans = {f"step {n}" for n in range(BF16_TRACE[0],
                                             BF16_TRACE[1] + 1)}
    wavs = {}
    for step in range(9, BF16_TRAIN_STEPS, 10):
        p = cm.log_dir / f"prediction_audio_{step}.wav"
        if p.exists():
            w, rate = load_wav(p)
            wavs[step] = (len(w), rate, bool(np.isfinite(w).all()),
                          float(np.abs(w).max()))
    sc = read_scalars(cm.log_dir)

    def speed(span):
        ms = [sc["time/step_ms"][i] for i in span]
        fr = sum(sc["meta/target_frames"][i] for i in span)
        return statistics.median(ms), fr / sum(ms) * 1e3
    quiet = [*range(2, BF16_TRACE[0]), BF16_TRAIN_STEPS - 1]
    med, fps = speed(quiet)
    med_t, _ = speed(range(BF16_TRACE[0] + 1, BF16_TRACE[1]))
    f9 = F32_TRAIN.get("autoregressive", {})
    peak = sc.get("meta/max_memory_allocated", {}).get(BF16_TRAIN_STEPS - 1)
    losses = sc.get("train/loss", {})
    say(cl, f"train_autoregressive in bf16, {BF16_TRAIN_STEPS} steps on "
            f"phase 9's corpus and config: {secs:.1f} s; median "
            f"{med:.2f} ms/step over steps {quiet[0]}-{quiet[-2]} and "
            f"{quiet[-1]} ({med_t:.2f} under the profiler), {fps:.0f} target "
            f"frames/s; peak memory "
            f"{(peak - base) / 2**30 if peak else float('nan'):.3f} GiB; "
            f"float32 (phase 9, steps 5-{TRAIN_STEPS[0] - 1}): "
            f"{f9.get('ms', float('nan')):.2f} ms/step, "
            f"{f9.get('fps', float('nan')):.0f} target frames/s, peak "
            f"{f9.get('gib', float('nan')):.3f} GiB; losses "
            f"{dict(sorted(losses.items()))}")
    say(cl, f"--profile_dir: {trace.name} "
            f"{trace.stat().st_size / 2**20 if trace.exists() else 0:.1f} "
            f"MiB, step spans {min(spans, default='-')} .. "
            f"{max(spans, default='-')} ({len(spans)}); prediction audio "
            f"(steps: samples, rate, finite, peak) {wavs}")
    if spans != want_spans:
        failures.append(f"profiler trace spans {sorted(spans)}")
    if not (sorted(wavs) == [9, 19, 29] and all(
            n > 0 and rate == sr and fin for n, rate, fin, _ in
            wavs.values())):
        failures.append(f"prediction audio {wavs}")
    if not (len(losses) and all(math.isfinite(v) for v in losses.values())
            and peak):
        failures.append(f"bf16 training log: losses {losses}, peak {peak}")

    fdir = _bf16_copy(build / "phase11_config", build / "phase14_forward",
                      ("forward",), str(build / "phase14_logs"))
    secs, outp, _ = run_main(train_forward.main, [
        "--config", str(fdir), "--session_name", "phase14", "--max_steps",
        str(BF16_FWD_STEPS)])
    fsc = read_scalars(ConfigManager(fdir, "forward", "phase14").log_dir)
    f11 = read_scalars(ConfigManager(build / "phase11_config", "forward",
                                     "phase11").log_dir)
    fl = fsc.get("train/loss", {})
    fmed = statistics.median(fsc["time/step_ms"][i]
                             for i in range(1, BF16_FWD_STEPS))
    fmed11 = statistics.median(f11["time/step_ms"][i]
                               for i in range(5, FT_STEPS[0]))
    say(cl, f"train_forward in bf16, {BF16_FWD_STEPS} steps on phase 11's "
            f"durations: {secs:.1f} s; median {fmed:.2f} ms/step over steps "
            f"1-{BF16_FWD_STEPS - 1} (float32, phase 11: {fmed11:.2f}); "
            f"losses {dict(sorted(fl.items()))}")
    if not (fl and all(math.isfinite(v) for v in fl.values())):
        failures.append(f"bf16 train_forward losses {fl}")

    # 4. the card's bf16 gradients against the CPU's
    c = cm.config
    tok = default_tokenizer(True)
    samples, _ = load_files(Path(c["train_data_directory"])
                            / "train_metafile.txt",
                            Path(c["train_data_directory"]) / "mels",
                            Path(c["train_data_directory"]) / "spk_embeds")
    short = sorted(samples, key=lambda x: np.load(x[2], mmap_mode="r")
                   .shape[0])[:BF16_CPU_ROWS]
    host = Dataset(short, DataPrepper(c, tok), BF16_CPU_ROWS, shuffle=False,
                   mel_channels=c["mel_channels"]).next_batch()
    r = c["reduction_factor_schedule"][0][1]
    fc = ConfigManager(fdir, "forward", "phase14").config
    fcap = int(fc["max_frames"])
    files = sorted((Path(c["train_data_directory"]) / "forward_data"
                    / "train").glob("*.npy"),
                   key=lambda f: np.load(f, allow_pickle=True)[0].shape[0])
    fhost = Dataset(files[:BF16_CPU_ROWS], ForwardDataPrepper(),
                    BF16_CPU_ROWS, shuffle=False,
                    mel_channels=fc["mel_channels"],
                    pad_mel_multiple=fcap).next_batch()

    def ar_grads(where, precision):
        model = build_tts(dict(c, dropout_rate=0.0, precision=precision),
                          tok.vocab_size)
        init_flax(model, torch.Generator().manual_seed(
            train_autoregressive.SEED)).to(where)
        state = grad_capture(model, c["learning_rate_tts_schedule"])
        make_autoregressive_train_step(
            model, stop_scaling=c["stop_loss_scaling"])(
            state, train_autoregressive.to_device(host, where), 0.0, 0, r=r,
            prenet_dropout=0.0)
        return state.names, state.grads

    def fwd_grads(where, precision):
        model = build_forward(dict(fc, precision=precision),
                              default_tokenizer(False).vocab_size,
                              dropout_rate=0.0)
        init_flax(model, torch.Generator().manual_seed(
            train_autoregressive.SEED)).to(where)
        state = grad_capture(model, fc["learning_rate_tts_schedule"])
        make_forward_train_step(model, fcap)(
            state, train_forward.to_device(fhost, where), 0)
        return state.names, state.grads
    for label, run, shape in (("AR", ar_grads, host[0].shape),
                              ("forward", fwd_grads, fhost[0].shape)):
        t0 = time.perf_counter()
        names, g_card = run("cuda", "bfloat16")
        _, g_cpu = run("cpu", "bfloat16")
        _, g_f32 = run("cpu", "float32")
        worst, dist = bf16_grad_check(names, g_card, g_cpu, g_f32)
        say(cl, f"{label} train step in bf16, card vs CPU (batch {shape}, "
                f"dropout 0): worst gradient {worst[1]}: |d| / max("
                f"{BF16_GRAD_RTOL} |g|, {BF16_NOISE} |g - g_float32|) "
                f"{worst[0]:.3f} (tol 1); from the CPU's float32 step: card "
                f"{dist[0]:.3e}, CPU {dist[1]:.3e} (within x{BF16_DIST}) "
                f"({time.perf_counter() - t0:.1f} s)")
        if not (worst[0] <= 1.0
                and dist[1] / BF16_DIST <= dist[0] <= dist[1] * BF16_DIST):
            failures.append(f"{label} bf16 step, card vs CPU")
    return paths


def _ctc_step_check(cl, pairs, sr, failures):
    """The char-CTC train step card against CPU in float64 from one init and
    batch (EV_CTC_CPU_ROWS utterances) at phase 11's FT_* bars."""
    import torch
    from etts_torch.evalsuite.ctc_asr import (CTCAsrModel, ctc_loss,
                                              prepare_batch)

    def grads(where, batch, dtype):
        model = CTCAsrModel().reset_parameters(
            torch.Generator().manual_seed(0)).to(where, dtype)
        batch = [b.to(where) for b in batch]
        batch[0] = batch[0].to(dtype)
        loss = ctc_loss(model, *batch)
        loss.backward()
        return (float(loss.detach()), [n for n, _ in model.named_parameters()],
                [p.grad.detach().cpu() for p in model.parameters()])
    host = prepare_batch(pairs[:EV_CTC_CPU_ROWS], sr, 40, "cpu")
    (l_g, names, g_g), (l_c, _, g_c) = (grads(w, host, torch.float64)
                                        for w in ("cuda", "cpu"))
    worst = worst_grad(names, g_g, g_c, FT_GRAD_ATOL)
    say(cl, f"char-CTC train step in float64, card vs CPU ({len(host[1])} "
            f"utterances, mels {tuple(host[0].shape)}): loss {l_g:.6f} vs "
            f"{l_c:.6f} (|d| / loss {abs(l_g - l_c) / abs(l_c):.3e}, tol "
            f"{FT_LOSS_TOL}); worst gradient {worst[1]}: (||d|| - "
            f"{FT_GRAD_ATOL}) / ||g|| {worst[0]:.3e} (tol {FT_GRAD_RTOL})")
    if not (abs(l_g - l_c) <= FT_LOSS_TOL * abs(l_c)
            and worst[0] <= FT_GRAD_RTOL):
        failures.append("char-CTC step, card vs CPU")


def _ctc_step_ms(pairs, sr):
    """The float32 char-CTC train step on the card at the transcriber's
    training batch (``pairs``), timed over EV_CTC_TIMED steps after 2:
    (ms a step, the batch's mel shape)."""
    import torch
    from etts_torch.evalsuite.ctc_asr import (CTCAsrModel, ctc_loss,
                                              prepare_batch)
    batch = prepare_batch(pairs, sr, 40, "cuda")
    model = CTCAsrModel().reset_parameters(
        torch.Generator().manual_seed(0)).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, betas=(0.9, 0.999),
                           eps=1e-8)

    def step():
        loss = ctc_loss(model, *batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EV_CTC_TIMED):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / EV_CTC_TIMED * 1e3, tuple(
        batch[0].shape)


def _etts_eval_row() -> dict:
    """etts' recorded free-running evaluation of its step-EV_STEP
    checkpoint (``artifacts/soak/eval_curve.csv``, a TPU run)."""
    import csv
    with open(EV_ETTS_CURVE) as f:
        return next(r for r in csv.DictReader(f) if int(r["step"]) == EV_STEP)


def _eval_runs(cl, root, corpus, test6, test_rows, train_rows,
               failures) -> dict:
    """Phase 15's steps 3, 5, 6 and 7 (``eval_phase``), which need no
    transcriber; ``test6`` the EV_SENTENCES held-out rows' metafile.
    Returns their {path: read_launches()}."""
    import csv
    import numpy as np
    from etts_torch import (eval_disentanglement, eval_expressive_control,
                            export_gst_embeddings, make_combo_file,
                            synthesize_speaker)
    paths = {}
    # 3. the held-out sentences through B2 and B1, B3, Griffin-Lim
    test1 = root / "test_sentence_int8.txt"
    test1.write_text(test_rows[0] + "\n")
    combos = root / "combos.txt"
    make_combo_file.main(["--metafile", str(test6), "--out", str(combos),
                          "--n", str(EV_SENTENCES)])
    common = ["--tts_config", str(corpus), "--tts_weights", str(TTS_W),
              "--tts_step", str(EV_STEP), "--ref_audio_dir",
              str(corpus / "wavs"), "--spk_embed_dir",
              str(corpus / "spk_embeds"), "--max_length", str(EV_MAX_LENGTH),
              "--device", "cuda"]
    voc = ["--voc_config", str(CONFIG), "--voc_weights", str(VOC_W)]
    n_rand = len(set(combos.read_text().split()))
    # (path, output dir, each run's arguments, the launches, the wavs):
    # syn_norm each held-out sentence once, rand the combo file's rows
    runs = (("eval_speaker", "b1",
             [[*voc, "--test_sentences", str(test6), "--regimes",
               "syn_norm"],
              [*voc, "--test_sentences", str(test6), "--combo_file",
               str(combos), "--regimes", "rand"]],
             {"fused_decode": 2 * EV_SENTENCES,
              "wavernn_sample_loop": 2 * EV_SENTENCES},
             EV_SENTENCES + n_rand),
            ("eval_speaker_int8", "b3",
             [[*voc, "--test_sentences", str(test1), "--int8"]],
             {"fused_decode": 1, "wavernn_sample_loop_int8": 1}, 1),
            ("eval_speaker_gl", "gl", [["--test_sentences", str(test6)]],
             {"fused_decode": EV_SENTENCES}, EV_SENTENCES))
    for path, name, arg_sets, want, n_wavs in runs:
        zero_launches()
        secs = sum(run_main(synthesize_speaker.main,
                            common + args + ["--out_dir", str(root / name)])[0]
                   for args in arg_sets)
        paths[path] = ran = read_launches()
        wavs = sorted((root / name).rglob("*.wav"))
        say(cl, f"synthesize_speaker ({path}): {len(wavs)} wavs in "
                f"{secs:.1f} s; launches {ran}")
        if ran != {k: 0 for k in ran} | want or len(wavs) != n_wavs:
            failures.append(f"synthesize_speaker {path}: launches {ran}, "
                            f"{len(wavs)} wavs")

    # 5. the GST embeddings
    secs, _, _ = run_main(export_gst_embeddings.main, [
        "--config", str(corpus), "--weights", str(TTS_W), "--out_dir",
        str(root / "gst"), "--device", "cuda"])
    embs = {p.stem: np.load(p) for p in (root / "gst").glob("*.npy")}
    ok = (sorted(embs) == sorted(r.split("|")[0] for r in train_rows)
          and all(np.isfinite(e).all() for e in embs.values()))
    say(cl, f"export_gst_embeddings: {len(embs)} embeddings of shape "
            f"{next(iter(embs.values())).shape} in {secs:.2f} s; one finite "
            f"file per training utterance: {ok}")
    if not ok:
        failures.append("export_gst_embeddings")

    # 6. disentanglement with fresh critics
    secs, out, _ = run_main(eval_disentanglement.main, [
        "--config", str(corpus), "--weights", str(TTS_W), "--steps",
        str(EV_STEP), "--probe_first_token", "--club", "--seeds", "1",
        "--critic_steps", str(EV_CRITIC_STEPS), "--max_batches",
        str(EV_BATCHES), "--out", str(root / "mi.csv"), "--device", "cuda"])
    with open(root / "mi.csv") as f:
        mi = list(csv.DictReader(f))
    say(cl, f"eval_disentanglement ({EV_BATCHES} batches of 8, "
            f"{EV_CRITIC_STEPS} critic steps, 1 seed) in {secs:.1f} s: "
            + " | ".join(ln.strip() for ln in out.splitlines()
                         if "probe" in ln or "bound" in ln))
    if len(mi) != 3 or not all(np.isfinite(float(r["mi_mean"]))
                               for r in mi):
        failures.append(f"eval_disentanglement: {mi}")

    # 7. expressive control
    zero_launches()
    secs, out, _ = run_main(eval_expressive_control.main, [
        "--config", str(corpus), "--weights", str(TTS_W), "--step",
        str(EV_STEP), "--out_dir", str(root / "expressive"), "--n_utts",
        str(EV_EXPR_UTTS), "--device", "cuda"])
    paths["eval_expressive"] = ran = read_launches()
    verdicts = re.findall(r"^(\w+_TRACKING): (PASS|FAIL)$", out, re.M)
    say(cl, f"eval_expressive_control ({EV_EXPR_UTTS} sentences) in "
            f"{secs:.1f} s, launches {ran}: " + " | ".join(
                ln.strip() for ln in out.splitlines()
                if ln.startswith(("carrier", "GT", "mean output",
                                  "speaker-swap"))) + f"; verdicts "
            f"{dict(verdicts)}")
    n_runs = EV_EXPR_UTTS * 6
    if len(verdicts) != 3 or ran != {k: 0 for k in ran} | {
            "fused_decode": n_runs}:
        failures.append(f"eval_expressive_control: {verdicts}, {ran}")
    return paths


def eval_phase(cl, failures):
    """Phase 15: the evaluation suite, scored on the card against the
    14k export's own held-out corpus; each entry point's ``main`` runs in
    this process but ``train_ctc_asr``'s:
      1. ``make_synth_corpus`` (EV_UTTS utterances, seed 0: the corpus the
         export was trained on) and ``create_dataset`` (grapheme) on the
         card: the store's split (20 held out);
      2. ``train_ctc_asr`` on the card on EV_CTC_UTTS utterances of the
         training split for EV_CTC_STEPS steps (the final loss, the
         train-set WER), in a process of its own while its step is held
         card against CPU in float64 (``_ctc_step_check``) and steps 3, 5,
         6 and 7 run (``_eval_runs``); then its float32 step timed
         (``_ctc_step_ms``) and step 4;
      3. ``synthesize_speaker`` with the 14k export (its step sets r and
         the prenet dropout from the corpus's schedules) and the 26k
         vocoder on EV_SENTENCES held-out sentences in regimes syn_norm and
         rand (a ``make_combo_file`` file), B2's and B1's launches read
         around it (one each an utterance); one utterance with ``--int8``
         (B3); syn_norm through Griffin-Lim (B2 only);
      4. ``objective_measure`` of those directories against the corpus's
         wavs, WER through step 2's checkpoint: every pair scored, no
         metric NaN but PESQ without the ``pesq`` package and F0-RMSE
         where a pair has no frame voiced in both; the metrics by
         regime and vocoder beside the length ratio syn / GT and etts'
         recorded row (a TPU run, not a bar); the DTW library's path
         against the numpy version's on one pair, on the host;
      5. ``export_gst_embeddings`` of the export: one finite file per
         training utterance;
      6. ``eval_disentanglement --probe_first_token --club``: the MI lower
         and upper bounds, the probe's accuracy against chance;
      7. ``eval_expressive_control`` on EV_EXPR_UTTS sentences: its three
         verdicts (a FAIL is a finding; a void sanity check raises), the
         launches read around it.
    Failed checks go to ``failures``; returns {path: read_launches()} for
    "eval_speaker", "eval_speaker_int8", "eval_speaker_gl" and
    "eval_expressive"."""
    import csv
    import importlib.util
    import os
    import shutil
    import numpy as np
    from etts_torch import (create_dataset, make_synth_corpus,
                            objective_measure, train_ctc_asr)
    from etts_torch.data.audio_io import load_wav
    from etts_torch.evalsuite.dtw import dtw_path
    from etts_torch.evalsuite.metrics import f0_rmse, mel_cepstrum
    from etts_torch.utils.config import load_config, schedule_values
    root = ROOT / "build" / "phase15"
    shutil.rmtree(root, ignore_errors=True)
    corpus = root / "corpus"
    paths = {}

    # 1. the corpus and its store
    secs, _, _ = run_main(make_synth_corpus.main, [
        "--out", str(corpus), "--n_utts", str(EV_UTTS), "--seed", "0"])
    secs2, _, _ = run_main(create_dataset.main, [
        "--config", str(corpus), "--phonemizer_backend", "grapheme",
        "--njobs", "8", "--device", "cuda"])
    train_rows = (corpus / "train_metafile.txt").read_text().splitlines()
    test_rows = (corpus / "test_metafile.txt").read_text().splitlines()
    sched = schedule_values(load_config(corpus, "autoregressive"), EV_STEP)
    say(cl, f"make_synth_corpus ({EV_UTTS} utterances, seed 0): {secs:.2f} "
            f"s; create_dataset on the card: {secs2:.2f} s; split "
            f"{len(train_rows)} train / {len(test_rows)} held out; the "
            f"corpus's schedules at step {EV_STEP}: r = "
            f"{sched['reduction_factor']}, prenet dropout "
            f"{sched['decoder_prenet_dropout']}")
    if len(test_rows) != 20:
        failures.append(f"phase 15 store: {len(test_rows)} held out")
    test6 = root / "test_sentences.txt"
    test6.write_text("\n".join(test_rows[:EV_SENTENCES]) + "\n")

    # 2. the char-CTC transcriber's training on the training split in a
    # process of its own (host-bound) while its step is held card against
    # CPU and steps 3, 5, 6 and 7 run; read, and its step timed, before 4
    ctc = root / "ctc.npz"
    t_ctc = time.perf_counter()
    ctc_proc = subprocess.Popen(
        [sys.executable, "-m", "etts_torch.train_ctc_asr", "--metadata",
         str(corpus / "train_metafile.txt"), "--wav_dir", str(corpus / "wavs"),
         "--out", str(ctc), "--steps", str(EV_CTC_STEPS), "--max_utts",
         str(EV_CTC_UTTS), "--device", "cuda"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        pairs, sr = train_ctc_asr.read_pairs(corpus / "train_metafile.txt",
                                             corpus / "wavs", EV_CTC_UTTS)
        _ctc_step_check(cl, pairs, sr, failures)
        paths |= _eval_runs(cl, root, corpus, test6, test_rows, train_rows,
                            failures)
        out, err = ctc_proc.communicate(timeout=900)
    finally:
        if ctc_proc.poll() is None:
            ctc_proc.kill()
            ctc_proc.communicate()
    secs = time.perf_counter() - t_ctc
    step_ms, shape = _ctc_step_ms(pairs, sr)
    if ctc_proc.returncode != 0:
        raise RuntimeError(f"train_ctc_asr failed: {err[-2000:]}")
    loss = float(re.search(r"final ctc loss (\S+);", out).group(1))
    say(cl, f"train_ctc_asr on the card, in a process of its own: "
            f"{EV_CTC_UTTS} utterances, {EV_CTC_STEPS} steps in {secs:.1f} s "
            f"(the process's start, the mels and the checkpoint included; "
            f"the card and the host shared with steps 3 and 5-7); the "
            f"float32 step at mels {shape}: {step_ms:.2f} ms/step (host "
            f"clock, synchronised, {EV_CTC_TIMED} steps, its process ended); "
            f"final loss "
            f"{loss:.4f}; " + " | ".join(ln for ln in out.splitlines()
                                        if "WER" in ln))
    if not np.isfinite(loss):
        failures.append("train_ctc_asr: loss not finite")

    # 4. the scores
    if importlib.util.find_spec("speech_recognition") is not None:
        raise RuntimeError("the SpeechRecognition package is installed: its "
                           "recognizer, the first WER backend, needs the "
                           "network")
    pesq_absent = importlib.util.find_spec("pesq") is None
    syn_dirs = [root / "b1" / "syn_norm", root / "b1" / "rand",
                root / "gl" / "syn_norm"]
    scores = root / "scores"
    secs, out, _ = run_main(objective_measure.main, [
        "--ref_dir", str(corpus / "wavs"), "--syn_dirs",
        *map(str, syn_dirs), "--texts", str(test6), "--ctc_asr", str(ctc),
        "--workers", "8", "--out", str(scores / "all_score.log"),
        "--device", "cuda"])
    etts_row = _etts_eval_row()
    with open(scores / "all_score.log") as f:
        table = {r["model"]: r for r in csv.DictReader(f, delimiter="\t")}
    n_pairs = sum(len(list(d.glob("*.wav"))) for d in syn_dirs)
    heard = re.search(r"WER backend: (\S+)", out)[1]
    say(cl, f"objective_measure: {n_pairs} pairs in {secs:.1f} s (8 metric "
            f"workers, the WER through the {heard} backend on the card; "
            f"transformers importable: "
            f"{importlib.util.find_spec('transformers') is not None})")
    for d, model in zip(syn_dirs, objective_measure.model_names(
            list(map(str, syn_dirs)))):
        with open(scores / f"score_{model}.csv") as f:
            rows = list(csv.DictReader(f))
        ratios = [len(load_wav(str(p))[0]) / len(load_wav(str(
            corpus / "wavs" / f"{p.stem.split('__')[0]}.wav"))[0])
                  for p in sorted(d.glob("*.wav"))]
        # no metric NaN but PESQ without the pesq package, and F0-RMSE
        # where the pair has no frame voiced in both (f0_rmse's own NaN)
        nan = [(r["file"], k) for r in rows
               for k in objective_measure.METRIC_KEYS
               if not np.isfinite(float(r[k] or "nan"))
               and not (k == "PESQ" and pesq_absent)]
        unvoiced = [f for f, k in nan if k == "RMSE_F0" and f0_rmse(
            *(load_wav(str(p), 16000)[0] for p in (
                corpus / "wavs" / f"{f.split('__')[0]}.wav", d / f)))[1] == 0]
        nan = [(f, k) for f, k in nan if f not in unvoiced or k != "RMSE_F0"]
        vocoder = "Griffin-Lim" if d.parent.name == "gl" else "B1 (26k export)"
        say(cl, f"{d.name} through {vocoder}: "
                + ", ".join(f"{k} {float(table[model][k]):.4f}"
                            for k in objective_measure.METRIC_KEYS)
                + f"; length syn / GT mean {np.mean(ratios):.3f} (min "
                f"{min(ratios):.3f}, max {max(ratios):.3f}); {len(rows)} "
                f"pairs scored; F0-RMSE NaN for no frame voiced in both: "
                f"{len(unvoiced)}; other non-finite: {nan}")
        if len(rows) != len(ratios) or not rows or nan:
            failures.append(f"objective_measure {model}: {len(rows)} of "
                            f"{len(ratios)} pairs, non-finite {nan}")
    say(cl, "etts' recorded row for its step-14000 checkpoint on this "
            "corpus (artifacts/soak/eval_curve.csv, a TPU run, its own "
            "transcriber and 20 sentences; printed beside, not a bar): "
            + ", ".join(f"{k} {v}" for k, v in etts_row.items()))
    ref_path = corpus / "wavs" / f"{test_rows[0].split('|')[0]}.wav"
    syn_path = sorted(syn_dirs[0].glob("*.wav"))[0]
    c_ref, c_syn = (mel_cepstrum(load_wav(str(p), 16000)[0])
                    for p in (ref_path, syn_path))
    t0 = time.perf_counter()
    lib = dtw_path(c_ref, c_syn)
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = dtw_path(c_ref, c_syn, backend="numpy")
    t_np = time.perf_counter() - t0
    say(cl, f"DTW of {syn_path.name}'s mel-cepstra ({len(c_ref)} x "
            f"{len(c_syn)}) on the host CPU: the library's distance and "
            f"path equal the numpy version's: {lib == plain} "
            f"({t_lib * 1e3:.2f} ms against {t_np * 1e3:.1f} ms)")
    if lib != plain:
        failures.append("DTW library against the numpy version")
    return paths


SIDE = "--side"


def side_main(out: Path) -> int:
    """``chip_smoke.py --side OUT``: phases 13 and 15, which ``main`` runs
    in this process of their own beside phase 12 (all three host-bound,
    the card idle most of the time); their lines to this process's output,
    {"paths": ..., "failures": [...]} to OUT."""
    cl, failures = card(), []
    say(cl, "phases 13 and 15, in a process of their own beside phase 12: "
            "the card and the host shared, their times and phase 12's not "
            "taken alone")
    t0 = time.perf_counter()
    paths = taco_train_phase(cl, ref_wav(), failures)
    say(cl, f"phase 13 took {time.perf_counter() - t0:.1f} s")

    # ---- 15. the evaluation suite on the 14k export's own corpus ----
    t0 = time.perf_counter()
    paths |= eval_phase(cl, failures)
    say(cl, f"phase 15 took {time.perf_counter() - t0:.1f} s")
    out.write_text(json.dumps({"paths": paths, "failures": failures}))
    return 0


def _start_side():
    """Start ``side_main`` in a session of its own (so that it and every
    process it starts can be stopped together), its output to files under
    build/side/."""
    import shutil
    root = ROOT / "build" / "side"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    logs = [open(root / name, "w") for name in ("stdout", "stderr")]
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), SIDE,
         str(root / "result.json")], cwd=ROOT, stdout=logs[0],
        stderr=logs[1], start_new_session=True)
    return proc, root, logs


def _finish_side(side, failures) -> dict:
    """Wait for ``side_main`` (at most SIDE_TIMEOUT s), print its output,
    add its failures to ``failures`` (a failed process is one); returns its
    {path: launches}."""
    proc, root, logs = side
    try:
        proc.wait(timeout=SIDE_TIMEOUT)
    except subprocess.TimeoutExpired:
        _stop_side(side)
    for log in logs:
        log.close()
    sys.stdout.write((root / "stdout").read_text())
    sys.stdout.flush()
    sys.stderr.write((root / "stderr").read_text())
    sys.stderr.flush()
    result = root / "result.json"
    if proc.returncode != 0 or not result.exists():
        failures.append(f"phases 13 and 15 (their process): return code "
                        f"{proc.returncode}")
        return {}
    res = json.loads(result.read_text())
    failures.extend(res["failures"])
    return res["paths"]


def _stop_side(side) -> None:
    """Kill ``side_main``'s session if it is still running."""
    import os
    import signal
    proc = side[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_mels(dev):
    """Phase 16's mels: DP_MEL_FRAMES frames (1.2 and 1.9 s at the 12.5 ms
    hop) of smooth seeded values in the vocoder's [0, 1]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(DP_SEED)
    out = []
    for n in DP_MEL_FRAMES:
        t = np.arange(n)[:, None] / 40.0
        f = np.arange(80)[None] / 80.0
        mel = 0.5 + 0.3 * np.sin(2 * np.pi * (t + f) + rng.uniform(0, 6)) \
            + 0.05 * rng.standard_normal((n, 80))
        out.append(torch.from_numpy(np.clip(mel, 0, 1).astype(np.float32))
                   .to(dev))
    return out


def _dp_driver_argv(session, *extra):
    return ["--config", str(ROOT / "build" / "phase9_config"),
            "--session_name", session, "--max_steps", str(DP_STEPS), *extra]


def dp_rank_main(rank: int, port: int, out: Path) -> int:
    """``chip_smoke.py --dp-rank R PORT OUT``: rank R of 2 in a gloo group
    on the one card. ``generate_batch_sharded`` over ``dp_mels`` (this
    rank's rows kept as the sample loop returned them, its launches read
    around the call), then ``train_autoregressive --multihost`` for
    DP_STEPS steps (its output and launches kept); all of it to
    OUT/rank{R}.pt."""
    import torch
    from etts_torch.models import wavernn as wv
    from etts_torch.parallel import init_multihost, local_device
    from etts_torch.api import VocoderSynthesizer
    init_multihost(f"127.0.0.1:{port}", 2, rank, "gloo")
    dev = local_device("cuda")
    voc = VocoderSynthesizer(CONFIG, VOC_W, dev)
    mels = dp_mels(dev)
    rows, loop = [], wv.wavernn_sample_loop

    def kept(*args, **kwargs):         # the loop itself, its output kept
        res = loop(*args, **kwargs)
        rows.append(res[0].clone())
        return res
    wv.wavernn_sample_loop = kept
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        wavs = wv.generate_batch_sharded(
            voc.model, mels, target=voc.config.get("voc_target", 11000),
            overlap=voc.config.get("voc_overlap", 550),
            mu_law=voc.config.get("mu_law", True), seed=DP_SEED,
            weights=voc.weights)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_launches()
    finally:
        wv.wavernn_sample_loop = loop
    from etts_torch.train_autoregressive import main as train_main
    zero_launches()
    t_train, text, _ = run_main(train_main, _dp_driver_argv(
        "phase16_gloo2", "--multihost", "--coordinator_address",
        f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
        str(rank), "--dist_backend", "gloo"))
    train_launches = read_launches()
    tp_res = tp_rank_cases(rank, dev, out)
    zero_launches()
    t_sp, sp_text, _ = run_main(train_main, [
        "--config", str(ROOT / "build" / "phase16_sp"), "--session_name",
        "phase16_sp2", "--max_steps", str(DP_STEPS), "--multihost",
        "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
        "2", "--process_id", str(rank), "--dist_backend", "gloo"])
    torch.save({"rows": [r.cpu() for r in rows],
                "wavs": [w.cpu() for w in wavs], "launches": ran,
                "seconds": secs, "train_launches": train_launches,
                "train_seconds": t_train, "train_out": text,
                "device": str(dev), "tp": tp_res, "sp_seconds": t_sp,
                "sp_out": sp_text, "sp_launches": read_launches()},
               out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def tp_model(kind: str):
    """configs/default's forward ("fwd"), AR ("ar") or WaveRNN ("voc")
    model at full width, etts' initialisers seeded TP_SEED, on the CPU."""
    import torch
    from etts_torch.models.init import init_flax
    from etts_torch.text import default_tokenizer
    from etts_torch.utils.config import (_mine_pair_types, build_forward,
                                         build_tts, build_vocoder,
                                         load_config)
    if kind == "fwd":
        model = build_forward(load_config(CONFIG, "forward"),
                              default_tokenizer(False).vocab_size)
    elif kind == "ar":
        c = load_config(CONFIG, "autoregressive")
        c["mine_pair_types"] = _mine_pair_types(c)
        model = build_tts(c, default_tokenizer(True).vocab_size)
    else:
        model = build_vocoder(load_config(CONFIG, "wavernn"))
    return init_flax(model, torch.Generator().manual_seed(TP_SEED))


def tp_batch(kind: str):
    """The kind's seeded global batch of TP_B rows (numpy): rows of
    different lengths, zero-padded as the datasets pad them."""
    import numpy as np
    rng = np.random.default_rng(TP_SEED)
    if kind == "fwd":
        n = 60
        phon = np.zeros((TP_B, n), np.int64)
        dur = np.zeros((TP_B, n), np.float32)
        mel = np.zeros((TP_B, TP_FWD_FRAMES, 80), np.float32)
        for i, k in enumerate((60, 52, 45, 38)):
            phon[i, :k] = rng.integers(1, 40, k)
            dur[i, :k] = rng.integers(2, 9, k)
            dur[i, :k] *= min(1.0, (TP_FWD_FRAMES - 1) / dur[i].sum())
            dur[i, :k] = np.floor(dur[i, :k])
            t = int(dur[i].sum())
            mel[i, :t] = rng.uniform(-4, 0, (t, 80))
        return mel, phon, dur
    if kind == "ar":
        mel = np.zeros((TP_B, TP_AR_FRAMES, 80), np.float32)
        stop = np.zeros((TP_B, TP_AR_FRAMES), np.int64)
        phon = np.zeros((TP_B, 50), np.int64)
        for i, (f, nl) in enumerate(zip((1.0, 0.85, 0.75, 0.6),
                                        (50, 44, 38, 30))):
            tl = int(TP_AR_FRAMES * f)
            mel[i, :tl] = rng.uniform(-4, 0, (tl, 80))
            mel[i, 0], mel[i, tl - 1] = 0.5, -0.5
            stop[i, :tl], stop[i, tl - 1] = 1, 2
            phon[i, :nl] = rng.integers(1, 40, nl)
        spk = rng.standard_normal((TP_B, 256)).astype(np.float32)
        return mel, phon, stop, spk / np.linalg.norm(spk, axis=-1,
                                                     keepdims=True)
    hop = 200
    x = rng.uniform(-1, 1, (TP_B, TP_VOC_HOPS * hop)).astype(np.float32)
    y = rng.uniform(-1, 1, (TP_B, TP_VOC_HOPS * hop)).astype(np.float32)
    mels = rng.uniform(0, 1, (TP_B, TP_VOC_HOPS + 4, 80)).astype(np.float32)
    return x, y, mels


def tp_case(kind: str, dtype, dev, mesh=None) -> tuple:
    """One train step of ``tp_model(kind)`` in ``dtype`` on ``dev`` with
    its noise on, on the rows of ``tp_batch(kind)`` this rank keeps, the
    model tensor-parallel over ``mesh``'s model axis where given (the
    whole model in this process without): ({"loss", "grad/<name>",
    "param/<name>", "stat/<name>"}, each whole (shards gathered), on the
    CPU; the model after the step)."""
    import torch
    from etts_torch.parallel import local_shard, tp
    from etts_torch.train.state import TrainState
    from etts_torch.train.steps import (fold_in, make_autoregressive_train_step,
                                        make_forward_train_step,
                                        make_wavernn_train_step)
    model = tp_model(kind).to(dtype).to(dev)

    class Capture(TrainState):
        def apply_gradients(self, grads):
            self.grads = [g.detach().clone() for g in grads]
            super().apply_gradients(grads)
    state = Capture(model, [[0, TP_LR]])
    if mesh is not None:
        tp.shard_train_state(state, mesh)
    batch = tuple(torch.from_numpy(x).to(dev) for x in
                  local_shard(tp_batch(kind), mesh))
    batch = tuple(x.to(dtype) if x.is_floating_point() else x
                  for x in batch)
    rng = fold_in(TP_SEED, 0)
    if kind == "fwd":
        metrics = make_forward_train_step(model, TP_FWD_FRAMES, mesh=mesh)(
            state, batch, rng)
    elif kind == "ar":
        metrics, _ = make_autoregressive_train_step(
            model, stop_scaling=8.0, mesh=mesh)(
            state, batch, 0.0, rng, r=TP_R, prenet_dropout=0.5,
            drop_n_heads=1)
    else:
        metrics = make_wavernn_train_step(model, mesh=mesh)(state, batch)
    out = {"loss": float(metrics["loss"])}
    grads = tp.gather_like(model, state.params, state.grads)
    out.update({f"grad/{n}": g.cpu() for n, g in zip(state.names, grads)})
    for n, t in tp.gathered_state_dict(model).items():
        if n.endswith(("running_mean", "running_var")):
            out[f"stat/{n}"] = t.cpu()
        elif not n.endswith("num_batches_tracked"):
            out[f"param/{n}"] = t.cpu()
    return out, model


def tp_held(got: dict, want: dict) -> tuple:
    """(the worst ratio of a tensor's distance to its bar, its name, the
    norm-relative distance of all the gradients together) of ``got``
    against ``want`` (``tp_case``'s). A gradient or BatchNorm statistic's
    bar: TP_GRAD_TOL of the tensor's largest magnitude plus TP_GRAD_ATOL.
    An updated parameter's adds, element by element, what Adam's first
    update lr * g / (|g| + eps) makes of the two gradients' difference d:
    its slope is at most eps / (m + eps)^2 between them (m the smaller
    |g|, 0 where the signs differ), so twice lr * eps * |d| / (m + eps)^2
    (twice: Adam's own rounding); large where |g| is below eps, as for a
    gradient zero in exact arithmetic."""
    import torch
    worst, name = 0.0, ""
    gd = gn = 0.0
    for k, w in want.items():
        if not k.startswith(("grad/", "param/", "stat/")) or not w.numel():
            continue
        w64, g64 = w.double(), got[k].double()
        bar = TP_GRAD_TOL * float(w64.abs().max()) + TP_GRAD_ATOL
        err = (g64 - w64).abs()
        if k.startswith("param/"):
            gk = "grad/" + k[len("param/"):]
            if gk in want:
                ga, gb = want[gk].double(), got[gk].double()
                m = torch.where(ga * gb > 0, torch.minimum(ga.abs(),
                                                           gb.abs()), 0.0)
                bar = bar + 2 * TP_LR * 1e-9 * (ga - gb).abs() / (
                    m + 1e-9) ** 2
        ratio = float((err / bar).max())
        if k.startswith("grad/"):
            gd += float(err.square().sum())
            gn += float(w64.square().sum())
        if ratio > worst:
            worst, name = ratio, k
    return worst, name, (gd / max(gn, 1e-300)) ** 0.5


def tp_rank_cases(rank: int, dev, out: Path) -> dict:
    """The TP steps of phase 16 on this rank (float64 and float32), B1 from
    the gathered float32 WaveRNN; rank 0 writes the steps' results to
    OUT/tp.pt. Returns {"losses", "b1": {...}, "launches"}."""
    import torch
    from etts_torch.models.wavernn import generate
    from etts_torch.parallel import make_mesh, tp
    mesh = make_mesh(("data", "model"), (1, 2))
    res, losses = {}, {}
    t0 = time.perf_counter()
    for kind in ("fwd", "ar", "voc"):
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            r, model = tp_case(kind, dtype, dev, mesh)
            losses[f"{kind}_{name}"] = r["loss"]
            res[f"{kind}_{name}"] = r
    seconds = time.perf_counter() - t0
    if rank == 0:
        torch.save(res, out / "tp.pt")
    # B1 from the gathered float32 vocoder (the last case's model)
    whole = tp_model("voc")
    whole.load_state_dict(tp.gathered_state_dict(model))
    whole.to(dev).eval()
    mel = dp_mels(dev)[0]
    wts = whole.sample_weights()
    torch.cuda.synchronize()
    zero_launches()
    wav = generate(whole, mel, target=TP_FOLD[0], overlap=TP_FOLD[1],
                   seed=TP_SEED, weights=wts)
    torch.cuda.synchronize()
    launches = read_launches()
    return {"losses": losses, "seconds": seconds, "launches": launches,
            "voc_state": ({k: v.cpu() for k, v in whole.state_dict().items()}
                          if rank == 0 else None),
            "b1": {"wav_len": wav.numel(),
                   "wav_finite": bool(torch.isfinite(wav).all())}}


def tp_b1_check(cl, voc_state, failures):
    """B1 on the gathered TP vocoder's weights (``voc_state``), one step at
    a time against exact sums (``one_step_check``, MOL): its untrained
    mixture makes a sample move by more than STEP_TOL with a bf16 rounding
    of an activation, so the kernel is held as phase 12 holds the trained
    export's, beside the plain version and the float32-activation
    control, on conditioning of the range a trained upsample network gives
    (features in [0, 1], aux of unit scale)."""
    import torch
    from etts_torch.ops.kernels import wavernn_cell as wcell
    dev = torch.device("cuda")
    model = tp_model("voc")
    model.load_state_dict(voc_state)
    wts = model.to(dev).sample_weights()
    g = torch.Generator(dev).manual_seed(TP_SEED)
    rows = 10
    cond = torch.cat([torch.rand(200, rows, wts.feat, device=dev,
                                 generator=g),
                      torch.randn(200, rows, 4 * wts.adim, device=dev,
                                  generator=g)], -1)
    one_step_check(cl, "bf16 (the gathered TP vocoder)", wts,
                   f32_activations(wts),
                   lambda c_: wcell._bf16_step(c_, wts, torch.float64),
                   None, cond, (rows,), STATE_TOL, SAMPLE_MARGIN_TRAINED,
                   failures, n_steps=200, mode=model.mode,
                   n_classes=model.n_classes)


def sp_config() -> Path:
    """Phase 9's config dir with ``sequence_parallel: 2``, written under
    build/ (phase 16's SP driver)."""
    import shutil
    import yaml
    src, dst = ROOT / "build" / "phase9_config", ROOT / "build" / "phase16_sp"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    cfg = yaml.safe_load((dst / "autoregressive_config.yaml").read_text())
    cfg["sequence_parallel"] = 2
    (dst / "autoregressive_config.yaml").write_text(yaml.safe_dump(cfg))
    return dst


def _start_ranks(n: int, port: int, out: Path):
    """Start ``dp_rank_main`` as ranks 0..n-1 (each with its output to
    ``out/{rank}.log`` and its share of the host's cores for its CPU
    threads); returns (processes, log files)."""
    import os
    files = [open(out / f"{r}.log", "w") for r in range(n)]
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, len(os.sched_getaffinity(0)) // n)))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), DP_RANK, str(r),
         str(port), str(out)], cwd=ROOT, stdout=f, env=env,
        stderr=subprocess.STDOUT) for r, f in enumerate(files)]
    return procs, files


def _wait_ranks(procs, files, deadline: float) -> list:
    """Wait for the ranks until ``deadline`` (``time.perf_counter``);
    returns their return codes (None for a rank stopped at it, every rank
    then stopped)."""
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return [p.returncode for p in procs]


def dp_phase(cl, voc, failures):
    """Phase 16: data parallelism on the card. Two gloo ranks sharing the
    card (``dp_rank_main``) vocode ``dp_mels`` through
    ``generate_batch_sharded`` (B1 once a rank; each rank's rows bit-equal
    to one launch in this process of those rows seeded ``fold_in(DP_SEED,
    rank)``, the waveforms bit-equal on both ranks and to those rows
    finalized) and run ``train_autoregressive --multihost`` for DP_STEPS
    steps. The comparison launches and the float64 control run here while
    the ranks start. Then the plain driver, and the driver as the one rank
    of an NCCL group, run here in turn; each first step's loss within
    DP_LOSS_TOL of the plain driver's, the float64 control beside; one
    checkpoint written a run. Returns {path: launches}: the two ranks'
    vocoding, rank 0's training."""
    import shutil
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from etts_torch.data.dataset import DataPrepper, Dataset, load_files
    from etts_torch.models.init import init_flax
    from etts_torch.models.wavernn import (_conditioning_streams, _finalize,
                                           _upsample_fold)
    from etts_torch.ops.kernels import wavernn_cell as wcell
    from etts_torch.parallel import init_multihost
    from etts_torch.text import default_tokenizer
    from etts_torch.train.steps import make_autoregressive_train_step
    from etts_torch.train_autoregressive import SEED, main as train_main
    from etts_torch.train_autoregressive import to_device
    from etts_torch.utils.config import (ConfigManager, build_tts,
                                         piecewise_linear_schedule,
                                         step_schedule)
    from etts_torch.utils.logging import read_scalars
    from etts_torch.utils.seeds import fold_in
    root = ROOT / "build" / "phase16"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cdir = ROOT / "build" / "phase9_config"
    for s in ("phase16_gloo2", "phase16_nccl1", "phase16_plain"):
        shutil.rmtree(ConfigManager(cdir, "autoregressive", s).base_dir,
                      ignore_errors=True)
    say(cl, "phase 16: data parallelism; two ranks share this one card "
            "(gloo: NCCL refuses two ranks on one GPU), so no speed-up is "
            "claimed or measurable here")
    t0 = time.perf_counter()
    shutil.rmtree(ConfigManager(sp_config(), "autoregressive",
                                "phase16_sp2").base_dir, ignore_errors=True)
    procs, files = _start_ranks(2, _free_port(), root)

    # while the ranks start: one launch of each rank's rows, seeded as the
    # rank seeds it, and the first step in float64 (the bar's control)
    dev = torch.device("cuda")
    mu_law = voc.config.get("mu_law", True) and voc.model.mode == "RAW"
    target = voc.config.get("voc_target", 11000)
    overlap = voc.config.get("voc_overlap", 550)
    with torch.no_grad():
        folds = [_upsample_fold(voc.model, m[None], True, target, overlap)
                 for m in dp_mels(dev)]
        counts = [u.shape[0] for u, _ in folds]
        cond = _conditioning_streams(torch.cat([u for u, _ in folds]),
                                     torch.cat([a for _, a in folds]))
        n_rows = cond.shape[1]
        per = -(-n_rows // 2)
        cond = F.pad(cond, (0, 0, 0, 2 * per - n_rows))
        single, single_ms = [], []
        for r in (0, 1):
            cond_r = cond[:, r * per:(r + 1) * per].contiguous()
            ms, (out, _) = cuda_ms(lambda: wcell.wavernn_sample_loop(
                cond_r, voc.weights, mode=voc.model.mode,
                n_classes=voc.model.n_classes, seed=fold_in(DP_SEED, r)),
                1, warm=False)
            single.append(out)
            single_ms.append(ms)
        full = torch.cat(single, 1)[:, :n_rows].T.split(counts)
        want = [_finalize(rw, True, overlap, mu_law, voc.model,
                          (n - 1) * voc.model.hop_length).cpu()
                for rw, n in zip(full, DP_MEL_FRAMES)]
    c = ConfigManager(cdir, "autoregressive", "phase16_plain").config
    tok = default_tokenizer(True)
    corpus = Path(c["train_data_directory"])
    samples, _ = load_files(corpus / "train_metafile.txt", corpus / "mels",
                            corpus / "spk_embeds")
    host = Dataset(samples, DataPrepper(c, tok), c["tts_batch_size"],
                   mel_channels=c["mel_channels"]).next_batch()
    model = build_tts(c, tok.vocab_size)
    init_flax(model, torch.Generator().manual_seed(SEED))
    model.double().to(dev)
    state = grad_capture(model, c["learning_rate_tts_schedule"])
    met, _ = make_autoregressive_train_step(
        model, stop_scaling=c.get("stop_loss_scaling", 1.0),
        use_style_loss=c.get("use_style_loss", False),
        mi_weight_factor=c.get("mine_weight_factor", 0.1))(
        state, tuple(x.double() if x.is_floating_point() else x
                     for x in to_device(host, dev)), 0.0, fold_in(SEED, 0),
        r=step_schedule(0, c["reduction_factor_schedule"]),
        prenet_dropout=piecewise_linear_schedule(
            0, c["decoder_prenet_dropout_schedule"]),
        drop_n_heads=step_schedule(0, c["head_drop_schedule"]))
    l64 = float(met["loss"])
    del model, state, met
    # the TP steps' references: each step in this process on the whole
    # model, float64 (the bar's) and float32 (printed)
    tp_ref = {f"{k}_{n}": tp_case(k, dt, dev)[0]
              for k in ("fwd", "ar", "voc")
              for n, dt in (("f64", torch.float64), ("f32", torch.float32))}
    t_parent = time.perf_counter() - t0
    rcs = _wait_ranks(procs, files, t0 + DP_TIMEOUT)
    t_gloo = time.perf_counter() - t0
    say(cl, f"two gloo ranks: {t_gloo:.1f} s from their start, this "
            f"process's comparison launches and float64 step {t_parent:.1f} "
            "s of it, beside them")
    if rcs != [0, 0]:
        for r in (0, 1):
            sys.stdout.write((root / f"{r}.log").read_text()[-4000:])
        failures.append(f"phase 16: the gloo ranks returned {rcs}")
        return {}
    res = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in (0, 1)]
    for r in (0, 1):
        same = torch.equal(res[r]["rows"][0], single[r].cpu())
        say(cl, f"generate_batch_sharded rank {r} (gloo, {res[r]['device']}"
                f"): {per} of {n_rows} fold rows x T={single[r].shape[0]}, "
                f"launches {res[r]['launches']}, {res[r]['seconds']:.3f} s "
                f"host time; its rows bit-equal to one launch in this "
                f"process seeded fold_in({DP_SEED}, {r}) "
                f"({single_ms[r]:.2f} ms): {same}")
        if not (same and len(res[r]["rows"]) == 1
                and res[r]["launches"]["wavernn_sample_loop"] == 1):
            failures.append(f"generate_batch_sharded rank {r}")
    finite = all(bool(torch.isfinite(w).all()) for w in want)
    same = all(torch.equal(a, b) and torch.equal(a, w) for a, b, w in zip(
        res[0]["wavs"], res[1]["wavs"], want))
    say(cl, f"generate_batch_sharded: {len(want)} waveforms "
            f"({', '.join(str(w.numel()) for w in want)} samples), bit-equal "
            f"on both ranks and to the single launches' rows finalized: "
            f"{same}; finite: {finite}")
    if not (same and finite):
        failures.append("generate_batch_sharded waveforms")

    # the plain driver, then the one rank of an NCCL group, in this process
    t_plain, _, _ = run_main(train_main, _dp_driver_argv("phase16_plain"))
    port = _free_port()
    init_multihost(f"127.0.0.1:{port}", 1, 0, "nccl")
    try:
        t_nccl, _, _ = run_main(train_main, _dp_driver_argv(
            "phase16_nccl1", "--multihost", "--coordinator_address",
            f"127.0.0.1:{port}", "--num_processes", "1", "--process_id",
            "0", "--dist_backend", "nccl"))
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)        # NCCL's communicator on this card
        nccl_ok = (dist.get_backend() == "nccl"
                   and bool((one == 1).all()))
    finally:
        dist.destroy_process_group()
    say(cl, f"NCCL group of one on {torch.cuda.get_device_name(0)}: an "
            f"all-reduce on the card {'right' if nccl_ok else 'WRONG'}")
    if not nccl_ok:
        failures.append("phase 16: the NCCL all-reduce")

    runs = {}
    for label, session, secs in (
            ("plain", "phase16_plain", t_plain),
            ("1 NCCL rank", "phase16_nccl1", t_nccl),
            ("2 gloo ranks sharing the card", "phase16_gloo2",
             res[0]["train_seconds"])):
        cm = ConfigManager(cdir, "autoregressive", session)
        sc = read_scalars(cm.log_dir)
        ckpts = sorted(p.name for p in cm.weights_dir.iterdir())
        runs[label] = (sc["train/loss"], statistics.median(
            sc["time/step_ms"][i] for i in range(1, DP_STEPS)), ckpts)
        say(cl, f"train_autoregressive, {label}: {secs:.1f} s; losses "
                f"{dict(sorted(sc['train/loss'].items()))}; median "
                f"{runs[label][1]:.2f} ms/step over steps 1-{DP_STEPS - 1} "
                f"(host clock, synchronised); checkpoints {ckpts}")
    base = runs["plain"][0][0]
    say(cl, f"first step's loss: plain float32 {base:.8f}, float64 control "
            f"{l64:.8f} (relative {abs(base - l64) / abs(l64):.2e}; the "
            f"bar {DP_LOSS_TOL}, one float32 ulp of the loss "
            f"{float(np.spacing(np.float32(base))) / abs(base):.2e})")
    for label, (losses, _, ckpts) in runs.items():
        d = abs(losses[0] - base) / abs(base)
        ok = (d <= DP_LOSS_TOL and ckpts == [f"ckpt-{DP_STEPS}.pt"]
              and all(math.isfinite(v) for v in losses.values()))
        say(cl, f"{label}: first step's loss {losses[0]:.8f}, relative "
                f"{d:.2e} from the plain driver's (tol {DP_LOSS_TOL}), "
                f"{abs(losses[0] - l64) / abs(l64):.2e} from float64")
        if not ok:
            failures.append(f"train_autoregressive, {label}")
    if abs(base - l64) / abs(l64) > DP_LOSS_TOL:
        failures.append("phase 16: the float32 step is past the bar from "
                        "float64")
    progress = [[ln for ln in res[r]["train_out"].splitlines()
                 if ln.startswith(("session ", "step ", "Done."))]
                for r in (0, 1)]
    if "Done." not in progress[0] or progress[1]:
        failures.append(f"phase 16: rank 0 alone prints ({progress[1]})")
    say(cl, f"step ms: 1 rank {runs['1 NCCL rank'][1]:.2f} (NCCL), 2 ranks "
            f"{runs['2 gloo ranks sharing the card'][1]:.2f} (gloo, one "
            f"card shared: each rank steps on half the batch, the two "
            f"queue on one card and all-reduce through the host), plain "
            f"{runs['plain'][1]:.2f}")
    tp_phase_checks(cl, res, tp_ref, root, runs["plain"][0][0], l64,
                    failures)
    return {"dp_vocode_rank0": res[0]["launches"],
            "dp_vocode_rank1": res[1]["launches"],
            "dp_train_rank0": res[0]["train_launches"],
            "tp_vocode_rank0": res[0]["tp"]["launches"],
            "tp_vocode_rank1": res[1]["tp"]["launches"],
            "sp_train_rank0": res[0]["sp_launches"]}


def tp_phase_checks(cl, res, tp_ref, root, plain_loss, l64, failures):
    """Phase 16's tensor- and sequence-parallel checks, on the ranks'
    results ``res`` and this process's references ``tp_ref``
    (``tp_case``'s)."""
    import math
    import torch
    from etts_torch.utils.config import ConfigManager
    from etts_torch.utils.logging import read_scalars
    got = torch.load(root / "tp.pt", weights_only=False)
    say(cl, f"tensor parallelism, (data 1, model 2) on 2 gloo ranks "
            f"sharing the card: the steps took {res[0]['tp']['seconds']:.1f}"
            f" s on rank 0 (float64 and float32, the shards gathered)")
    for kind, label in (("fwd", "forward"), ("ar", "AR"),
                        ("voc", "WaveRNN")):
        want = tp_ref[f"{kind}_f64"]
        worst, name, rel = tp_held(got[f"{kind}_f64"], want)
        _, _, rel32 = tp_held(got[f"{kind}_f32"], want)
        _, _, ctl32 = tp_held(tp_ref[f"{kind}_f32"], want)
        same = (res[0]["tp"]["losses"][f"{kind}_f64"]
                == res[1]["tp"]["losses"][f"{kind}_f64"])
        loss_rel = abs(got[f"{kind}_f64"]["loss"] - want["loss"]) / abs(
            want["loss"])
        ok = (worst <= 1.0 and same and loss_rel <= TP_GRAD_TOL
              and math.isfinite(want["loss"]))
        loss = got[f"{kind}_f64"]["loss"]
        say(cl, f"TP {label} step, float64: loss {loss:.10f} against one "
                f"process's {want['loss']:.10f} (relative "
                f"{loss_rel:.2e}); {len(want)} tensors, the worst at "
                f"{worst:.3f} of its bar ({name}); the gradients "
                f"{rel:.2e} from one process's (norm-relative); both "
                f"ranks' loss equal: {same}. float32 (printed): the "
                f"gradients {rel32:.2e} (TP) and {ctl32:.2e} (one process) "
                f"from the float64 step")
        if not ok:
            failures.append(f"phase 16: TP {label} step")
    for r in (0, 1):
        b1 = res[r]["tp"]["b1"]
        n = res[r]["tp"]["launches"]["wavernn_sample_loop"]
        say(cl, f"B1 from the gathered TP vocoder, rank {r}: generate "
                f"launched it {n} time(s), {b1['wav_len']} samples, finite "
                f"{b1['wav_finite']}")
        if not (n == 1 and b1["wav_finite"]):
            failures.append(f"phase 16: B1 from the TP vocoder, rank {r}")
    tp_b1_check(cl, res[0]["tp"]["voc_state"], failures)
    cm = ConfigManager(ROOT / "build" / "phase16_sp", "autoregressive",
                       "phase16_sp2")
    losses = read_scalars(cm.log_dir)["train/loss"]
    d = abs(losses[0] - plain_loss) / abs(plain_loss)
    printed = [[ln for ln in res[r]["sp_out"].splitlines()
                if ln.startswith(("session ", "step ", "Done."))]
               for r in (0, 1)]
    layout = any("sequence parallelism: data 1 x seq 2" in ln
                 for ln in printed[0])
    say(cl, f"train_autoregressive, sequence_parallel: 2 on 2 gloo ranks: "
            f"{res[0]['sp_seconds']:.1f} s; losses "
            f"{dict(sorted(losses.items()))}; first step's loss relative "
            f"{d:.2e} from the plain driver's (tol {DP_LOSS_TOL}), "
            f"{abs(losses[0] - l64) / abs(l64):.2e} from float64; the "
            f"layout printed: {layout}; rank 1 printed nothing: "
            f"{not printed[1]}")
    if not (d <= DP_LOSS_TOL and layout and not printed[1]
            and all(math.isfinite(v) for v in losses.values())):
        failures.append("phase 16: train_autoregressive, sequence_parallel")


def tp_rank_main(rank: int, world: int, port: int, out: Path) -> int:
    """``chip_smoke.py --tp-rank R N PORT OUT``: rank R of N NCCL ranks, a
    card each, the forward step of ``tp_case`` in float64 on a (data N /
    2, model 2) mesh; rank 0 writes it to OUT/tp_nccl.pt."""
    import torch
    from etts_torch.parallel import init_multihost, local_device, make_mesh
    init_multihost(f"127.0.0.1:{port}", world, rank, "nccl")
    dev = local_device("cuda")
    mesh = make_mesh(("data", "model"), (-1, 2), device_type="cuda")
    res, _ = tp_case("fwd", torch.float64, dev, mesh)
    if rank == 0:
        torch.save(res, out / "tp_nccl.pt")
    torch.distributed.destroy_process_group()
    return 0


def nccl_cards_main() -> int:
    """``chip_smoke.py --nccl-cards``, on a host of N >= 2 cards: the
    port's worker (``etts_torch.parallel._multihost_worker``) on one card
    and on N NCCL ranks, a card each (the ranks within 1e-6 of each other,
    within 2e-4 of one card: tests/test_multihost.py's bars), its
    checkpoint case on N ranks (one file, one log line, the resumed losses
    equal); then ``train_autoregressive`` under torchrun on N ranks
    against the plain driver on one card, phase 9's corpus and config,
    DP_STEPS steps: the first step's loss within DP_LOSS_TOL. Exits 1 on
    a failed check."""
    import os
    import shutil
    import torch
    from etts_torch.utils.config import ConfigManager
    from etts_torch.utils.logging import read_scalars
    n = torch.cuda.device_count()
    cl = card()
    say(cl, f"{n} cards: {', '.join(torch.cuda.get_device_name(i) for i in range(n))}")
    if n < 2:
        print("chip_smoke: --nccl-cards needs two cards or more",
              file=sys.stderr)
        return 2
    failures, root = [], ROOT / "build" / "nccl_cards"
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, len(os.sched_getaffinity(0)) // n)))

    def worker(nprocs, *extra):
        """The worker's commands for ``nprocs`` ranks on a free port."""
        port = str(_free_port())
        return [[sys.executable, "-m", "etts_torch.parallel._multihost_worker",
                 "--device", "cuda", "--port", port, "--process_id", str(r),
                 "--num_processes", str(nprocs), "--dist_backend", "nccl",
                 *extra] for r in range(nprocs)]

    def run(cmds):
        """Run the commands together, the r-th with LOCAL_RANK r, at most
        DP_TIMEOUT s; their outputs."""
        procs = [subprocess.Popen(
            c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(env, LOCAL_RANK=str(r)))
            for r, c in enumerate(cmds)]
        outs = []
        for p, c in zip(procs, cmds):
            try:
                outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(stopped at the limit)")
            if p.returncode != 0:
                failures.append(f"{' '.join(c[1:3])}: {outs[-1][-2000:]}")
        return outs

    def value(tag, out):
        m = re.search(rf"{tag} ([-\d.einf]+)", out)
        return float(m.group(1)) if m else float("nan")

    t0 = time.perf_counter()
    one = value("MULTIHOST_LOSS", run(worker(1))[0])
    losses = [value("MULTIHOST_LOSS", o) for o in run(worker(n))]
    apart = max(abs(x - losses[0]) for x in losses) / abs(losses[0])
    rel = abs(losses[0] - one) / abs(one)
    say(cl, f"worker (forward step, dropout on): one card {one:.8f}; {n} "
            f"NCCL ranks {losses}: {apart:.2e} apart (bar 1e-6), "
            f"{rel:.2e} from one card (bar 2e-4)")
    if not (apart <= 1e-6 and rel <= 2e-4):
        failures.append("worker losses")
    ckpt = root / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    outs = run(worker(n, "--ckpt_dir", str(ckpt)))
    resumed = [value("MULTIHOST_RESUME_LOSS", o) for o in outs]
    files = sorted(p.name for p in ckpt.iterdir() if p.is_file())
    lines = len((ckpt / "logs/scalars.jsonl").read_text().splitlines())
    say(cl, f"worker, checkpoint case: resumed losses {resumed}, files "
            f"{files}, log lines {lines}; {time.perf_counter() - t0:.1f} s")
    if not (len(set(resumed)) == 1 and files == ["ckpt-1.pt"]
            and lines == 1):
        failures.append("worker checkpoint case")

    t0 = time.perf_counter()
    _, cdir = phase9_config()
    base = ["-m", "etts_torch.train_autoregressive", "--config", str(cdir),
            "--max_steps", str(DP_STEPS)]
    run([[sys.executable, *base, "--session_name", "cards_plain"]])
    out = run([[sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", str(n), "--master_port",
                str(_free_port()), *base, "--session_name", "cards_nccl",
                "--multihost"]])[0]
    sc = {s: read_scalars(ConfigManager(cdir, "autoregressive", s).log_dir)
          for s in ("cards_plain", "cards_nccl")}
    first = {s: v["train/loss"][0] for s, v in sc.items()}
    rel = abs(first["cards_nccl"] - first["cards_plain"]) / abs(
        first["cards_plain"])
    ms = {s: [round(v["time/step_ms"][i], 2) for i in range(DP_STEPS)]
          for s, v in sc.items()}
    say(cl, f"train_autoregressive under torchrun, {n} NCCL ranks (a card "
            f"each, the batch of 8 split {n} ways): first step's loss {first['cards_nccl']:.8f} against "
            f"the plain driver's {first['cards_plain']:.8f} on one card, "
            f"relative {rel:.2e} (tol {DP_LOSS_TOL}); ms a step (host "
            f"clock, steps 0-{DP_STEPS - 1}, the first a warm-up) {ms}; "
            f"progress printed by rank 0 alone: "
            f"{out.count('step 0: loss') == 1}; "
            f"{time.perf_counter() - t0:.1f} s")
    if not (rel <= DP_LOSS_TOL and out.count("step 0: loss") == 1):
        failures.append("train_autoregressive under torchrun")

    # tensor parallelism: the forward step on a (data n / 2, model 2) mesh
    # of NCCL ranks against the whole model on one card, float64
    t0 = time.perf_counter()
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), TP_RANK, str(r),
         str(n), port, str(root)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, LOCAL_RANK=str(r))) for r in range(n)]
    want, _ = tp_case("fwd", torch.float64, torch.device("cuda", 0))
    ranks_ok = True
    for r, p in enumerate(procs):
        try:
            text = p.communicate(timeout=DP_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + "\n(stopped at the limit)"
        if p.returncode != 0:
            ranks_ok = False
            failures.append(f"TP rank {r}: {text[-2000:]}")
    if ranks_ok:
        got = torch.load(root / "tp_nccl.pt", weights_only=False)
        worst, name, relw = tp_held(got, want)
        say(cl, f"TP forward step, (data {n // 2}, model 2) on {n} NCCL "
                f"ranks, float64: loss {got['loss']:.10f} against one "
                f"card's {want['loss']:.10f}; the worst tensor at "
                f"{worst:.3f} of its bar ({name}); the gradients "
                f"{relw:.2e} from one card's (norm-relative); "
                f"{time.perf_counter() - t0:.1f} s")
        if worst > 1.0:
            failures.append("TP forward step on NCCL ranks")
    (root / "tp_nccl.pt").unlink(missing_ok=True)

    # sequence parallelism: the driver with sequence_parallel: 2 under
    # torchrun on n ranks (data n / 2 x seq 2)
    t0 = time.perf_counter()
    sp_dir = sp_config()
    out = run([[sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", str(n), "--master_port",
                str(_free_port()), "-m", "etts_torch.train_autoregressive",
                "--config", str(sp_dir), "--max_steps", str(DP_STEPS),
                "--session_name", "cards_sp", "--multihost"]])[0]
    sp = read_scalars(ConfigManager(sp_dir, "autoregressive",
                                    "cards_sp").log_dir)["train/loss"]
    rel = abs(sp[0] - first["cards_plain"]) / abs(first["cards_plain"])
    layout = f"sequence parallelism: data {n // 2} x seq 2" in out
    say(cl, f"train_autoregressive, sequence_parallel: 2 under torchrun on "
            f"{n} NCCL ranks: losses {dict(sorted(sp.items()))}; first "
            f"step's loss relative {rel:.2e} from the plain driver's (tol "
            f"{DP_LOSS_TOL}); the layout printed: {layout}; "
            f"{time.perf_counter() - t0:.1f} s")
    if not (rel <= DP_LOSS_TOL and layout):
        failures.append("train_autoregressive, sequence_parallel, NCCL")
    if failures:
        print(f"failed: {failures}", file=sys.stderr)
        return 1
    print(cl, flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "etts_torch").is_dir() or not TTS_W.exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from etts_torch.utils.precision import pin_float32
    pin_float32()
    if sys.argv[1:2] == [SIDE]:
        return side_main(Path(sys.argv[2]))
    if sys.argv[1:2] == [DP_RANK]:
        return dp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                            Path(sys.argv[4]))
    if sys.argv[1:2] == [NCCL_CARDS]:
        return nccl_cards_main()
    if sys.argv[1:2] == [TP_RANK]:
        return tp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), Path(sys.argv[5]))

    # ---- 1. card, build ----
    cl = card()
    print(cl, flush=True)
    from etts_torch.ops.kernels import _build
    t0 = time.perf_counter()
    from etts_torch.ops.kernels import decoder_step as dstep
    # the decode is built with the faster of the two cluster sizes that an
    # H100 takes (8, the portable most, and 16); the other is timed beside
    sizes = {n: (f"{dstep.CLUSTER}={n}",) for n in (8, 16)}
    _build.build("decoder_step", ("decoder_step", (dstep.TIMER,)),
                 *[("decoder_step", x) for x in sizes.values()],
                 "wavernn_cell")
    say(cl, f"built the kernels in {time.perf_counter() - t0:.1f} s")
    n_cluster = dstep.cluster_size()
    n_alt = 8 if n_cluster == 16 else 16
    say(cl, f"fused_decode: decode_cluster runs one cluster of {n_cluster} "
            f"blocks (timed beside it: {n_alt})")
    for name in ("decoder_step", "wavernn_cell"):
        kernel = name
        for line in _build.build_log(name).splitlines():
            entry = re.search(
                r"(?:Compiling entry function|Function properties for) "
                r"'?\w*?\d+(decode_\w+?|wavernn_\w+?|quant_div_check_kernel|"
                r"block_mv|attend_part|attend_combine|ln_chain)"
                r"(?:IL[ib](\d+)E)?E", line)
            # wavernn_qtile<0>: int8; wavernn_qtile<1>: int8_mxu
            if entry:
                kernel = entry[1] + (f"<{entry[2]}>" if entry[2] else "")
            if "registers" in line or "spill" in line:
                say(cl, f"{name}, {kernel}: {line.strip()}")

    from etts_torch.api import TTSSynthesizer, VocoderSynthesizer
    from etts_torch.models.wavernn import (_clamp_mels, _conditioning_streams,
                                           fold_with_overlap)
    from etts_torch.ops.kernels import wavernn_cell as wcell
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tts = TTSSynthesizer(CONFIG, TTS_W, "cuda", step=14000,
                         phonemizer_backend="grapheme")
    voc = VocoderSynthesizer(CONFIG, VOC_W, "cuda")
    if tts.r != 10 or tts.prenet_dropout != 0.0:
        raise RuntimeError(f"schedules at 14k: r={tts.r}, "
                           f"dropout={tts.prenet_dropout}")
    wav_ref = ref_wav()
    ref_mel = tts.mel_from_wav(wav_ref)
    rng = np.random.default_rng(0)
    spk = rng.standard_normal(256).astype(np.float32)
    spk /= np.linalg.norm(spk)
    max_length = 1000
    max_steps = max_length // tts.r + 1

    # ---- 2. fused decode kernel vs plain ----
    t_phase = time.perf_counter()
    m = tts.model
    with torch.no_grad():
        ids = torch.from_numpy(tts.encode_text(SENTENCE))[None].to(dev)
        ref = m.encode_ref(torch.from_numpy(ref_mel).to(dev), tts.r)
        enc = m.encode(ids, ref, torch.from_numpy(spk).to(dev)[None, None])[0]
    w = dstep.decode_weights(m, enc, tts.r, torch.bfloat16)
    P, d = w.pw1.shape[0], w.d
    gen = torch.Generator(dev).manual_seed(1)
    noise = torch.rand(max_steps, P + d, device=dev, generator=gen)
    cap = 377                   # a frame cap that lands inside a group
    stop_w, stop_at = interior_stop_weights(w, max_steps)
    failures = []       # comparisons that failed; reported at the end
    dec_err = 0.0
    # (label, weights, options, the length the case must stop at or None)
    cases = (
        ("dropout 0", w, dict(prenet_dropout=0.0), None),
        ("dropout 0.5, shared uniforms", w,
         dict(prenet_dropout=0.5, noise=noise), None),
        (f"frame cap at {cap} frames", w,
         dict(prenet_dropout=0.0,
              max_frames_per_token=(cap + 0.5) / w.ck.shape[1]), cap),
        ("attention-completion stop, patience 3", attention_at_end(w),
         dict(prenet_dropout=0.0, attn_stop_patience=3, stop_enabled=False),
         3 * tts.r),
        (f"stop class first firing at frame {stop_at - 1}", stop_w,
         dict(prenet_dropout=0.0), stop_at))
    # r = 1: the FinalProj's first 80 rows of the same export, stop off so
    # that all 300 steps run and the self-attention cache outgrows n_enc
    w1 = dstep.decode_weights(m, enc, 1, torch.bfloat16)
    steps1 = 300
    noise1 = torch.rand(steps1, P + d, device=dev, generator=gen)
    cases += (
        (f"r = 1, {steps1} steps, dropout 0.5, shared uniforms", w1,
         dict(prenet_dropout=0.5, noise=noise1, stop_enabled=False,
              max_steps=steps1), steps1),)
    # each case on the main build and on the other cluster size, whose
    # times phase 5 sets beside the main build's
    builds = ((f"{n_cluster} blocks", dstep.fused_decode),
              (f"{n_alt} blocks",
               lambda cw, **kw: dstep.launch_cluster(cw, n_alt, **kw)))
    for (label, cw, kw, want), (blocks, run) in itertools.product(cases,
                                                                  builds):
        kw = dict(dict(max_steps=max_steps), **kw)
        k_mel, k_len, k_steps = run(cw, **kw)
        # the same history: the plain version is fed the kernel's frames,
        # so float32 rounding cannot grow through the feedback loop
        p_mel, p_len, p_steps = dstep.fused_decode_plain(cw, teacher=k_mel,
                                                         **kw)
        f_mel, f_len, _ = dstep.fused_decode_plain(cw, **kw)
        torch.cuda.synchronize()
        n = max(k_len, p_len)
        err = float((k_mel[:n] - p_mel[:n]).abs().max())
        nf = max(k_len, f_len)
        free = float((k_mel[:nf] - f_mel[:nf]).abs().max())
        ok = (k_len == p_len and k_steps == p_steps and err <= DECODE_TOL
              and bool(torch.isfinite(k_mel).all()))
        full = kw["max_steps"] * cw.r
        if want == full:            # must run every step
            ok = ok and k_len == want
        elif want is not None:      # a guard case must stop, and there
            ok = ok and k_len == want < full
        say(cl, f"fused_decode vs plain ({label}; {blocks}): length {k_len} "
                f"vs {p_len}" + (f" (want {want}" + (f" < {full})"
                                                     if want < full else ")")
                                 if want else "")
                + f", steps {k_steps} vs {p_steps}, max |dmel| "
                f"{err:.3e} (tol {DECODE_TOL}); free-running: length "
                f"{f_len}, max |dmel| {free:.3e}")
        if not ok:
            failures.append(f"fused_decode vs plain ({label}; {blocks})")
        if run is dstep.fused_decode:
            dec_err = max(dec_err, err)

    say(cl, f"phase 2 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 3. sample-loop kernel vs plain ----
    # conditioning: the 26k vocoder's upsample network on the reference
    # wav's mel, folded into rows of 2000 + 2 * 100 samples
    with torch.no_grad():
        vm = _clamp_mels((torch.from_numpy(ref_mel).to(dev) + 4.0) / 8.0)
        while vm.shape[0] < 360:          # enough frames for 33 folds
            vm = torch.cat([vm, vm], 0)
        vm = F.pad(vm[None], (0, 0, voc.model.pad, voc.model.pad))
        up, aux = voc.model.upsample(vm)
        cond_all = _conditioning_streams(fold_with_overlap(up, 2000, 100),
                                         fold_with_overlap(aux, 2000, 100))
    T = cond_all.shape[0]
    ww = voc.weights
    voc_err = 0.0
    rand_mol, rand_mol8 = random_sample_weights(ww, 30, dev)
    rand_raw, rand_raw8 = random_sample_weights(ww, 512, dev)
    # the export's aux features run far out of range without its BatchNorm
    # statistics (|cond| up to a few hundred), where one bf16 step of an
    # activation is large; the seeded weights are held to the bf16 bar on
    # conditioning in the range a trained upsample network gives (mels in
    # [0, 1], aux features of unit scale), and on the export's once more
    # (the last set is printed, not held to the bar)
    g = torch.Generator(dev).manual_seed(4)
    cond_seeded = torch.cat(
        [torch.rand(T, 33, ww.feat, device=dev, generator=g),
         torch.randn(T, 33, 4 * ww.adim, device=dev, generator=g)], -1)
    all_b = (1, 5, 11, 16, 17, 33)
    weight_sets = [
        ("26k export, MOL", ww, "MOL", 30, cond_all, all_b, True),
        ("seeded random weights, MOL", rand_mol, "MOL", 30, cond_seeded,
         all_b, True),
        ("seeded random weights, RAW 512 classes", rand_raw, "RAW", 512,
         cond_seeded, all_b, True),
        ("seeded random weights, MOL, the export's conditioning", rand_mol,
         "MOL", 30, cond_all, (5,), False)]

    def tiles(B):
        nr = wcell.TILE_ROWS
        return f"{nr} rows per block, {-(-B // nr)} blocks"

    for label, wts, mode, n_cls, c_all, rows, gate in weight_sets:
        for B in rows:
            cond = c_all[:, :B].contiguous()
            nd = wcell.n_draw(mode, n_cls, wts.n_out)
            g = torch.Generator(dev).manual_seed(B)
            u = torch.rand(T, B, nd, device=dev, generator=g)
            kw = dict(mode=mode, n_classes=n_cls, noise=u)
            k_out, _ = wcell.wavernn_sample_loop(cond, wts, **kw)
            # the same history: the plain version is fed the kernel's
            # samples, so a rare Gumbel-argmax tie broken the other way by
            # float32 rounding stays one differing step
            t_out, _ = wcell.wavernn_sample_loop_plain(cond, wts,
                                                       teacher=k_out, **kw)
            free = "not run"        # free-running: at the first B's only
            if B <= 11:
                f_out, _ = wcell.wavernn_sample_loop_plain(cond, wts, **kw)
                free = f"{float((k_out - f_out).abs().max()):.3e}"
            torch.cuda.synchronize()
            diff = (k_out - t_out).abs()
            agree = float((diff <= STEP_TOL).float().mean())
            err = float(diff.max())
            if gate and mode == "MOL":      # a turned RAW pick is k * 2 / 511
                voc_err = max(voc_err, err)
            inside = float((k_out.abs() < 1).float().mean())
            say(cl, f"wavernn_sample_loop vs plain ({label}), B={B} T={T} "
                    f"({tiles(B)}): per-step (same history) max |d| "
                    f"{err:.3e}, {agree:.6f} of steps within {STEP_TOL} "
                    f"(bar {STEP_AGREE_BF16 if gate else 'none'}); "
                    f"free-running max |d| "
                    f"{free}; samples mean {float(k_out.mean()):.4f}, "
                    f"std {float(k_out.std()):.4f}, {inside:.4f} inside "
                    f"(-1, 1)")
            if gate and (agree < STEP_AGREE_BF16
                         or not bool(torch.isfinite(k_out).all())):
                failures.append(f"wavernn_sample_loop vs plain ({label}, "
                                f"B={B})")
    # one step at a time from the same state, against exact sums, with the
    # float32-activation computation (the bf16 rounding left out) as the
    # control (one_step_check)
    peaky = dataclasses.replace(rand_raw, wf3=rand_raw.wf3 * PEAKY,
                                bf3=torch.zeros_like(rand_raw.bf3))
    one_step_check(cl, "bf16", peaky, f32_activations(peaky),
                   lambda c: wcell._bf16_step(c, peaky, torch.float64),
                   None, cond_seeded, all_b, STATE_TOL, PEAKY_MARGIN,
                   failures)
    cond = cond_all[:, :5].contiguous()
    one, st1 = wcell.wavernn_sample_loop(cond, rand_mol, seed=7)
    a, st = wcell.wavernn_sample_loop(cond[:1000], rand_mol, seed=7)
    b, st2 = wcell.wavernn_sample_loop(cond[1000:], rand_mol, seed=7,
                                       state=st)
    chunk_err = float((torch.cat([a, b]) - one).abs().max())
    state_err = float((st1["h1"] - st2["h1"]).abs().max())
    say(cl, f"wavernn_sample_loop chunked (1000 + {T - 1000}) vs one-shot "
            f"(seeded MOL, Philox, B=5): max |d| {chunk_err:.3e}, final h1 "
            f"max |d| {state_err:.3e} (tol 0)")
    if chunk_err != 0.0 or state_err != 0.0:
        failures.append("wavernn_sample_loop chunked state carry")

    say(cl, f"phase 3 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 3b. int8 sample-loop kernels vs plain ----
    # the plain version of each mode repeats the TPU kernel's rounding (bf16
    # conditioning; bf16 activations, or activations quantized per row with
    # an exact integer product), fed the kernel's samples. int8_mxu's sums
    # are exact in any order, so it is held to STEP_AGREE on the export's
    # conditioning; int8 sums bf16 products in the mma's order, as the bf16
    # kernel does, and is held as phase 3 holds that one: STEP_AGREE_BF16 on
    # conditioning of unit scale, and one step against exact sums.
    n_div = 1 << 32
    t0 = time.perf_counter()
    bad, seen = wcell.quant_div_mismatches(n_div, dev)
    say(cl, f"int8_mxu quantizer's division against IEEE division: {bad} "
            f"of {seen} seeded pairs differ (tol 0; "
            f"{time.perf_counter() - t0:.2f} s)")
    if bad or seen != n_div:
        failures.append("the int8_mxu quantizer's division")
    q_err = {"int8": 0.0, "int8_mxu": 0.0}
    q_sets = {"int8": (cond_seeded, STEP_AGREE_BF16, "unit-scale"),
              "int8_mxu": (cond_all, STEP_AGREE, "the export's")}
    for label, wb, w8, mode, n_cls in (
            ("MOL", rand_mol, rand_mol8, "MOL", 30),
            ("RAW 512 classes", rand_raw, rand_raw8, "RAW", 512)):
        for B in (1, 5, 11, 17):
            nd = wcell.n_draw(mode, n_cls, wb.n_out)
            g = torch.Generator(dev).manual_seed(100 + B)
            u = torch.rand(T, B, nd, device=dev, generator=g)
            kw = dict(mode=mode, n_classes=n_cls, noise=u)
            for wdt, (c_all, bar, c_name) in q_sets.items():
                cond = c_all[:, :B].contiguous()
                b_out, _ = wcell.wavernn_sample_loop(cond, wb, **kw)
                k_out, _ = wcell.wavernn_sample_loop(cond, w8,
                                                     weight_dtype=wdt, **kw)
                t_out, _ = wcell.wavernn_sample_loop_plain(
                    cond, w8, teacher=k_out, weight_dtype=wdt, **kw)
                torch.cuda.synchronize()
                diff = (k_out - t_out).abs()
                agree = float((diff <= STEP_TOL).float().mean())
                if mode == "MOL":       # a turned RAW pick is k * 2 / 511
                    q_err[wdt] = max(q_err[wdt], float(diff.max()))
                mean_d = float((k_out - b_out).abs().mean())
                inside = float((k_out.abs() < 1).float().mean())
                say(cl, f"wavernn_sample_loop {wdt} vs plain (seeded random "
                        f"weights, {label}, {c_name} conditioning), "
                        f"B={B} T={T} ({tiles(B)}): "
                        f"per-step (same history) max |d| "
                        f"{float(diff.max()):.3e}, {agree:.6f} of steps "
                        f"within {STEP_TOL} (bar {bar}); mean |{wdt} - bf16 "
                        f"kernel| {mean_d:.4f} (same uniforms; etts' gate on "
                        f"its tiny RAW test is < 0.1); {inside:.4f} inside "
                        f"(-1, 1)")
                if agree < bar or not bool(torch.isfinite(k_out).all()):
                    failures.append(f"wavernn_sample_loop {wdt} vs plain "
                                    f"({label}, B={B})")
    # int8, one step from the same state against exact sums; the control is
    # the dequantized weights' function with float32 activations
    peaky8 = dataclasses.replace(rand_raw8, s_wf3=rand_raw8.s_wf3 * PEAKY,
                                 bf3=torch.zeros_like(rand_raw8.bf3))
    one_step_check(cl, "int8", peaky8, dequantized(peaky8),
                   lambda c: wcell._int8_step(c, peaky8, False, torch.float64),
                   "int8", cond_seeded, all_b, STATE_TOL_INT8,
                   PEAKY_MARGIN_INT8, failures)
    cond = cond_all[:, :5].contiguous()
    for wdt in q_err:
        kw = dict(seed=7, weight_dtype=wdt)
        one, st1 = wcell.wavernn_sample_loop(cond, rand_mol8, **kw)
        a, st = wcell.wavernn_sample_loop(cond[:1000], rand_mol8, **kw)
        b, st2 = wcell.wavernn_sample_loop(cond[1000:], rand_mol8, state=st,
                                           **kw)
        chunk_err = float((torch.cat([a, b]) - one).abs().max())
        state_err = float((st1["h2"] - st2["h2"]).abs().max())
        say(cl, f"wavernn_sample_loop {wdt} chunked (1000 + {T - 1000}) vs "
                f"one-shot (seeded MOL): max |d| {chunk_err:.3e}, final h2 "
                f"max |d| {state_err:.3e} (tol 0)")
        if chunk_err != 0.0 or state_err != 0.0:
            failures.append(f"wavernn_sample_loop {wdt} chunked state carry")

    say(cl, f"phase 3b took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 4. the main path ----
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tts.predict(SENTENCE, ref_mel, spk, max_length=max_length, seed=0)
    mel = out["mel"]
    wav = voc.generate((mel + 4.0) / 8.0, seed=0)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    # each run's launches, read just after it: {path: read_launches()}
    paths = {"main": read_launches()}
    launches = paths["main"]
    audio_s = wav.shape[0] / tts.config["sampling_rate"]
    say(cl, f"main path: {len(tts.encode_text(SENTENCE))} tokens -> "
            f"{mel.shape[0]} frames in {out['steps']} steps -> "
            f"{wav.shape[0]} samples; launches {launches}")
    if launches != {k: int(k in ("fused_decode", "wavernn_sample_loop"))
                    for k in launches}:
        raise RuntimeError(f"main path launches {launches}")
    if wav.shape[0] != (mel.shape[0] - 1) * tts.config["hop_length"]:
        raise RuntimeError("wav length is not (t_mel - 1) * hop")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise RuntimeError("wav not finite or outside [-1, 1]")
    if not np.isfinite(mel).all():
        raise RuntimeError("mel not finite")

    say(cl, f"phase 4 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 5. times and bounds at the main path's shapes ----
    # phase 2's decode weights are the main path's: same text, reference
    # and speaker
    steps = out["steps"]
    kw = dict(max_steps=max_steps, prenet_dropout=tts.prenet_dropout)
    dec_ms, _ = cuda_ms(lambda: dstep.fused_decode(w, **kw), 5)
    dec_plain_ms, _ = cuda_ms(lambda: dstep.fused_decode_plain(w, **kw), 1)
    dec_bound, dec_by = decode_bound(w, steps)
    # r = 1 at the main path's max_length: 1001 steps (stop off, so all
    # run), the late schedule's longest decode
    kw1 = dict(max_steps=max_length + 1, prenet_dropout=tts.prenet_dropout,
               stop_enabled=False)
    dec1_ms, (_, _, n1) = cuda_ms(lambda: dstep.fused_decode(w1, **kw1), 2)
    dec1_bound, dec1_by = decode_bound(w1, n1)
    # the other cluster size, on the same inputs
    alt_ms, (a_mel, _, _) = cuda_ms(
        lambda: dstep.launch_cluster(w, n_alt, **kw), 5)
    alt1_ms, _ = cuda_ms(lambda: dstep.launch_cluster(w1, n_alt, **kw1), 2)
    m_ref, *_ = dstep.fused_decode(w, **kw)
    alt_err = float((a_mel - m_ref).abs().max())
    if alt_err > DECODE_TOL:
        failures.append(f"fused_decode at {n_alt} blocks vs {n_cluster}")
    say(cl, f"fused_decode cluster sizes: {n_cluster} blocks "
            f"{dec_ms / steps:.4f} ms/step at r = 10, {dec1_ms / n1:.4f} at "
            f"r = 1; {n_alt} blocks {alt_ms / steps:.4f} and "
            f"{alt1_ms / n1:.4f}; max |dmel| between them at r = 10 "
            f"{alt_err:.3e}")
    # the timer build's split of a step, at r = 10 and r = 1; its cycles
    # over its own CUDA-event time give the clock that turns them into us
    for label, cw, ckw, untimed in (("r = 10", w, kw, dec_ms / steps),
                                    ("r = 1", w1, kw1, dec1_ms / n1)):
        t_ms, (split, total, n) = cuda_ms(
            lambda: dstep.phase_split(cw, **ckw), 1)
        mhz = total / (t_ms * 1e3)
        say(cl, f"fused_decode timer build, {label}: {n} steps, "
                f"{t_ms / n:.4f} ms/step (untimed build {untimed:.4f}), "
                f"{total / n:.0f} cycles/step at {mhz:.0f} cycles/us")
        for ph, c in split.items():
            say(cl, f"  {ph:30s} {c / n:10.0f} cycles/step "
                    f"{c / n / mhz:9.3f} us/step {c / total:7.2%}")

    # the sample loop at the main path's conditioning (folded as
    # VocoderSynthesizer.generate folds it), on the seeded sample-path
    # weights (the 26k export's samples all clip at +1) and one shared noise
    # tensor: the kernel timed, the plain version timed on the same inputs
    # and fed the kernel's samples, and each step compared. The control, the
    # float32-activation computation in the plain version's place, must
    # fall below the bar that the kernel clears.
    target = voc.config.get("voc_target", 11000)
    overlap = voc.config.get("voc_overlap", 550)
    with torch.no_grad():
        vm = _clamp_mels(torch.from_numpy((mel + 4.0) / 8.0).to(dev))
        vm = F.pad(vm[None], (0, 0, voc.model.pad, voc.model.pad))
        up, aux = voc.model.upsample(vm)
        cond = _conditioning_streams(fold_with_overlap(up, target, overlap),
                                     fold_with_overlap(aux, target, overlap))
    T, B, _ = cond.shape
    mode, n_cls = voc.model.mode, voc.model.n_classes
    nd = wcell.n_draw(mode, n_cls, ww.n_out)
    u = torch.rand(T, B, nd, device=dev,
                   generator=torch.Generator(dev).manual_seed(2))
    kw = dict(mode=mode, n_classes=n_cls, noise=u)
    wcell.wavernn_sample_loop(cond, rand_mol, **kw)          # warm-up
    voc_ms, (k_out, _) = cuda_ms(
        lambda: wcell.wavernn_sample_loop(cond, rand_mol, **kw), 3,
        warm=False)
    voc_plain_ms, (t_out, _) = cuda_ms(
        lambda: wcell.wavernn_sample_loop_plain(cond, rand_mol, teacher=k_out,
                                                **kw), 1, warm=False)
    diff = (k_out - t_out).abs()
    agree = float((diff <= STEP_TOL).float().mean())
    # not in voc_err: on the export's conditioning one bf16 step of an
    # activation is large, and a mixture pick turned at the clip is 2.0
    c_out, _ = wcell.wavernn_sample_loop_plain(cond, f32_activations(rand_mol),
                                               teacher=k_out, **kw)
    control = float(((k_out - c_out).abs() <= STEP_TOL).float().mean())
    say(cl, f"wavernn_sample_loop vs plain (seeded random weights, {mode}, "
            f"main path's shapes), B={B} T={T} ({tiles(B)}): per-step (same "
            f"history) max |d| {float(diff.max()):.3e}, {agree:.6f} of steps "
            f"within {STEP_TOL} (bar {STEP_AGREE_BF16}; control, float32 "
            f"activations: {control:.6f}); "
            f"{float((k_out.abs() < 1).float().mean()):.4f} of samples inside "
            f"(-1, 1)")
    if agree < STEP_AGREE_BF16 or not bool(torch.isfinite(k_out).all()):
        failures.append("wavernn_sample_loop vs plain (main path's shapes)")
    if control >= STEP_AGREE_BF16:
        failures.append("the float32-activation control clears the bf16 bar")
    # the logical weights counted once (not the kernel's packed copy)
    voc_bound, voc_by = loop_bound(rand_mol, None, cond, u)

    say(cl, f"fused_decode: {dec_ms:.3f} ms per decode of {steps} steps "
            f"({dec_ms / steps:.4f} ms/step), plain {dec_plain_ms:.1f} ms, "
            f"bound {dec_bound:.4f} ms by {dec_by}, launches "
            f"{launches['fused_decode']}")
    say(cl, f"fused_decode at r = 1: {dec1_ms:.3f} ms per decode of "
            f"{n1} steps ({dec1_ms / n1:.4f} ms/step), bound "
            f"{dec1_bound:.4f} ms by {dec1_by}")
    say(cl, f"wavernn_sample_loop: {voc_ms:.2f} ms for T={T} x B={B} "
            f"({voc_ms / T * 1e3:.2f} us/step), plain {voc_plain_ms:.1f} ms, "
            f"bound {voc_bound:.4f} ms by {voc_by}, launches "
            f"{launches['wavernn_sample_loop']}")
    say(cl, f"end to end: {e2e:.3f} s for {audio_s:.3f} s of audio, "
            f"RTF {e2e / audio_s:.4f}")
    # the reference mel (float64 STFT on the card), host time with the copy
    # back to the host that ends it
    tts.mel_from_wav(wav_ref)
    t0 = time.perf_counter()
    for _ in range(10):
        tts.mel_from_wav(wav_ref)
    ref_s = wav_ref.shape[0] / tts.config["sampling_rate"]
    say(cl, f"reference mel of {ref_s:.1f} s of audio (float64 STFT): "
            f"{(time.perf_counter() - t0) / 10 * 1e3:.3f} ms")

    say(cl, f"phase 5 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 6. the serving path ----
    sr, hop = tts.config["sampling_rate"], tts.config["hop_length"]
    zero_launches()
    batch_ms, mels = cuda_ms(lambda: tts.predict_many(
        SERVING_TEXTS, ref_mel, spk, max_length=max_length, seed=0), 1,
        warm=False)
    dec_s = batch_ms / 1e3
    paths["serving_decode"] = read_launches()
    if any(paths["serving_decode"].values()):
        raise RuntimeError("a batch of texts went through a kernel: "
                           f"{paths['serving_decode']}")
    want_rows = sum(n_folds(m.shape[0] * hop, target, overlap) for m in mels)
    say(cl, f"serving: {len(SERVING_TEXTS)} texts of "
            f"{[len(tts.encode_text(x)) for x in SERVING_TEXTS]} tokens -> "
            f"{[m.shape[0] for m in mels]} frames in one decode, "
            f"{dec_s:.3f} s; {want_rows} fold rows")
    voc_mels = [(m + 4.0) / 8.0 for m in mels]
    serve_s = {}
    for flag, wdt in ((False, "bf16"), (True, "int8"), ("mxu", "int8_mxu")):
        counter = ("wavernn_sample_loop" if wdt == "bf16"
                   else f"wavernn_sample_loop_{wdt}")
        zero_launches()
        ms, wavs = cuda_ms(lambda: voc.generate_many(
            voc_mels, seed=0, int8_weights=flag), 1, warm=False)
        serve_s[flag] = ms / 1e3
        ran = paths[f"serving_{wdt}"] = read_launches()
        if ran != {k: int(k == counter) for k in ran}:
            raise RuntimeError(f"generate_many(int8_weights={flag!r}) "
                               f"launched {ran}")
        for wv, m in zip(wavs, mels):
            if wv.shape[0] != (m.shape[0] - 1) * hop:
                raise RuntimeError("a serving wav is not (t - 1) * hop long")
            if not (np.isfinite(wv).all() and np.abs(wv).max() <= 1.0):
                raise RuntimeError("a serving wav is not finite or outside "
                                   "[-1, 1]")
        serve_audio = sum(wv.shape[0] for wv in wavs) / sr
        say(cl, f"serving, int8_weights={flag!r}: generate_many "
                f"{serve_s[flag]:.3f} s for {serve_audio:.3f} s of audio in "
                f"{len(wavs)} wavs; batch RTF (decode + vocoder device "
                f"seconds per second of delivered audio) "
                f"{(dec_s + serve_s[flag]) / serve_audio:.4f}; launches "
                f"{ran}")

    # each sample-loop kernel alone at the serving shapes on the seeded MOL
    # weights and shared uniforms; each int8 kernel's plain version timed
    # once on the same inputs, fed the kernel's samples
    with torch.no_grad():
        ups, auxs = [], []
        for m in voc_mels:
            vm = _clamp_mels(torch.from_numpy(m).to(dev))
            vm = F.pad(vm[None], (0, 0, voc.model.pad, voc.model.pad))
            up, aux = voc.model.upsample(vm)
            ups.append(fold_with_overlap(up, target, overlap))
            auxs.append(fold_with_overlap(aux, target, overlap))
        cond = _conditioning_streams(torch.cat(ups), torch.cat(auxs))
    T, B, _ = cond.shape
    if B != want_rows:
        raise RuntimeError(f"{B} fold rows, want {want_rows}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    u = torch.rand(T, B, wcell.n_draw("MOL", 30, 30), device=dev,
                   generator=torch.Generator(dev).manual_seed(3))
    cond_sm, u_sm = cond[:, :n_sm].contiguous(), u[:, :n_sm].contiguous()
    g = torch.Generator(dev).manual_seed(6)
    cond_seed = torch.cat(
        [torch.rand(T, B, ww.feat, device=dev, generator=g),
         torch.randn(T, B, 4 * ww.adim, device=dev, generator=g)], -1)
    serve = {}
    for wdt, wts in ((None, rand_mol), ("int8", rand_mol8),
                     ("int8_mxu", rand_mol8)):
        kw = dict(noise=u, weight_dtype=wdt)
        ms_all, (k_out, _) = cuda_ms(
            lambda: wcell.wavernn_sample_loop(cond, wts, **kw), 2,
            warm=False)
        bnd, by = loop_bound(wts, wdt, cond, u)
        name = "bf16" if wdt is None else wdt
        serve[name] = {"ms": ms_all, "bound": bnd, "by": by}
        line = (f"wavernn_sample_loop {name} at the serving shapes: "
                f"{ms_all:.2f} ms for T={T} x B={B} ({ms_all / T * 1e3:.2f} "
                f"us/step); bound {bnd:.4f} ms by {by}")
        if B > n_sm:            # rows past the SM count
            ms_sm, _ = cuda_ms(lambda: wcell.wavernn_sample_loop(
                cond_sm, wts, noise=u_sm, weight_dtype=wdt), 1, warm=False)
            serve[name]["ms_sm"] = ms_sm
            line += (f"; {ms_sm:.2f} ms for B={n_sm} ({ms_sm / T * 1e3:.2f} "
                     f"us/step), so the {B - n_sm} rows past the SM count "
                     f"add {ms_all - ms_sm:.2f} ms")
        # the same shapes on seeded conditioning of unit scale: a step
        # time that depends on the values shows as a difference
        ms_seed, _ = cuda_ms(lambda: wcell.wavernn_sample_loop(
            cond_seed, wts, noise=u, weight_dtype=wdt), 1, warm=False)
        line += (f"; {ms_seed / T * 1e3:.2f} us/step on seeded unit-scale "
                 f"conditioning")
        line += f" ({tiles(B)})"
        if wdt is not None:
            plain_ms, (t_out, _) = cuda_ms(
                lambda: wcell.wavernn_sample_loop_plain(
                    cond, wts, teacher=k_out, **kw), 1, warm=False)
            diff = (k_out - t_out).abs()
            agree = float((diff <= STEP_TOL).float().mean())
            # int8 on the export's conditioning: one bf16 step of an
            # activation is large there, and a mixture pick turned at the
            # clip is 2.0, so its error is phase 3b's (as the bf16 kernel's
            # is phase 3's) and its bar the bf16 one
            bar = STEP_AGREE if wdt == "int8_mxu" else STEP_AGREE_BF16
            if wdt == "int8_mxu":
                q_err[wdt] = max(q_err[wdt], float(diff.max()))
            serve[name]["plain"] = plain_ms
            line += (f"; plain {plain_ms:.1f} ms, per-step (same history) "
                     f"max |d| {float(diff.max()):.3e}, {agree:.6f} of steps "
                     f"within {STEP_TOL} (bar {bar})")
            if agree < bar or not bool(torch.isfinite(k_out).all()):
                failures.append(f"wavernn_sample_loop {wdt} vs plain "
                                "(serving shapes)")
        say(cl, line)

    say(cl, f"phase 6 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 7. the streamed path, and Griffin-Lim ----
    t0 = time.perf_counter()
    paths |= stream_phase(cl, tts, voc, ref_mel, spk, mel, failures)
    say(cl, f"phase 7 took {time.perf_counter() - t0:.1f} s")

    # ---- 8. the forward model, and a conv-decoder AR model ----
    t0 = time.perf_counter()
    paths |= forward_phase(cl, voc, ref_mel, spk,
                           {None: rand_mol, "int8": rand_mol8}, failures)
    say(cl, f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # ---- 9. training, and the trained weights through the fused decode ----
    t0 = time.perf_counter()
    paths |= train_phase(cl, ref_mel, spk, failures)
    say(cl, f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # ---- 10. GST-Tacotron text -> wav through Griffin-Lim ----
    t0 = time.perf_counter()
    paths |= tacotron_phase(cl, wav_ref, failures)
    say(cl, f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # ---- 11. the forward model's training, its export through B1 ----
    t0 = time.perf_counter()
    paths |= forward_train_phase(cl, voc, failures)
    say(cl, f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # ---- 12. the vocoder's training flow, the trained export through B1 --
    # ---- 13 and 15 beside it, in a process of their own (side_main) ----
    side = _start_side()
    try:
        t0 = time.perf_counter()
        paths |= vocoder_train_phase(cl, voc, failures)
        say(cl, f"phase 12 took {time.perf_counter() - t0:.1f} s (phases 13 "
                f"and 15 beside it)")
        t1 = time.perf_counter()
        paths |= _finish_side(side, failures)
        say(cl, f"phases 12, 13 and 15 took {time.perf_counter() - t0:.1f} "
                f"s, phases 13 and 15 ending {time.perf_counter() - t1:.1f} "
                f"s after phase 12")
    finally:
        _stop_side(side)

    # ---- 14. precision bfloat16: serving, streaming, training ----
    t0 = time.perf_counter()
    paths |= bf16_phase(cl, tts, voc, ref_mel, spk, dec_s, failures)
    say(cl, f"phase 14 took {time.perf_counter() - t0:.1f} s")

    # ---- 16. data parallelism: two ranks on the card, one NCCL rank ----
    t0 = time.perf_counter()
    paths |= dp_phase(cl, voc, failures)
    say(cl, f"phase 16 took {time.perf_counter() - t0:.1f} s")

    kernels = [
        {"name": "fused_decode", "route": "cuda",
         "source": "etts_torch/csrc/decoder_step.cu",
         "replaces": "etts/ops/pallas/decoder_step.py:464",
         "launches": paths["main"]["fused_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None},
        {"name": "wavernn_sample_loop", "route": "cuda",
         "source": "etts_torch/csrc/wavernn_cell.cu",
         "replaces": "etts/ops/pallas/wavernn_cell.py:351",
         "launches": paths["main"]["wavernn_sample_loop"],
         "max_abs_err": voc_err,
         "ms": voc_ms, "plain_ms": voc_plain_ms, "bound_ms": voc_bound,
         "bound_by": voc_by, "library_ms": None},
    ] + [
        {"name": f"wavernn_sample_loop_{wdt}", "route": "cuda",
         "source": "etts_torch/csrc/wavernn_cell.cu",
         "replaces": "etts/ops/pallas/wavernn_cell.py:351",
         "launches": paths[f"serving_{wdt}"][f"wavernn_sample_loop_{wdt}"],
         "max_abs_err": q_err[wdt], "ms": serve[wdt]["ms"],
         "plain_ms": serve[wdt]["plain"], "bound_ms": serve[wdt]["bound"],
         "bound_by": serve[wdt]["by"], "library_ms": None}
        for wdt in ("int8", "int8_mxu")]
    # each entry's launches are those of the run it describes (the main
    # path, or the serving run in its mode); every path's own run beside
    for kern in kernels:
        kern["launches_by_path"] = {p: ran[kern["name"]]
                                    for p, ran in paths.items()}
        say(cl, f"{kern['name']} launches by path: "
                f"{kern['launches_by_path']}")
    for kern in kernels:
        if not all(math.isfinite(kern[k]) for k in
                   ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            raise RuntimeError(f"non-finite measurement: {kern}")
    if failures:
        raise RuntimeError(f"failed: {failures}")
    print(cl, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
