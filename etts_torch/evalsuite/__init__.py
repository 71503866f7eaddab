"""The evaluation suite (port of ``etts/evalsuite``): DTW-aligned objective
metrics (numpy and scipy), WER, and the offline char-CTC transcriber
(``ctc_asr``, torch; imported where it is used)."""
from .dtw import dtw_path, dtw_distance
from .metrics import (mel_cepstrum, mcd, frame_disturbance, f0_autocorr,
                      f0_rmse, stoi, compute_all_metrics)
from .wer import wer, normalize_for_wer
