"""Attention -> per-phoneme integer durations (own copy of
``etts/align/durations.py``, numpy, host side).

The reference's `TransformerTTS/utils/alignments.py`: head scoring by a
diagonal-distance mask, weighted-average or best-head selection, binary
peak or normalized-sum rounding with the leftover redistributed, zero
filling, attention-jump fixing. Invariant: sum(durations) == mel_len - 2
(alignments.py:159). ``normalized_durations`` gives the real-valued
durations that the non-binary mode rounds, so that a caller can show
where two runs' durations differ at a rounding tie.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "duration_to_alignment_matrix", "clean_attention", "weight_mask",
    "fill_zeros", "fix_attention_jumps", "binary_attention",
    "get_durations_from_alignment", "normalized_durations",
]


def duration_to_alignment_matrix(durations):
    """Integer durations -> binary (n_phon, total_frames) alignment
    (alignments.py:10-16)."""
    durations = np.asarray(durations, int)
    starts = np.cumsum(np.append([0], durations[:-1]))
    tot = np.sum(durations)
    pads = tot - starts - durations
    return np.array([np.concatenate([np.zeros(starts[i]),
                                     np.ones(durations[i]),
                                     np.zeros(pads[i])])
                     for i in range(len(durations))])


def clean_attention(binary_attention, jump_threshold):
    """Clamp per-frame attention jumps beyond threshold (alignments.py:19-28)."""
    phon_idx = 0
    clean = np.zeros(binary_attention.shape)
    for i, av in enumerate(binary_attention):
        next_idx = int(np.argmax(av))
        if abs(next_idx - phon_idx) > jump_threshold:
            next_idx = phon_idx
        phon_idx = next_idx
        clean[i, min(phon_idx, clean.shape[1] - 1)] = 1
    return clean


def weight_mask(attention_weights):
    """Distance-from-diagonal weighting (alignments.py:31-36)."""
    max_m, max_n = attention_weights.shape
    i = np.tile(np.arange(max_n), (max_m, 1)) / max_n
    j = np.swapaxes(np.tile(np.arange(max_m), (max_n, 1)), 0, 1) / max_m
    return np.sqrt(np.square(i - j))


def fill_zeros(duration, take_from="next"):
    """Replace zero durations with 1, borrowing from the next nonzero or the
    max (alignments.py:39-53).

    The reference's ``if avail:`` tested an int-or-array value; here ``avail``
    is always a scalar donor offset. Offset 0 means "no donor": for 'next' it
    cannot occur (duration[i] == 0 excludes i itself from the >1 candidates),
    for 'max' it means every remaining duration is 0 — nothing to borrow.
    Behavior is identical to the reference for all reachable inputs."""
    duration = np.asarray(duration).copy()
    for i in range(len(duration)):
        if i < (len(duration) - 1) and duration[i] == 0:
            if take_from == "next":
                cands = np.where(duration[i:] > 1)[0]
                avail = int(cands[0]) if len(cands) else 0
            else:  # 'max'
                avail = int(np.argmax(duration[i:]))
            if avail > 0:
                duration[i] = 1
                duration[i + avail] -= 1
    return duration


def binary_attention(attention_weights):
    """Single-peak-per-frame binarization + diagonal score (alignments.py:78-84)."""
    peak = attention_weights.max(axis=1)
    binary = (attention_weights.T == peak).astype(int).T
    if np.sum(np.sum(attention_weights.T == peak, axis=0) != 1) != 0:
        raise ValueError("multiple attention peaks on one mel step")
    return binary, np.sum(attention_weights * binary)


def fix_attention_jumps(binary_attn, alignments_weights, binary_score):
    """Scan jump thresholds, relax while the cleaned score collapses
    (alignments.py:56-75)."""
    clean_scores, clean_attns = [], []
    for jumpth in [2, 3, 4, 5]:
        cl = clean_attention(binary_attn, jumpth)
        clean_attns.append(cl)
        clean_scores.append(np.sum(alignments_weights * cl))
    best_idx = int(np.argmin(clean_scores))
    best_score = clean_scores[best_idx]
    best = clean_attns[best_idx]
    jumpth = 5
    while ((best_score - binary_score) > 2.0) and (jumpth < 20):
        jumpth += 1
        best = clean_attention(binary_attn, jumpth)
        best_score = np.sum(alignments_weights * best)
    return best


def _unpad_lengths(mels, phonemes):
    """Lengths from the padding conventions: mel frames are padding iff
    all-zero; phoneme id 0 is padding."""
    mel_lens = (np.abs(mels).sum(-1) != 0).sum(-1)
    phon_lens = (np.asarray(phonemes) != 0).sum(-1)
    return mel_lens, phon_lens


def _reference_attention(unpad_al, weighted):
    """(the attention the durations come from: the heads divided by their
    diagonal scores and summed, or the best head; the diagonal weight
    mask; each head's score)."""
    weights = weight_mask(unpad_al[0])
    head_scores, scored = [], []
    for attention in unpad_al:
        score = np.sum(weights * attention)
        scored.append(attention / score)
        head_scores.append(score)
    if weighted:
        ref_attention = np.sum(scored, axis=0)
    else:
        ref_attention = unpad_al[int(np.argmin(head_scores))]
    return ref_attention, weights, head_scores


def normalized_durations(alignment, mel_len: int, phon_len: int,
                         weighted=False):
    """The real-valued durations (phon_len - 2,) that the non-binary mode
    of ``get_durations_from_alignment`` rounds for one row: ``alignment``
    (heads, t_mel, t_phon), its real lengths with the sentinels."""
    unpad_al = np.asarray(alignment)[:, 1:mel_len - 1, 1:phon_len - 1]
    attn_durs = np.sum(_reference_attention(unpad_al, weighted)[0], axis=0)
    return attn_durs * ((mel_len - 2) / np.sum(attn_durs))


def get_durations_from_alignment(batch_alignments, mels, phonemes,
                                 weighted=False, binary=False,
                                 fill_gaps=False, fix_jumps=False,
                                 fill_mode="max"):
    """Port of alignments.py:87-165.

    batch_alignments: (b, heads, t_mel, t_phon) cross-attention of the last
    decoder block; mels (b, t_mel, c); phonemes (b, t_phon).
    Returns (durations, unpad_mels, unpad_phonemes, final_alignments).
    """
    if fix_jumps and not binary:
        raise ValueError("Cannot fix jumps in non-binary attention.")
    mels = np.asarray(mels)
    phonemes = np.asarray(phonemes)
    mel_lens, phon_lens = _unpad_lengths(mels, phonemes)
    durations, unpad_mels, unpad_phonemes, final_alignment = [], [], [], []
    for i, al in enumerate(np.asarray(batch_alignments)):
        mel_len, phon_len = int(mel_lens[i]), int(phon_lens[i])
        # strip start/end sentinels on both axes
        unpad_al = al[:, 1:mel_len - 1, 1:phon_len - 1]
        unpad_mels.append(mels[i, 1:mel_len - 1, :])
        unpad_phonemes.append(phonemes[i, 1:phon_len - 1])
        ref_attention, weights, head_scores = _reference_attention(
            unpad_al, weighted)

        if binary:
            battn, bscore = binary_attention(ref_attention)
            if fix_jumps:
                battn = fix_attention_jumps(battn, weights, bscore)
            integer_durations = battn.sum(axis=0)
        else:
            attn_durs = np.sum(ref_attention, axis=0)
            normalized = attn_durs * ((mel_len - 2) / np.sum(attn_durs))
            integer_durations = np.round(normalized)
            diff = np.sum(integer_durations) - (mel_len - 2)
            while diff != 0:
                rounding_diff = integer_durations - normalized
                if diff > 0:
                    integer_durations[int(np.argmax(rounding_diff))] -= 1
                else:
                    integer_durations[int(np.argmin(rounding_diff))] += 1
                diff = np.sum(integer_durations) - (mel_len - 2)

        if fill_gaps:
            integer_durations = fill_zeros(integer_durations,
                                           take_from=fill_mode)
        if np.sum(integer_durations) != mel_len - 2:
            raise RuntimeError(f"durations sum to {np.sum(integer_durations)}"
                               f", not {mel_len - 2}")
        new_alignment = duration_to_alignment_matrix(
            integer_durations.astype(int))
        best = unpad_al[int(np.argmin(head_scores))]
        final_alignment.append(best.T + new_alignment)
        durations.append(integer_durations)
    return durations, unpad_mels, unpad_phonemes, final_alignment
