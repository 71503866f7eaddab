"""Attention -> per-phoneme durations (own copy of ``etts/align``)."""
from .durations import (binary_attention, clean_attention,
                        duration_to_alignment_matrix, fill_zeros,
                        fix_attention_jumps, get_durations_from_alignment,
                        normalized_durations, weight_mask)

__all__ = ["duration_to_alignment_matrix", "clean_attention", "weight_mask",
           "fill_zeros", "fix_attention_jumps", "binary_attention",
           "get_durations_from_alignment", "normalized_durations"]
