"""Seeds derived from seeds: the port's counterpart of
``jax.random.fold_in``."""
from __future__ import annotations

import hashlib

__all__ = ["fold_in"]


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data``."""
    h = hashlib.blake2b(f"{seed}:{data}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1
