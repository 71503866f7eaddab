"""The float32 setting that every check of the port on the card holds:
matmuls and cuDNN convolutions in IEEE float32, without TF32.

torch's default computes cuDNN convolutions in TF32 (a 10-bit mantissa), so
a process that leaves it keeps convolutions that no check runs. Every entry
point of the port (the synthesizers' constructors and each CLI's ``main``)
calls ``pin_float32`` before it computes anything."""
from __future__ import annotations

import torch

__all__ = ["pin_float32"]


def pin_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
