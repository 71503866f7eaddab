"""etts_torch — the PyTorch/CUDA port of ``etts`` for NVIDIA Hopper.

Imports ``torch`` only: never ``jax``, ``flax`` or anything of ``etts``.
Submodules import lazily; the CUDA kernels build at their first launch.
"""
