"""DSP and model ops in plain PyTorch, plus the CUDA kernels (``kernels``)."""
