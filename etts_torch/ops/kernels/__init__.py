"""Hand-written CUDA kernels for Hopper (sources in ``etts_torch/csrc``), each
beside its plain PyTorch version and a launch counter (``<wrapper>.launches``).
The kernels build with nvcc at their first launch; importing this package
builds nothing."""
