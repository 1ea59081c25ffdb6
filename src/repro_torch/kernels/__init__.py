"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), their ctypes
wrappers, and the plain PyTorch versions they are held against."""
