"""Hand-written CUDA kernels for the filter's bandwidth-bound passes.

Each kernel module holds the kernel's wrapper, its plain PyTorch
version and its launch counter; the sources are in ``repro_torch/csrc``
and :mod:`.cuda_lib` builds them with nvcc at first use.
"""
