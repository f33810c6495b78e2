"""Hand-written GPU kernels, each beside its plain PyTorch version.

A wrapper runs the plain version on CPU tensors and launches its kernel on
CUDA tensors (or raises); kernels are built from `csrc/` at first use.
"""
