"""Hopper kernels (CUDA C++ in ``csrc/`` and Triton), each beside its plain PyTorch version."""
