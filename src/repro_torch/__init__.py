"""PyTorch port of the TinyReptile system, for NVIDIA Hopper GPUs.

Mirrors the module layout of the JAX package ``repro``. It imports
torch, numpy and the standard library only; the kernels on its paths
are written by hand in CUDA C++ (``kernels/csrc``).
"""
