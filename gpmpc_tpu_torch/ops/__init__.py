"""Kernels, factorizations and the CUDA kernel wrappers."""
