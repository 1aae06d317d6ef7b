"""Losses and the CUDA kernels with their wrappers."""
