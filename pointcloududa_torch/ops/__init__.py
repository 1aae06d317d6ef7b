"""Losses, the CUDA kernels with their wrappers, device point clouds, the
augmentation pipelines, and the evaluation's host-side numpy ops (metrics,
post-processing, CLAHE)."""
