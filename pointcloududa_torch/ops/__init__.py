"""Losses, the CUDA kernels with their wrappers, device point clouds and the
light augmentation."""
