"""BatchNorm batch statistics in plain PyTorch: the port's
``ops/bn_kernel.py:stats_forward_plain``, ``stats_backward_plain`` and
``batch_stats`` (frozen), where the port launches ``csrc/bn_stats.cu``."""

from __future__ import annotations

import torch


def _reduce_dims(x: torch.Tensor) -> tuple:
    return (0,) + tuple(range(2, x.dim()))


def stats_forward_plain(x: torch.Tensor):
    xf = x.to(torch.float32)
    dims = _reduce_dims(x)
    return torch.mean(xf, dim=dims), torch.mean(xf * xf, dim=dims)


def stats_backward_plain(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor):
    """dx = g_m / N + 2 x g_q / N in f32, returned in x's dtype."""
    inv_n = 1.0 / (x.numel() // x.shape[1])
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dx = g_mean.reshape(shape) * inv_n + x.to(torch.float32) * (2.0 * inv_n) * g_meansq.reshape(shape)
    return dx.to(x.dtype)


def batch_stats(x: torch.Tensor, use_kernel: bool = False):
    """(mean, var) over every axis but dim 1, f32, with the fast variance
    clipped at 0; ``use_kernel`` is accepted for the models' signature and
    ignored."""
    mean, meansq = stats_forward_plain(x)
    return mean, torch.clamp_min(meansq - torch.square(mean), 0.0)
