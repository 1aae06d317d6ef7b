"""BatchNorm batch statistics through the hand-written CUDA kernels of
``csrc/bn_stats.cu``, the counterpart of ``pointcloududa_tpu/ops/bn_pallas.py``.

:func:`bn_stats` returns the per-channel ``(mean, mean of squares)`` in f32 of
an activation whose channel axis is dim 1 (NCHW, or a (rows, C) matrix), with
the gradient ``dx = g_m / N + 2 x g_q / N``.
:func:`batch_stats` forms the flax fast variance ``max(E[x^2] - E[x]^2, 0)``
from it, the statistics ``_TwinBatchNorm`` normalises with.

The kernels take float32 (the port's only compute dtype) and every channel
count and row count: there is no counterpart of
the TPU kernel's ``C % 128`` fallback. Each wrapper launches its kernel for a
CUDA tensor, or raises, and counts the launch in its ``launches`` attribute;
only a CPU tensor takes the plain PyTorch version beside it.
"""

from __future__ import annotations

import math

import torch

from pointcloududa_torch.utils import native

_ELEMS_PER_BLOCK = 4096  # elements one forward block reduces (16 per thread)
_MAX_SPLITS = 1024


def _layout(x: torch.Tensor):
    """(outer, C, inner) of a tensor whose channel axis is dim 1."""
    if x.dim() < 2:
        raise ValueError(f"expected (N, C, ...) input, got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1], math.prod(x.shape[2:])


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the BN-statistics kernels run on CUDA tensors only, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous float32 tensor, got {x.dtype}")
    outer, c, inner = _layout(x)
    if not (1 <= c <= 65535 and outer * inner >= 1 and x.numel() < 2**31):
        raise ValueError(f"unsupported BN-statistics shape {tuple(x.shape)}")


def _reduce_dims(x: torch.Tensor):
    return (0,) + tuple(range(2, x.dim()))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def stats_forward_plain(x: torch.Tensor):
    xf = x.to(torch.float32)
    dims = _reduce_dims(x)
    return torch.mean(xf, dim=dims), torch.mean(xf * xf, dim=dims)


def stats_forward(x: torch.Tensor):
    """(mean, mean of squares), both f32 (C,), over every axis but dim 1."""
    if x.device.type == "cpu":
        return stats_forward_plain(x)
    _check(x)
    outer, c, inner = _layout(x)
    per_chan = outer * inner
    splits = max(1, min(_MAX_SPLITS, -(-per_chan // _ELEMS_PER_BLOCK)))
    part = torch.empty((2, c, splits), dtype=torch.float32, device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    meansq = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = native.load().pcuda_bn_stats_forward(
            x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), mean.data_ptr(),
            meansq.data_ptr(), outer, c, inner, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    native.check(status, "pcuda_bn_stats_forward")
    stats_forward.launches += 1
    return mean, meansq


stats_forward.launches = 0


def stats_backward_plain(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor):
    inv_n = 1.0 / (x.numel() // x.shape[1])
    dx = _per_channel(g_mean, x) * inv_n + x.to(torch.float32) * (2.0 * inv_n) * _per_channel(g_meansq, x)
    return dx.to(x.dtype)


def stats_backward(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor):
    """dx = g_m / N + 2 x g_q / N in f32."""
    if x.device.type == "cpu":
        return stats_backward_plain(x, g_mean, g_meansq)
    _check(x)
    outer, c, inner = _layout(x)
    g_mean = g_mean.to(device=x.device, dtype=torch.float32).contiguous()
    g_meansq = g_meansq.to(device=x.device, dtype=torch.float32).contiguous()
    if g_mean.shape != (c,) or g_meansq.shape != (c,):
        raise ValueError(f"expected ({c},) gradients")
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = native.load().pcuda_bn_stats_backward(
            x.data_ptr(), g_mean.data_ptr(), g_meansq.data_ptr(), dx.data_ptr(),
            outer, c, inner, torch.cuda.current_stream(x.device).cuda_stream,
        )
    native.check(status, "pcuda_bn_stats_backward")
    stats_backward.launches += 1
    return dx


stats_backward.launches = 0


class _BNStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return stats_forward(x)

    @staticmethod
    def backward(ctx, g_mean, g_meansq):
        (x,) = ctx.saved_tensors
        c = x.shape[1]
        if g_mean is None:
            g_mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        if g_meansq is None:
            g_meansq = torch.zeros(c, dtype=torch.float32, device=x.device)
        return stats_backward(x, g_mean, g_meansq)


def bn_stats(x: torch.Tensor):
    """Differentiable (mean, mean of squares) through the kernels."""
    return _BNStats.apply(x)


def batch_stats(x: torch.Tensor, use_kernel: bool = True):
    """flax-equivalent (mean, var) over every axis but dim 1, f32, with the
    fast variance clipped at 0. ``use_kernel=False`` is the plain reduction
    (``bn_stats_impl="xla"``)."""
    mean, meansq = bn_stats(x) if use_kernel else stats_forward_plain(x)
    return mean, torch.clamp_min(meansq - torch.square(mean), 0.0)


def reset_launches() -> None:
    stats_forward.launches = 0
    stats_backward.launches = 0
