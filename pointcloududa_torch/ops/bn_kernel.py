"""BatchNorm batch statistics through the hand-written CUDA kernels of
``csrc/bn_stats.cu``, the counterpart of ``pointcloududa_tpu/ops/bn_pallas.py``.

:func:`bn_stats` returns the per-channel ``(mean, mean of squares)`` in f32 of
an activation whose channel axis is dim 1 (NCHW, or a (rows, C) matrix), with
the gradient ``dx = g_m / N + 2 x g_q / N``.
:func:`batch_stats` forms the flax fast variance ``max(E[x^2] - E[x]^2, 0)``
from it, the statistics ``_TwinBatchNorm`` normalises with.

The kernels take the port's two compute dtypes, float32 and bfloat16 (read
in its own type and widened to float32 in registers, as the TPU kernel does;
the statistics and every sum are float32, ``dx`` has x's type), and every
channel count and row count: there is no counterpart of the TPU kernel's
``C % 128`` fallback. Each is one launch, shaped by a pure function of the
shape, the dtype and the alignment (:func:`forward_plan`,
:func:`backward_plan`). Each wrapper launches its kernel for a CUDA tensor,
or raises, and counts the launch in its ``launches`` attribute, a bfloat16
launch also in ``bf16_launches``; only a CPU tensor takes the plain PyTorch
version beside it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from pointcloududa_torch.parallel import collectives
from pointcloududa_torch.utils import native

THREADS = 256  # threads a block, both kernels (csrc/bn_stats.cu: kThreads)
FORWARD_BLOCKS_PER_SM = 2  # the forward's C x S blocks fill the SMs about this often, in one wave
BACKWARD_UNROLL = 4  # vectors a backward thread has in flight (kBackwardUnroll)
MAX_BACKWARD_BLOCKS = 65535  # the backward's grid at most (beyond it, threads take more rounds)
H100_SMS = 132
# x's dtype -> (suffix of the C entry points of its instantiation, values in a 16-byte vector)
_ENTRY = {torch.float32: ("", 4), torch.bfloat16: ("_bf16", 8)}


class ForwardPlan(NamedTuple):
    """One forward launch: a grid of (cluster, C) blocks, clusters of
    ``cluster`` blocks sharing a channel; rank r sums the ``vec``-value
    groups ``ranges()[r]`` of its channel (group g holds the values
    ``(g // (inner // vec), c, (g % (inner // vec)) * vec + 0 .. vec - 1)``)."""

    cluster: int
    vec: int
    groups: int  # vec-value groups of a channel
    chunk: int  # groups a block

    def ranges(self) -> list[tuple[int, int]]:
        return [(min(r * self.chunk, self.groups), min((r + 1) * self.chunk, self.groups)) for r in range(self.cluster)]


class BackwardPlan(NamedTuple):
    """One backward launch: ``blocks`` blocks of THREADS threads; thread t
    of the grid takes the vectors t, t + T, t + 2T, ... (T = blocks *
    THREADS) of ``vec`` values each, BACKWARD_UNROLL at a time."""

    vec: int
    blocks: int


def _vector_width(dtype: torch.dtype, inner: int, aligned: bool) -> int:
    """Values a load: a 16-byte vector where every vector lies inside one
    plane of a channel (``inner`` a multiple of it) and the tensors are
    16-byte aligned, else 1."""
    vec = _ENTRY[dtype][1]
    return vec if aligned and inner % vec == 0 else 1


def forward_plan(outer: int, c: int, inner: int, dtype: torch.dtype, aligned: bool, sms: int = H100_SMS,
                 cluster: int | None = None) -> ForwardPlan:
    """The forward's launch for x of (outer, c, inner): the largest cluster
    of 1, 2, 4 or 8 blocks (``native.MAX_CLUSTER`` at most) with ``c *
    cluster <= FORWARD_BLOCKS_PER_SM * sms`` (one wave of about two blocks
    an SM) that still gives a block at least THREADS groups (the last one
    what is left); ``cluster`` forces the size."""
    vec = _vector_width(dtype, inner, aligned)
    groups = outer * inner // vec
    if cluster is None:
        cluster = 1
        while (2 * cluster <= native.MAX_CLUSTER and 2 * cluster * c <= FORWARD_BLOCKS_PER_SM * sms
               and groups >= 2 * cluster * THREADS):
            cluster *= 2
    return ForwardPlan(cluster, vec, groups, -(-groups // cluster))


def backward_plan(outer: int, c: int, inner: int, dtype: torch.dtype, aligned: bool) -> BackwardPlan:
    """The backward's launch: one round of BACKWARD_UNROLL vectors a thread
    (up to MAX_BACKWARD_BLOCKS blocks). On the H100 this beat a grid of one
    wave with several rounds a thread by 7-8% at the largest BatchNorm
    shapes (``chip_smoke.py`` phase (b), PERF.md)."""
    vec = _vector_width(dtype, inner, aligned)
    total = outer * c * inner // vec
    return BackwardPlan(vec, max(1, min(-(-total // (THREADS * BACKWARD_UNROLL)), MAX_BACKWARD_BLOCKS)))


def _layout(x: torch.Tensor):
    """(outer, C, inner) of a tensor whose channel axis is dim 1."""
    if x.dim() < 2:
        raise ValueError(f"expected (N, C, ...) input, got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1], math.prod(x.shape[2:])


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the BN-statistics kernels run on CUDA tensors only, got {x.device}")
    if x.dtype not in _ENTRY or not x.is_contiguous():
        raise ValueError(f"expected a contiguous float32 or bfloat16 tensor, got {x.dtype}")
    outer, c, inner = _layout(x)
    if not (1 <= c <= 65535 and outer * inner >= 1 and x.numel() < 2**31):
        raise ValueError(f"unsupported BN-statistics shape {tuple(x.shape)}")


def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def forward_clusters(dtype: torch.dtype, vec: int, cluster: int, device: torch.device) -> int:
    """Clusters of ``cluster`` forward blocks that ``device`` runs at once:
    the occupancy calculator asked about this kernel's own block size and
    shared memory (outside any graph capture)."""
    clusters = ctypes.c_int(0)
    with torch.cuda.device(_device_index(device)):
        native.check(native.load().pcuda_bn_stats_forward_clusters(
            int(dtype == torch.bfloat16), vec, cluster, ctypes.byref(clusters)), "pcuda_bn_stats_forward_clusters")
    return clusters.value


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
    return _launch_forward(x, forward_plan(outer, c, inner, x.dtype, _aligned(x), native.sm_count(x.device)))


def _launch_forward(x: torch.Tensor, plan: ForwardPlan):
    """One forward launch of a checked ``x`` as ``plan`` shapes it; the two
    rows of one (2, C) output."""
    outer, c, inner = _layout(x)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    name = "pcuda_bn_stats_forward" + _ENTRY[x.dtype][0]
    with torch.cuda.device(x.device):
        status = getattr(native.load(), name)(
            x.data_ptr(), out.data_ptr(), outer, c, inner, plan.cluster, plan.vec, plan.chunk,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    native.check(status, name)
    stats_forward.launches += 1
    if x.dtype == torch.bfloat16:
        stats_forward.bf16_launches += 1
    return out[0], out[1]


stats_forward.launches = 0
stats_forward.bf16_launches = 0


def stats_backward_plain(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor):
    inv_n = 1.0 / (x.numel() // x.shape[1])
    dx = _per_channel(g_mean, x) * inv_n + x.to(torch.float32) * (2.0 * inv_n) * _per_channel(g_meansq, x)
    return dx.to(x.dtype)


def stats_backward(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor):
    """dx = g_m / N + 2 x g_q / N in f32, returned in x's dtype."""
    if x.device.type == "cpu":
        return stats_backward_plain(x, g_mean, g_meansq)
    _check(x)
    outer, c, inner = _layout(x)
    g_mean = g_mean.to(device=x.device, dtype=torch.float32).contiguous()
    g_meansq = g_meansq.to(device=x.device, dtype=torch.float32).contiguous()
    if g_mean.shape != (c,) or g_meansq.shape != (c,):
        raise ValueError(f"expected ({c},) gradients")
    dx = torch.empty_like(x)
    return _launch_backward(x, g_mean, g_meansq, dx, backward_plan(outer, c, inner, x.dtype, _aligned(x, dx)))


def _launch_backward(x: torch.Tensor, g_mean: torch.Tensor, g_meansq: torch.Tensor, dx: torch.Tensor,
                     plan: BackwardPlan):
    """One backward launch of checked tensors as ``plan`` shapes it, into
    ``dx``."""
    outer, c, inner = _layout(x)
    name = "pcuda_bn_stats_backward" + _ENTRY[x.dtype][0]
    with torch.cuda.device(x.device):
        status = getattr(native.load(), name)(
            x.data_ptr(), g_mean.data_ptr(), g_meansq.data_ptr(), dx.data_ptr(),
            outer, c, inner, plan.vec, plan.blocks, torch.cuda.current_stream(x.device).cuda_stream,
        )
    native.check(status, name)
    stats_backward.launches += 1
    if x.dtype == torch.bfloat16:
        stats_backward.bf16_launches += 1
    return dx


stats_backward.launches = 0
stats_backward.bf16_launches = 0


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


def batch_stats(x: torch.Tensor):
    """flax-equivalent (mean, var) over every axis but dim 1, f32, with the
    fast variance clipped at 0, through :func:`bn_stats`: the kernels for a
    CUDA tensor, their plain versions for a CPU one. Under a data mesh the
    (mean, mean of squares) pair is the global batch's: one all-reduce of the
    rank's pair, before the variance is formed (``parallel/collectives.py``)."""
    return _mean_var(*bn_stats(x))


def plain_batch_stats(x: torch.Tensor):
    """:func:`batch_stats` from the plain reduction, through autograd, on any
    device: the statistics of D4's norms, which the JAX package never takes
    from its kernel (``pointcloududa_tpu/models/pointnet.py:60``)."""
    return _mean_var(*stats_forward_plain(x))


def _mean_var(mean: torch.Tensor, meansq: torch.Tensor):
    if collectives.active():
        mean, meansq = collectives.global_mean(torch.stack([mean, meansq])).unbind(0)
    return mean, torch.clamp_min(meansq - torch.square(mean), 0.0)


def reset_launches() -> None:
    for fn in (stats_forward, stats_backward):
        fn.launches = fn.bf16_launches = 0
