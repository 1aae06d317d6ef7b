"""Symmetric Chamfer loss through the hand-written CUDA kernels of
``csrc/chamfer.cu``, the counterpart of ``pointcloududa_tpu/ops/chamfer_pallas.py``.

:func:`chamfer_loss` is a drop-in for ``ops.losses.chamfer_loss`` (without
``sample_mask``). The forward is one launch (:func:`forward_fused`, the
counterpart of ``_chamfer_fwd``): each point's nearest neighbour in the other
cloud, both directions, and per item the mean of ``sqrt(min + 1e-5)`` in each
direction; the loss is one reduction over those (B, 2) means. The backward
needs only the argmin indices (:func:`side_grad`): ``d|x_i - y_a(i)| / dx_i``
is the unit vector of the pair, and the scatter onto the partners is summed
without atomics. :func:`nn_directional` is the one-direction search on its
own (the counterpart of ``_nn_directional_tiled``); the loss does not use it.

Each wrapper launches its kernel for a CUDA tensor, or raises, and counts the
launch in its ``launches`` attribute. Only a CPU tensor takes the plain PyTorch
version beside it (``*_plain``).
"""

from __future__ import annotations

import torch

from pointcloududa_torch.ops.losses import batch_pairwise_dist
from pointcloududa_torch.utils import native

EPS = 1e-5  # reference loss.py:68


def _check_clouds(a: torch.Tensor, c: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"the Chamfer kernels run on CUDA tensors only, got {a.device}")
    for t in (a, c):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3 or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 (B, N, 3) clouds, got {t.dtype} {tuple(t.shape)}")
    if a.device != c.device or a.shape[0] != c.shape[0]:
        raise ValueError("clouds must share device and batch size")
    if not 1 <= a.shape[0] <= 65535 or a.shape[1] < 1 or c.shape[1] < 1:
        raise ValueError(f"unsupported cloud shapes {tuple(a.shape)}, {tuple(c.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def nn_directional_plain(a: torch.Tensor, c: torch.Tensor):
    """(B, N, D), (B, M, D) -> min over j of the clamped squared distance
    (B, N) f32, and its lowest argmin (B, N) int32."""
    p = torch.clamp_min(batch_pairwise_dist(a, c), 0.0)
    mins, idx = torch.min(p, dim=2)
    return mins, idx.to(torch.int32)


def nn_directional(a: torch.Tensor, c: torch.Tensor):
    """Nearest neighbour of every point of ``a`` in ``c``; see
    :func:`nn_directional_plain`."""
    if a.device.type == "cpu":
        return nn_directional_plain(a, c)
    _check_clouds(a, c)
    b, n, _ = a.shape
    mins = torch.empty((b, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        status = native.load().pcuda_chamfer_nn(
            a.data_ptr(), c.data_ptr(), mins.data_ptr(), idx.data_ptr(), b, n, c.shape[1], _stream(a)
        )
    native.check(status, "pcuda_chamfer_nn")
    nn_directional.launches += 1
    return mins, idx


nn_directional.launches = 0


def forward_fused_plain(x: torch.Tensor, y: torch.Tensor):
    """(B, N, D), (B, M, D) -> ``loss_parts`` (B, 2) f32 with the per-item
    means of ``sqrt(min + 1e-5)`` over x's points and over y's points,
    ``idx1`` (B, N) and ``idx2`` (B, M) int32: the lowest argmins of either
    direction. ``batch_pairwise_dist(y, x)`` is the exact transpose of
    ``batch_pairwise_dist(x, y)`` (sums and products commute), so the second
    direction is searched along rows too, where ``torch.min`` keeps the
    lowest index of a tie."""
    min1, idx1 = nn_directional_plain(x, y)
    min2, idx2 = nn_directional_plain(y, x)
    parts = torch.stack([torch.sqrt(min1 + EPS).mean(dim=1), torch.sqrt(min2 + EPS).mean(dim=1)], dim=1)
    return parts, idx1, idx2


def _launch_fused(x: torch.Tensor, y: torch.Tensor, cluster: int | None = None):
    """One launch of the fused forward; ``cluster`` (blocks per item, 1..8)
    defaults to ``native.cluster_size``: the largest cluster of which the
    device runs all B at once when every block takes a whole SM. That choice
    is empirical: these blocks are small and the occupancy calculator promises
    several times as many clusters of them, yet the launch's time steps up where
    the whole-SM count runs out (``chip_smoke.py`` phase (a) prints the time by
    cluster size beside it)."""
    _check_clouds(x, y)
    b, n, _ = x.shape
    m = y.shape[1]
    if cluster is None:
        cluster = native.cluster_size(b, x.device)
    idx1 = torch.empty((b, n), dtype=torch.int32, device=x.device)
    idx2 = torch.empty((b, m), dtype=torch.int32, device=x.device)
    parts = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = native.load().pcuda_chamfer_forward(
            x.data_ptr(), y.data_ptr(), idx1.data_ptr(), idx2.data_ptr(), parts.data_ptr(), b, n, m, cluster, _stream(x)
        )
    native.check(status, "pcuda_chamfer_forward")
    forward_fused.launches += 1
    return parts, idx1, idx2


def forward_fused(x: torch.Tensor, y: torch.Tensor):
    """The whole Chamfer forward in one launch; see
    :func:`forward_fused_plain`. Call it once before capturing it in a CUDA
    graph (the first call asks the device how many clusters it runs at once)."""
    if x.device.type == "cpu":
        return forward_fused_plain(x, y)
    return _launch_fused(x, y)


forward_fused.launches = 0


def side_grad_plain(a, c, idx_ac, idx_ca, g):
    """Gradient of the Chamfer loss with respect to cloud ``a``:
    ``g/(B n) u_i - g/(B m) sum_{k: idx_ca[k] == i} v_k`` with ``u_i`` the unit
    vector from ``c[idx_ac[i]]`` to ``a_i`` and ``v_k`` from ``a_i`` to ``c_k``
    (both as ``diff / sqrt(|diff|^2 + 1e-5)``)."""
    b, n, d = a.shape
    m = c.shape[1]
    partner = torch.gather(c, 1, idx_ac.long()[..., None].expand(-1, -1, d))
    diff = a - partner
    u = diff / torch.sqrt(torch.sum(diff * diff, dim=-1) + EPS)[..., None]
    idx_ca = idx_ca.long()[..., None].expand(-1, -1, d)
    diff_c = c - torch.gather(a, 1, idx_ca)
    v = diff_c / torch.sqrt(torch.sum(diff_c * diff_c, dim=-1) + EPS)[..., None]
    scat = torch.zeros_like(a).scatter_add_(1, idx_ca, v)
    return (g / (b * n)) * u - (g / (b * m)) * scat


def side_grad(a, c, idx_ac, idx_ca, g):
    """See :func:`side_grad_plain`; ``g`` is the loss's upstream gradient
    as a one-element tensor on ``a``'s device (never read on the host)."""
    if a.device.type == "cpu":
        return side_grad_plain(a, c, idx_ac, idx_ca, g)
    _check_clouds(a, c)
    b, n, _ = a.shape
    m = c.shape[1]
    for t, shape in ((idx_ac, (b, n)), (idx_ca, (b, m))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"expected contiguous int32 {shape} indices on {a.device}")
    g = g.to(device=a.device, dtype=torch.float32).reshape(1).contiguous()
    da = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = native.load().pcuda_chamfer_side_grad(
            a.data_ptr(), c.data_ptr(), idx_ac.data_ptr(), idx_ca.data_ptr(), g.data_ptr(),
            da.data_ptr(), b, n, m, _stream(a),
        )
    native.check(status, "pcuda_chamfer_side_grad")
    side_grad.launches += 1
    return da


side_grad.launches = 0


def chamfer_forward(x: torch.Tensor, y: torch.Tensor):
    """(loss, idx1, idx2): the loss and both directions' argmins."""
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    parts, idx1, idx2 = forward_fused(x, y)
    return parts.sum() / parts.shape[0], idx1, idx2


class _ChamferLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.dtypes = (x.dtype, y.dtype)
        x = x.to(torch.float32).contiguous()
        y = y.to(torch.float32).contiguous()
        loss, idx1, idx2 = chamfer_forward(x, y)
        ctx.save_for_backward(x, y, idx1, idx2)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, idx1, idx2 = ctx.saved_tensors
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = side_grad(x, y, idx1, idx2, g).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dy = side_grad(y, x, idx2, idx1, g).to(ctx.dtypes[1])
        return dx, dy


def chamfer_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer loss of (B, N, 3) and (B, M, 3) clouds."""
    return _ChamferLoss.apply(x, y)


def reset_launches() -> None:
    forward_fused.launches = 0
    nn_directional.launches = 0
    side_grad.launches = 0
