"""Symmetric Chamfer loss through the hand-written CUDA kernels of
``csrc/chamfer.cu``, the counterpart of ``pointcloududa_tpu/ops/chamfer_pallas.py``.

:func:`chamfer_loss` is a drop-in for ``ops.losses.chamfer_loss`` (without
``sample_mask``). Its forward (:func:`chamfer_forward`) takes the TPU
package's two routes, by the same rule (:func:`fused_route`): clouds of at
most 512 x 512 pairs go through one launch (:func:`forward_fused`, the
counterpart of ``_chamfer_fwd``): each point's nearest neighbour in the
other cloud, both directions, and per item the mean of ``sqrt(min +
1e-5)`` in each direction; the loss is one reduction over those (B, 2)
means. Larger clouds go through two one-direction searches
(:func:`nn_directional`, the counterpart of ``_nn_directional_tiled``,
shaped by :func:`nn_plan`) and the means in PyTorch, as JAX's
``_chamfer_fwd_any`` does. The backward needs only the argmin indices
(:func:`side_grad`), on either route: ``d|x_i - y_a(i)| / dx_i`` is the
unit vector of the pair, and the scatter onto the partners is summed
without atomics, by several threads per point.

Each wrapper launches its kernel for a CUDA tensor, or raises, and counts the
launch in its ``launches`` attribute. Only a CPU tensor takes the plain PyTorch
version beside it (``*_plain``), on the same routes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointcloududa_torch.ops.losses import batch_pairwise_dist
from pointcloududa_torch.utils import native

EPS = 1e-5  # reference loss.py:68
SMALL_LIMIT = 512 * 512  # n * m up to this -> the fused forward (chamfer_pallas.py:_SMALL_LIMIT)


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


NN_THREADS = 256  # threads of a nearest-neighbour block (csrc/chamfer.cu: kNNThreads)
NN_QUERIES = 4  # queries a thread (csrc/chamfer.cu: kNNQueries)
NN_MIN_PARTNERS = 16  # the plan splits partners only while a lane keeps at least this many


class NNPlan(NamedTuple):
    """One nearest-neighbour launch: a grid of (tiles x cluster, B) blocks
    of NN_THREADS threads. A block takes ``block_queries`` queries of an
    item, NN_QUERIES a thread; its thread t is lane ``t % lanes`` of group
    ``t // lanes``, whose query i is the block's query ``i * groups +
    group``. Rank r of a cluster takes the item's partners ``ranges(m)[r]``,
    and lane s of a group the partners s, s + lanes, ... of that range."""

    lanes: int
    cluster: int
    tiles: int  # clusters along an item's queries
    chunk: int  # partners a rank

    @property
    def groups(self) -> int:
        return NN_THREADS // self.lanes

    @property
    def block_queries(self) -> int:
        return self.groups * NN_QUERIES

    def ranges(self, m: int) -> list[tuple[int, int]]:
        return [(min(r * self.chunk, m), min((r + 1) * self.chunk, m)) for r in range(self.cluster)]


def _ceil(u: int, v: int) -> int:
    return -(-u // v)


def nn_plan(b: int, n: int, m: int, sms: int = 132, lanes: int | None = None,
            cluster: int | None = None) -> NNPlan:
    """The nearest-neighbour launch for a (b, n, 3) cloud searched in a (b,
    m, 3) one on ``sms`` SMs. Lanes first take what a block would leave idle
    (while a block's queries are at least twice the item's); then the
    partners are split over more lanes (up to 32) and then over a cluster of
    up to 8 blocks, until the grid gives every SM a block or a lane would
    keep fewer than NN_MIN_PARTNERS partners. Measured on the H100
    (``chip_smoke.py`` phase (a) times the plans): at the same grid a
    shuffle tree costs less than a cluster, and one or two blocks an SM
    come within a few percent of the fastest plan. ``lanes`` and ``cluster``
    force their part; the kernel refuses a plan it cannot take. The
    constants were fitted to synthetic clouds of 2048 and 8192 points: no
    training or evaluation cloud is above 512 x 512 pairs."""
    lane, size = lanes or 1, cluster or 1

    def partners(lane, size):  # a lane's partners
        return _ceil(_ceil(m, size), lane)

    def blocks(lane, size):
        return b * _ceil(n, NN_THREADS // lane * NN_QUERIES) * size

    def more_lanes(lane, size):
        return lanes is None and lane < 32 and partners(2 * lane, size) >= NN_MIN_PARTNERS

    while more_lanes(lane, size) and NN_THREADS // lane * NN_QUERIES >= 2 * n:
        lane *= 2
    while blocks(lane, size) < sms:
        if more_lanes(lane, size):
            lane *= 2
        elif cluster is None and size < native.MAX_CLUSTER and partners(lane, 2 * size) >= NN_MIN_PARTNERS:
            size *= 2
        else:
            break
    return NNPlan(lane, size, _ceil(n, NN_THREADS // lane * NN_QUERIES), _ceil(m, size))


def nn_directional(a: torch.Tensor, c: torch.Tensor):
    """Nearest neighbour of every point of ``a`` in ``c``; see
    :func:`nn_directional_plain`."""
    if a.device.type == "cpu":
        return nn_directional_plain(a, c)
    _check_clouds(a, c)
    return _launch_nn(a, c, nn_plan(a.shape[0], a.shape[1], c.shape[1], native.sm_count(a.device)))


def _launch_nn(a: torch.Tensor, c: torch.Tensor, plan: NNPlan):
    """One nearest-neighbour launch of checked clouds as ``plan`` shapes it."""
    b, n, _ = a.shape
    mins = torch.empty((b, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        status = native.load().pcuda_chamfer_nn(
            a.data_ptr(), c.data_ptr(), mins.data_ptr(), idx.data_ptr(), b, n, c.shape[1],
            plan.lanes, plan.cluster, plan.tiles, plan.chunk, _stream(a),
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


GRAD_THREADS = 256  # threads of a backward block (csrc/chamfer.cu:kGradThreads)


def backward_lanes(b: int, n: int, device: torch.device) -> int:
    """Threads that share one point in the backward: the smallest power of
    two (at most 32) with which ``b * n`` points give every SM of ``device``
    two blocks of ``GRAD_THREADS`` threads; 16 x 300 points on 132 SMs take
    16. Measured, not derived: the launch's time falls with every doubling up
    to there and stays from there on (``chip_smoke.py`` phase (a) prints the
    time with 1 to 32 threads a point beside this choice)."""
    sms = native.sm_count(device)
    lanes = 1
    while lanes < 32 and b * n * lanes < 2 * sms * GRAD_THREADS:
        lanes *= 2
    return lanes


def _launch_side_grad(a, c, idx_ac, idx_ca, g, lanes: int | None = None):
    """One launch of the backward for cloud ``a``; ``lanes`` (a power of two,
    1..32) defaults to :func:`backward_lanes`. The kernel sums in another
    order for another ``lanes``, so results agree in all but the last bits
    across lane counts and bit for bit for one."""
    _check_clouds(a, c)
    b, n, _ = a.shape
    m = c.shape[1]
    for t, shape in ((idx_ac, (b, n)), (idx_ca, (b, m))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"expected contiguous int32 {shape} indices on {a.device}")
    if lanes is None:
        lanes = backward_lanes(b, n, a.device)
    g = g.to(device=a.device, dtype=torch.float32).reshape(1).contiguous()
    da = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = native.load().pcuda_chamfer_side_grad(
            a.data_ptr(), c.data_ptr(), idx_ac.data_ptr(), idx_ca.data_ptr(), g.data_ptr(),
            da.data_ptr(), b, n, m, lanes, _stream(a),
        )
    native.check(status, "pcuda_chamfer_side_grad")
    side_grad.launches += 1
    return da


def side_grad(a, c, idx_ac, idx_ca, g):
    """See :func:`side_grad_plain`; ``g`` is the loss's upstream gradient
    as a one-element tensor on ``a``'s device (never read on the host)."""
    if a.device.type == "cpu":
        return side_grad_plain(a, c, idx_ac, idx_ca, g)
    return _launch_side_grad(a, c, idx_ac, idx_ca, g)


side_grad.launches = 0


def fused_route(n: int, m: int) -> bool:
    """Whether clouds of n and m points take the fused forward (else the
    two one-direction searches): the TPU package's rule
    (``chamfer_pallas.py:_chamfer_fwd_any``)."""
    return n * m <= SMALL_LIMIT


def _fused_forward_loss(x: torch.Tensor, y: torch.Tensor):
    parts, idx1, idx2 = forward_fused(x, y)
    return parts.sum() / parts.shape[0], idx1, idx2


def _large_forward_loss(x: torch.Tensor, y: torch.Tensor):
    min1, idx1 = nn_directional(x, y)
    min2, idx2 = nn_directional(y, x)
    return torch.mean(torch.sqrt(min1 + EPS)) + torch.mean(torch.sqrt(min2 + EPS)), idx1, idx2


def chamfer_forward(x: torch.Tensor, y: torch.Tensor):
    """(loss, idx1, idx2): the loss and both directions' argmins, on the
    route :func:`fused_route` picks."""
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if fused_route(x.shape[1], y.shape[1]):
        return _fused_forward_loss(x, y)
    return _large_forward_loss(x, y)


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
