"""Greedy farthest-point sampling through the hand-written CUDA kernel of
``csrc/fps.cu``, the counterpart of ``pointcloududa_tpu/ops/fps_pallas.py``.

:func:`fps` picks ``k`` of ``P`` candidate points per cloud: point 0 is
``coords[start]``; every later point is the valid candidate farthest from the
points chosen so far (the argmax of the running minimum squared distance,
ties at the lowest index; an invalid candidate's distance is ``-1e30``). When
fewer than ``k`` candidates are valid the remaining picks repeat the lowest
valid index, whose distance is 0. The clouds are targets, so there is no
gradient.

The wrapper launches its kernel for a CUDA tensor, or raises, and counts the
launch in ``fps.launches``. Only a CPU tensor takes the plain PyTorch version
beside it (:func:`fps_plain`).

The kernel runs one thread-block cluster per cloud and keeps each block's
valid candidates in shared memory; :func:`launch_geometry` says how a launch
is shaped (cluster size, shared-memory bytes, capacity in candidates, and the
scratch row for what exceeds it). A block takes a whole SM, so the cluster is
the largest of which the device runs the whole batch at once
(``native.cluster_size``): no cloud waits for a second wave.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloududa_torch.utils import native

NEG = -1e30  # running distance of an invalid candidate
CHUNK = 1024  # original indices dealt to one block at a time (the kernel's block size)
BYTES_PER_CANDIDATE = 20  # z, y, x, running distance, original index

_device_capacity: dict[int, int] = {}  # device index -> candidates one block's shared memory holds


def _check(valid: torch.Tensor, coords: torch.Tensor, starts: torch.Tensor, k: int) -> None:
    if valid.dim() != 2 or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"expected (B, P) bool/uint8 validity, got {valid.dtype} {tuple(valid.shape)}")
    b, p = valid.shape
    if coords.dtype != torch.float32 or tuple(coords.shape) != (b, p, 3):
        raise ValueError(f"expected float32 ({b}, {p}, 3) coordinates, got {coords.dtype} {tuple(coords.shape)}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (b,):
        raise ValueError(f"expected int32 ({b},) start indices, got {starts.dtype} {tuple(starts.shape)}")
    if not (valid.device == coords.device == starts.device):
        raise ValueError("validity, coordinates and starts must share a device")
    if not (1 <= b <= 65535 and 1 <= p < 2**31 // 3 and k >= 1):
        raise ValueError(f"unsupported FPS problem: B={b}, P={p}, k={k}")


@torch.no_grad()
def fps_plain(valid: torch.Tensor, coords: torch.Tensor, starts: torch.Tensor, k: int) -> torch.Tensor:
    """``valid`` (B, P) bool/uint8, ``coords`` (B, P, 3) f32 (a broadcast
    view is fine), ``starts`` (B,) int32 -> (B, k, 3) f32. ``torch.argmax``
    promises no tie rule, so the lowest index of the maximum is taken
    explicitly."""
    _check(valid, coords, starts, k)
    b, p = valid.shape
    valid = valid.bool()
    arange = torch.arange(p, device=valid.device)
    items = torch.arange(b, device=valid.device)
    neg = torch.full((), NEG, dtype=torch.float32, device=valid.device)
    out = torch.empty((b, k, 3), dtype=torch.float32, device=valid.device)
    idx = starts.long().clamp(0, p - 1)
    dist = None
    for i in range(k):
        pt = coords[items, idx]  # (B, 3)
        out[:, i] = pt
        if i == k - 1:
            break
        dz, dy, dx = (coords - pt[:, None, :]).unbind(-1)
        nd = dz * dz + dy * dy + dx * dx
        dist = torch.where(valid, nd if dist is None else torch.minimum(dist, nd), neg)
        top = torch.amax(dist, dim=1, keepdim=True)
        idx = torch.amin(torch.where(dist == top, arange, p), dim=1)
    return out


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def device_capacity(device: torch.device) -> int:
    """Candidates that one block's shared memory holds on ``device``, a whole
    number of block-wide passes. The first call per device also lets the
    kernel use that much dynamic shared memory, which must happen outside a
    CUDA-graph capture: call :func:`fps` once before capturing it."""
    index = _index(device)
    if index not in _device_capacity:
        capacity = ctypes.c_int(0)
        with torch.cuda.device(index):
            status = native.load().pcuda_fps_configure(ctypes.byref(capacity))
        native.check(status, "pcuda_fps_configure")
        _device_capacity[index] = capacity.value // CHUNK * CHUNK
    return _device_capacity[index]


def launch_geometry(b: int, p: int, device: torch.device, capacity: int | None = None, cluster: int | None = None) -> dict:
    """How a launch over ``b`` clouds of ``p`` candidates is shaped. The ``p``
    indices are dealt to the ``cluster`` blocks of a cloud in chunks of
    ``CHUNK``, round-robin; ``dealt`` is the most one block can get. A block
    keeps ``capacity`` valid candidates in ``shared_bytes`` of shared memory
    (all it can be dealt, or all the device allows) and up to ``overflow``
    more in its row of a global scratch buffer. ``capacity`` overrides the
    choice (the tests force the overflow branch and a refused launch with it),
    ``cluster`` the blocks per cloud (to time a size the device runs in waves)."""
    if cluster is None:
        cluster = native.cluster_size(b, device)
    chunks = -(-p // CHUNK)
    dealt = -(-chunks // cluster) * CHUNK
    if capacity is None:
        capacity = min(dealt, device_capacity(device))
    if capacity < CHUNK or capacity % CHUNK:
        raise ValueError(f"capacity must be a positive multiple of {CHUNK}, got {capacity}")
    return dict(
        cluster=cluster, threads=CHUNK, dealt=dealt, capacity=capacity, shared_bytes=capacity * BYTES_PER_CANDIDATE,
        overflow=max(0, dealt - capacity), clusters_at_once=native.max_active_clusters(cluster, device),
    )


def _launch(valid, coords, starts, k: int, capacity: int | None = None, cluster: int | None = None) -> torch.Tensor:
    _check(valid, coords, starts, k)
    if valid.device.type != "cuda":
        raise ValueError(f"the FPS kernel runs on CUDA tensors only, got {valid.device}")
    b, p = valid.shape
    if coords.stride()[1:] != (3, 1):
        coords = coords.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    starts = starts.contiguous()
    geometry = launch_geometry(b, p, valid.device, capacity, cluster)
    # a block's candidates beyond its shared memory: five words each, like the resident ones
    words = b * geometry["cluster"] * 5 * geometry["overflow"]
    scratch = torch.empty(max(1, words), dtype=torch.float32, device=valid.device)
    out = torch.empty((b, k, 3), dtype=torch.float32, device=valid.device)
    with torch.cuda.device(valid.device):
        status = native.load().pcuda_fps(
            valid.data_ptr(), coords.data_ptr(), coords.stride(0) if b > 1 else 0, starts.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, p, k, geometry["capacity"], geometry["overflow"], geometry["cluster"],
            torch.cuda.current_stream(valid.device).cuda_stream,
        )
    native.check(status, "pcuda_fps")
    fps.launches += 1
    return out


@torch.no_grad()
def fps(valid: torch.Tensor, coords: torch.Tensor, starts: torch.Tensor, k: int) -> torch.Tensor:
    """Batched farthest-point sampling; see :func:`fps_plain`. ``coords`` may
    be a broadcast view with batch stride 0 (one grid shared by every cloud):
    the kernel reads it through its stride, no copy is made."""
    if valid.device.type == "cpu":
        return fps_plain(valid, coords, starts, k)
    return _launch(valid, coords, starts, k)


fps.launches = 0


def reset_launches() -> None:
    fps.launches = 0
