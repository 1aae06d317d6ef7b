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
"""

from __future__ import annotations

import torch

from pointcloududa_torch.utils import native

NEG = -1e30  # running distance of an invalid candidate


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


@torch.no_grad()
def fps(valid: torch.Tensor, coords: torch.Tensor, starts: torch.Tensor, k: int) -> torch.Tensor:
    """Batched farthest-point sampling; see :func:`fps_plain`. ``coords`` may
    be a broadcast view with batch stride 0 (one grid shared by every cloud):
    the kernel reads it through its stride, no copy is made."""
    if valid.device.type == "cpu":
        return fps_plain(valid, coords, starts, k)
    _check(valid, coords, starts, k)
    if valid.device.type != "cuda":
        raise ValueError(f"the FPS kernel runs on CUDA tensors only, got {valid.device}")
    b, p = valid.shape
    if coords.stride()[1:] != (3, 1):
        coords = coords.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    starts = starts.contiguous()
    dist = torch.empty((b, p), dtype=torch.float32, device=valid.device)  # running distances
    out = torch.empty((b, k, 3), dtype=torch.float32, device=valid.device)
    with torch.cuda.device(valid.device):
        status = native.load().pcuda_fps(
            valid.data_ptr(), coords.data_ptr(), coords.stride(0) if b > 1 else 0, starts.data_ptr(),
            dist.data_ptr(), out.data_ptr(), b, p, k,
            torch.cuda.current_stream(valid.device).cuda_stream,
        )
    native.check(status, "pcuda_fps")
    fps.launches += 1
    return out


fps.launches = 0


def reset_launches() -> None:
    fps.launches = 0
