"""Farthest-point sampling in plain PyTorch: the port's
``ops/fps_kernel.py:fps_plain`` (frozen), where the port launches
``csrc/fps.cu``."""

from __future__ import annotations

import torch

NEG = -1e30  # the running distance of an invalid candidate


@torch.no_grad()
def fps_plain(valid: torch.Tensor, coords: torch.Tensor, starts: torch.Tensor, k: int) -> torch.Tensor:
    """``valid`` (B, P) bool/uint8, ``coords`` (B, P, 3) f32 (a broadcast
    view is fine), ``starts`` (B,) int32 -> (B, k, 3) f32; ties go to the
    lowest index."""
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
