"""Device-side point-cloud ground truth: warped mask -> 300 surface points,
entirely on the accelerator (counterpart of
``pointcloududa_tpu/ops/pointcloud_device.py``).

The reference regenerates vertex clouds from augmented masks on the host,
per sample, per step (mcubes + Python FPS, ``data_generator_mmwhs.py:
256-264``). Here the same cloud contract as the host-side version is computed with
batched tensor ops and the farthest-point-sampling kernel, so augmentation
and cloud regeneration both stay in the device preprocess.

Geometry of the reference's clouds (binary mask stacked x3 into a slab,
surface voxels, int-cast coords): the slab's z=0 and z=2 faces are entirely
surface (every foreground voxel), and the middle slice contributes its
4-connected 2-D boundary. Farthest-point sampling is the greedy algorithm of
``graipher`` (``npy2point.py:11-18``) over that candidate grid
(``ops/fps_kernel.py``).

Empty or small masks (``<= min_mask_sum`` foreground pixels) yield a zero
cloud (``npy2point.py:113-116``) through a mask, not control flow, so nothing
is read back to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointcloududa_torch.ops import fps_kernel

NUM_POINTS = 300


def _interior4(mask: torch.Tensor) -> torch.Tensor:
    """4-connected interior of binary (..., H, W) masks."""
    m = F.pad(mask, (1, 1, 1, 1))
    return mask & m[..., :-2, 1:-1] & m[..., 2:, 1:-1] & m[..., 1:-1, :-2] & m[..., 1:-1, 2:]


def candidates(masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, 3*H*W) bool: the z=0 face (all foreground), the
    z=1 boundary ring, the z=2 face (all foreground)."""
    b = masks.shape[0]
    flat = masks.reshape(b, -1)
    ring = (masks & ~_interior4(masks)).reshape(b, -1)
    return torch.cat([flat, ring, flat], dim=1)


def grid_coords(h: int, w: int, device) -> torch.Tensor:
    """(3*H*W, 3) f32 (z, y, x) voxel coordinates of the candidate grid."""
    yy = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w)
    xx = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    zs = torch.arange(3, dtype=torch.float32, device=device).repeat_interleave(h * w)
    return torch.stack([zs, yy.repeat(3), xx.repeat(3)], dim=-1)


def _fps(impl: str):
    """``"auto"``: the wrapper, which launches the kernel for CUDA tensors
    and takes the plain version for CPU tensors; ``"plain"``: the plain
    version wherever the tensors lie (what the checks on the card hold the
    kernel against)."""
    if impl == "auto":
        return fps_kernel.fps
    if impl == "plain":
        return fps_kernel.fps_plain
    raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


@torch.no_grad()
def masks_to_point_clouds_from_starts(
    masks: torch.Tensor,
    starts: torch.Tensor,
    number_points: int = NUM_POINTS,
    min_mask_sum: int = 50,
    impl: str = "auto",
) -> torch.Tensor:
    """Everything after the random draw: (B, H, W) integer masks and the (B,)
    int32 index of each cloud's first point in its candidate grid ->
    (B, number_points, 3) f32 clouds of (z, y, x) voxel coordinates."""
    masks = masks > 0
    b, h, w = masks.shape
    cand = candidates(masks)
    coords = grid_coords(h, w, masks.device)
    nonempty = torch.sum(masks.reshape(b, -1), dim=1) > min_mask_sum
    clouds = _fps(impl)(cand, coords.expand(b, -1, -1), starts, number_points)
    return torch.where(nonempty[:, None, None], clouds, torch.zeros((), dtype=clouds.dtype, device=clouds.device))


@torch.no_grad()
def draw_starts(masks: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A uniformly random candidate per mask, as the argmax of
    ``uniform + 2 * candidate`` (any index when a mask has no candidate: its
    cloud is zeroed afterwards)."""
    cand = candidates(masks > 0)
    score = torch.rand(cand.shape, generator=generator, device=cand.device) + 2.0 * cand.to(torch.float32)
    return torch.argmax(score, dim=1).to(torch.int32)


def masks_to_point_clouds(
    masks: torch.Tensor,
    generator: torch.Generator,
    number_points: int = NUM_POINTS,
    min_mask_sum: int = 50,
    impl: str = "auto",
) -> torch.Tensor:
    """(B, H, W) integer masks -> (B, number_points, 3) float clouds with
    (z, y, x) voxel coords over the x3 slab. The work runs where ``masks``
    lies; ``generator`` must be on that device. ``impl="auto"`` launches the
    FPS kernel for CUDA tensors and takes its plain version for CPU tensors;
    ``"plain"`` takes the plain version anywhere."""
    starts = draw_starts(masks, generator)
    return masks_to_point_clouds_from_starts(masks, starts, number_points, min_mask_sum, impl)
