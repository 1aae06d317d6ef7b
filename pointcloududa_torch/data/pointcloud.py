"""Point-cloud ground truth: mask -> 300 surface points (counterpart of the
JAX package's ``data/pointcloud.py``, for the host cloud regeneration of
``build_mmwhs_pipelines(..., host_cloud_regen=True)``).

Capability parity with reference ``src/utils/npy2point.py``:
binarise mask -> stack x3 into a pseudo-3D slab -> extract the isosurface ->
farthest-point-sample 300 points -> integer voxel coords (the reference
casts marching-cubes vertices to int at ``npy2point.py:81,124``, collapsing
them onto the voxel grid).

Design deviation (documented): instead of a marching-cubes triangulation
(PyMCubes) we extract *boundary voxels* of the binary slab directly: after
the reference's own int cast the two point sets live on the same voxel
lattice, and only FPS-selected surface samples survive downstream.

numpy only: the JAX package's native host library (``csrc/pcuda_host.cpp``)
is not built here. Its answers are the same: integer coordinates, exact
float64 squared distances, ties broken on the first maximum. The cost is the
reference's own: about 30k boundary voxels searched 300 times a cloud.
"""

from __future__ import annotations

import numpy as np

NUM_POINTS = 300


def farthest_point_sampling(pts: np.ndarray, k: int, seed: int | None = None) -> np.ndarray:
    """Greedy FPS (reference ``graipher``, ``npy2point.py:11-18``): start at
    a random point, iteratively take the point farthest from the chosen set.
    O(k*N) like the reference, vectorised over the points.

    The start index is ``np.random.default_rng(seed).integers(n)``; with
    ``seed=None`` it is ``np.random.randint(n)``, a draw from numpy's GLOBAL
    generator, as in the JAX package (the loader calls it that way): seed
    ``np.random`` alike to reproduce a cloud."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros((k, pts.shape[1] if pts.ndim == 2 else 3))
    start = np.random.randint(n) if seed is None else np.random.default_rng(seed).integers(n)
    out = np.zeros((k, pts.shape[1]), dtype=np.float64)
    out[0] = pts[start]
    d = ((pts - out[0]) ** 2).sum(axis=1)
    for i in range(1, k):
        idx = int(np.argmax(d))
        out[i] = pts[idx]
        d = np.minimum(d, ((pts - out[i]) ** 2).sum(axis=1))
    return out


def boundary_voxels(slab: np.ndarray) -> np.ndarray:
    """(z, y, x) coords of 6-connected surface voxels of a binary 3-D slab,
    in C order."""
    s = slab.astype(bool)
    padded = np.pad(s, 1)
    interior = (
        padded[:-2, 1:-1, 1:-1]
        & padded[2:, 1:-1, 1:-1]
        & padded[1:-1, :-2, 1:-1]
        & padded[1:-1, 2:, 1:-1]
        & padded[1:-1, 1:-1, :-2]
        & padded[1:-1, 1:-1, 2:]
    )
    surface = s & ~interior
    return np.argwhere(surface)


def mask_to_point_cloud(
    mask: np.ndarray,
    number_points: int = NUM_POINTS,
    dim: int = 3,
    fps: bool = True,
    min_mask_sum: int = 50,
    seed: int | None = None,
) -> np.ndarray:
    """(H, W) or (H, W, 1) integer/binary mask -> (number_points, dim) int
    cloud; zeros when the mask has <= ``min_mask_sum`` foreground pixels
    (reference ``npy2point.py:72-73,113-125``). Coordinates are (z, y, x)
    over the x3-stacked slab, exactly the reference's layout."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., 0] if mask.shape[-1] <= 4 else mask[0]
    binary = (mask > 0).astype(np.uint8)
    verts = np.zeros((number_points, dim))
    # threshold on the single-copy sum — the online-regeneration semantics
    # (npy2point_datagenerator checks before stacking, npy2point.py:113-116;
    # the offline variant checks after, a reference-internal inconsistency)
    if int(binary.sum()) > min_mask_sum:
        slab = np.stack([binary, binary, binary], axis=0)
        pts = boundary_voxels(slab)
        if len(pts) > 0:
            if fps:
                verts = farthest_point_sampling(pts.astype(np.float64), number_points, seed=seed)[:, :dim]
            else:
                take = np.resize(np.arange(len(pts)), number_points)
                verts = pts[take][:, :dim]
    return np.asarray(verts, dtype=np.int64).astype(np.float64)
