"""Point-cloud ground truth: mask -> 300 surface points (counterpart of the
JAX package's ``data/pointcloud.py``: the vertex files of ``prep/`` and the
host cloud regeneration of ``build_mmwhs_pipelines(..., host_cloud_regen=True)``).

Capability parity with reference ``src/utils/npy2point.py``:
binarise mask -> stack x3 into a pseudo-3D slab -> extract the isosurface ->
farthest-point-sample 300 points -> integer voxel coords (the reference
casts marching-cubes vertices to int at ``npy2point.py:81,124``, collapsing
them onto the voxel grid).

Design deviation (documented): instead of a marching-cubes triangulation
(PyMCubes) we extract *boundary voxels* of the binary slab directly: after
the reference's own int cast the two point sets live on the same voxel
lattice, and only FPS-selected surface samples survive downstream.

FPS and the boundary voxels run in the port's host library
(``utils/host_native.py`` over ``csrc/pcuda_host.cpp``, a copy of the JAX
package's), as the JAX package runs them in its own; there is no numpy
fallback. The numpy bodies stay as ``*_plain`` for the tests: both give the
same clouds bit for bit (integer coordinates, exact float64 squared
distances, ties broken on the first maximum, voxels in C order).
"""

from __future__ import annotations

import numpy as np

from pointcloududa_torch.utils import host_native

NUM_POINTS = 300


def _start(n: int, seed: int | None) -> int:
    """The start index: ``np.random.default_rng(seed).integers(n)``; with
    ``seed=None`` ``np.random.randint(n)``, a draw from numpy's GLOBAL
    generator, as in the JAX package (the loader calls it that way): seed
    ``np.random`` alike to reproduce a cloud."""
    return int(np.random.randint(n) if seed is None else np.random.default_rng(seed).integers(n))


def farthest_point_sampling(pts: np.ndarray, k: int, seed: int | None = None) -> np.ndarray:
    """Greedy FPS (reference ``graipher``, ``npy2point.py:11-18``): start at
    a random point (``_start``), iteratively take the point farthest from the
    chosen set; O(k*N) in the host library."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros((k, pts.shape[1] if pts.ndim == 2 else 3))
    return host_native.fps(pts, k, _start(n, seed))


def farthest_point_sampling_plain(pts: np.ndarray, k: int, seed: int | None = None) -> np.ndarray:
    """``farthest_point_sampling`` in numpy, vectorised over the points (the
    tests' reference)."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros((k, pts.shape[1] if pts.ndim == 2 else 3))
    start = _start(n, seed)
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
    in C order, from the host library."""
    return host_native.boundary_voxels(slab)


def boundary_voxels_plain(slab: np.ndarray) -> np.ndarray:
    """``boundary_voxels`` in numpy (the tests' reference)."""
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
