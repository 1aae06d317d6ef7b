"""Contrast-limited adaptive histogram equalisation of uint8 planes in numpy,
equal bit for bit to ``cv2.createCLAHE(clipLimit, (tiles, tiles)).apply``
(``modules/imgproc/src/clahe.cpp``), which the JAX package's evaluation
calls: the port does not depend on OpenCV, which GPU hosts may lack.

OpenCV's steps, each reproduced:
- a plane whose sides are not multiples of the tile grid is first padded at
  the bottom and right with ``BORDER_REFLECT_101`` by ``tiles - side %
  tiles`` on BOTH axes (a whole extra tile row where a side divides);
- per tile, a 256-bin histogram clipped at the integer limit
  ``max(int(clip * tile_area / 256), 1)``; the clipped excess is spread
  evenly over the bins, and what is left over adds one to every
  ``max(256 // residual, 1)``-th bin from bin 0;
- the tile's LUT is the cumulative histogram times ``255 / tile_area`` in
  float32, rounded half to even;
- each pixel of the unpadded plane blends the LUTs of its four nearest tile
  centres bilinearly in float32, in OpenCV's order of operations, and rounds.
"""

from __future__ import annotations

import numpy as np


def _tile_luts(ext: np.ndarray, tiles: int, clip_limit: float) -> tuple:
    th, tw = ext.shape[0] // tiles, ext.shape[1] // tiles
    area = th * tw
    blocks = ext.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(tiles * tiles, area)
    offsets = (np.arange(tiles * tiles) * 256)[:, None]
    hist = np.bincount((blocks + offsets).ravel(), minlength=tiles * tiles * 256).reshape(tiles * tiles, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(axis=1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        for k, residual in enumerate(clipped % 256):
            if residual:
                hist[k, ::max(256 // int(residual), 1)][: int(residual)] += 1
    scale = np.float32(255) / np.float32(area)
    lut = np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8).reshape(tiles, tiles, 256), th, tw


def _neighbours(n: int, tile: int, tiles: int):
    """For each of n pixel positions: the lower and upper tile, and the
    float32 weights of each (``x * (1 / tile) - 0.5``, as OpenCV)."""
    pos = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(tile)) - np.float32(0.5)
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo.astype(np.float32)
    return np.maximum(lo, 0), np.minimum(lo + 1, tiles - 1), np.float32(1.0) - frac, frac


def clahe(plane: np.ndarray, clip_limit: float = 4.0, tiles: int = 8) -> np.ndarray:
    """CLAHE of one (H, W) uint8 plane; returns a uint8 plane of its shape."""
    img = np.asarray(plane, np.uint8)
    h, w = img.shape
    ext = img
    if h % tiles or w % tiles:
        ext = np.pad(img, ((0, tiles - h % tiles), (0, tiles - w % tiles)), mode="reflect")  # reflect = REFLECT_101
    lut, th, tw = _tile_luts(ext, tiles, clip_limit)
    y1, y2, ya1, ya = _neighbours(h, th, tiles)
    x1, x2, xa1, xa = _neighbours(w, tw, tiles)
    v = img.astype(np.int64)
    y1, y2, ya1, ya = y1[:, None], y2[:, None], ya1[:, None], ya[:, None]

    def at(ty, tx):
        return lut[ty, tx, v].astype(np.float32)

    res = (at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1 + (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
