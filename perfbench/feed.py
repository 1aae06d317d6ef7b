"""Traffic: the pool of raw host batches a cell trains on, made from the
seed, and the feed that hands them to ``UDATrainer.train_epoch``.

One general generator reads a traffic file (``perfbench/traffic/<mix>.json``);
a mix is data only. A raw batch is what the port's loader
(``data/loader.py:PairedIterator``) yields: source and target images (uint8
0..255 for MS-CMRSeg, volume-normalised float32 for MM-WHS) at the raw size,
integer label masks of both domains, and 300-point clouds on the 0..255 voxel
grid. Masks are seeded blobs (``blob_masks``, a copy of the port's
``data/synthetic.py:synthetic_blob_masks``): connected structures with smooth
boundaries, as anatomy has, so the augmentation and FPS do the work real
slices give them. Images are a per-class intensity plus noise; clouds are
points of each mask's foreground.
"""

from __future__ import annotations

import time

import numpy as np


def blob_masks(rng: np.random.Generator, batch_size: int, size: int, n_class: int) -> np.ndarray:
    """(B, size, size) uint8 label masks of ``n_class - 1`` filled ellipses of
    different sizes and places, a later label drawn over an earlier one."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    out = np.zeros((batch_size, size, size), np.uint8)
    draws = rng.uniform(size=(batch_size, n_class - 1, 4)).astype(np.float32)
    for label in range(1, n_class):
        cy, cx = (0.3 + 0.4 * draws[:, label - 1, :2].T) * size
        ry, rx = (0.08 + 0.14 * draws[:, label - 1, 2:].T) * size
        inside = ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2 + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2 <= 1.0
        out[inside] = label
    return out


def images(rng: np.random.Generator, masks: np.ndarray, channels: int, workload: str, noise: float) -> np.ndarray:
    """A per-class intensity (drawn per sample) plus Gaussian noise, in the
    workload's raw format."""
    b, n_class = masks.shape[0], int(masks.max()) + 1
    levels = rng.uniform(20.0, 235.0, size=(b, max(n_class, 2))).astype(np.float32)
    base = np.take_along_axis(levels, masks.reshape(b, -1).astype(np.int64), axis=1).reshape(masks.shape)
    img = base[..., None] + noise * rng.standard_normal(size=masks.shape + (channels,), dtype=np.float32)
    if workload == "mscmrseg":
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    flat = img.reshape(b, -1)
    return ((img - flat.mean(1)[:, None, None, None]) / flat.std(1)[:, None, None, None]).astype(np.float32)


def clouds(rng: np.random.Generator, masks: np.ndarray, points: int) -> np.ndarray:
    """(B, points, 3) float32 (z, y, x) clouds on the 0..255 grid: foreground
    pixels of each mask on a 3-slice slab, drawn with replacement."""
    out = np.zeros((masks.shape[0], points, 3), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        pick = rng.integers(0, len(ys), size=points)
        out[i, :, 0] = rng.integers(0, 3, size=points)
        out[i, :, 1] = ys[pick] * (255.0 / (m.shape[0] - 1))
        out[i, :, 2] = xs[pick] * (255.0 / (m.shape[1] - 1))
    return out


def make_pool(shape: dict, traffic: dict, seed: int) -> list:
    """``traffic["pool_batches"]`` raw batches of ``shape["bs"]`` samples,
    every one different, from ``seed``. ``shape``: ``workload``, ``bs``,
    ``raw_size``, ``channels``, ``n_class``, ``points``."""
    rng = np.random.default_rng(int(seed))
    pool = []
    for _ in range(int(traffic["pool_batches"])):
        batch = {}
        for dom in ("s", "t"):
            masks = blob_masks(rng, shape["bs"], shape["raw_size"], shape["n_class"])
            batch[f"img_{dom}"] = images(rng, masks, shape["channels"], shape["workload"], float(traffic["noise"]))
            batch[f"mask_{dom}"] = masks
            batch[f"vert_{dom}"] = clouds(rng, masks, shape["points"])
        pool.append(batch)
    return pool


class Feed:
    """The trainer's ``train_iter``: ``epoch()`` cycles the pool from where
    the last epoch stopped, until ``limit`` batches were handed out, the
    host clock passes ``deadline`` or ``stop`` is set (checked as each
    batch is asked for)."""

    def __init__(self, pool: list):
        self.pool = pool
        self.steps_per_epoch = len(pool)
        self.cursor = 0
        self.limit = None
        self.deadline = None
        self.stop = False

    def epoch(self):
        n = 0
        while not self.stop:
            if self.limit is not None and n >= self.limit:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            yield self.pool[self.cursor % len(self.pool)]
            self.cursor += 1
            n += 1
