"""Synthetic data for tests and benchmarks (the port's own copy of the JAX
package's ``pointcloududa_tpu/data/synthetic.py``; numpy only, the same
arrays from the same seed).

SURVEY.md §4 requires the full train step to run without the datasets
(the reference's BASELINE config 1 is "CPU-runnable"); this module fabricates
batches with the exact shapes/dtypes/value-ranges of the real adapters:
images in [0,1], one-hot masks, point clouds in [0,1] (vertices are /255-
normalised voxel coords in the reference, ``data_generator_mscmrseg.py:317``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pointcloududa_torch.config import UDAConfig


def synthetic_batch(cfg: UDAConfig, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One UDA train batch: source image/mask/cloud + target image/cloud."""
    rng = np.random.default_rng(seed)
    hw = cfg.crop_size
    img_s = rng.uniform(size=(batch_size, hw, hw, cfg.in_channels)).astype(np.float32)
    img_t = rng.uniform(size=(batch_size, hw, hw, cfg.in_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.n_class, size=(batch_size, hw, hw))
    mask_s = np.eye(cfg.n_class, dtype=np.float32)[labels]
    batch = {"img_s": img_s, "mask_s": mask_s, "img_t": img_t}
    if cfg.point_head:
        batch["vert_s"] = rng.uniform(size=(batch_size, 300, 3)).astype(np.float32)
        batch["vert_t"] = rng.uniform(size=(batch_size, 300, 3)).astype(np.float32)
    return batch


def synthetic_raw_batch(cfg: UDAConfig, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One RAW host batch as ``data.loader.PairedIterator`` yields it —
    i.e. BEFORE ``train.loop.make_device_preprocess`` (augment, normalise,
    one-hot): uint8 0..255 images for the PNG workload
    (``data_generator_mscmrseg.py:305-310``) / volume-normalised float for
    MM-WHS (``data_generator_mmwhs.py:245-254``), integer label masks, and
    0..255-scale vertex clouds (``:317``)."""
    rng = np.random.default_rng(seed)
    hw = cfg.crop_size
    shape = (batch_size, hw, hw, cfg.in_channels)
    if cfg.workload == "mscmrseg":
        img_s = rng.integers(0, 256, size=shape, dtype=np.uint8)
        img_t = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        img_s = rng.normal(size=shape).astype(np.float32)
        img_t = rng.normal(size=shape).astype(np.float32)
    batch = {
        "img_s": img_s,
        "mask_s": rng.integers(0, cfg.n_class, size=(batch_size, hw, hw), dtype=np.uint8),
        "img_t": img_t,
        "mask_t": rng.integers(0, cfg.n_class, size=(batch_size, hw, hw), dtype=np.uint8),
    }
    if cfg.point_head:
        batch["vert_s"] = (rng.uniform(size=(batch_size, 300, 3)) * 255.0).astype(np.float32)
        batch["vert_t"] = (rng.uniform(size=(batch_size, 300, 3)) * 255.0).astype(np.float32)
    return batch


def synthetic_eval_batch(cfg: UDAConfig, batch_size: int, seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    hw = cfg.crop_size
    img = rng.uniform(size=(batch_size, hw, hw, cfg.in_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.n_class, size=(batch_size, hw, hw))
    mask = np.eye(cfg.n_class, dtype=np.float32)[labels]
    batch = {"img": img, "mask": mask}
    if cfg.point_head:
        batch["vert"] = rng.uniform(size=(batch_size, 300, 3)).astype(np.float32)
    return batch


def synthetic_blob_masks(batch_size: int, size: int, seed: int = 0, n_class: int = 5) -> np.ndarray:
    """(B, size, size) uint8 label masks of ``n_class - 1`` filled ellipses of
    different sizes and places: connected structures with smooth boundaries,
    as anatomy has, where :func:`synthetic_raw_batch` draws every pixel's
    label on its own. Each mask has well over 50 foreground pixels from
    ``size`` 32 up, so a point cloud regenerated from it is not empty."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((batch_size, size, size), np.uint8)
    for i in range(batch_size):
        for label in range(1, n_class):
            cy, cx = rng.uniform(0.3 * size, 0.7 * size, 2)
            ry, rx = rng.uniform(0.08 * size, 0.22 * size, 2)
            out[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = label
    return out
