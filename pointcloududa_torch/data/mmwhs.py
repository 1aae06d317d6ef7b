"""MM-WHS dataset adapter (MR source -> CT target, PnP-AdaNet release; the
port's own copy of the JAX package's ``data/mmwhs.py``: numpy only, ``.npy``
files only).

Decoding parity with reference ``src/data_generator_mmwhs.py:140-274``:
``.npy`` slices (256x256x3 float, pre-normalised volumes), integer masks,
optional histogram matching of every image to a fixed CT reference slice
(``:174-176,236-237``), 5-class one-hot downstream, vertices /255.

When augmentation is on and the point head is enabled, vertex clouds are
regenerated from the *warped* masks (``:256-264``): on the device, by the
preprocess (``train/loop.py``), instead of the reference's per-sample
mcubes+Python-FPS chain on the host.

Directory contract:
  <data_dir>/PnpAda_release_data/{mr,ct}_{train,val}/{img,mask,vertices}/<id>.npy
"""

from __future__ import annotations

import os
from dataclasses import dataclass


import numpy as np


def match_histograms_single(image: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching — EXACT reimplementation of skimage's
    ``match_histograms`` / ``_match_cumulative_cdf`` (which the reference
    imports at ``data_generator_mmwhs.py:9``): per channel, each unique
    source value's cumulative quantile (``cumsum(counts)/size``) is
    interpolated into the template's (quantile -> value) staircase, so tied
    source pixels map to one output value. Pinned by hand-derived goldens
    (``tests/test_data.py::test_match_histograms_goldens``)."""
    out = np.empty_like(image, dtype=np.float64)
    for c in range(image.shape[-1]):
        src = image[..., c].ravel()
        ref = reference[..., c].ravel()
        src_values, src_inverse, src_counts = np.unique(
            src, return_inverse=True, return_counts=True
        )
        tmpl_values, tmpl_counts = np.unique(ref, return_counts=True)
        src_quantiles = np.cumsum(src_counts) / src.size
        tmpl_quantiles = np.cumsum(tmpl_counts) / ref.size
        interp = np.interp(src_quantiles, tmpl_quantiles, tmpl_values)
        out[..., c] = interp[src_inverse].reshape(image.shape[:-1])
    return out


@dataclass
class MMWHSAdapter:
    """Decodes one (img f32 256x256x3, mask int 256x256, vertex f32|None)."""

    data_dir: str
    ids: list
    source: str = "source"  # "source" (MR) | "target" (CT)
    phase: str = "train"
    load_vertices: bool = False
    match_hist: bool = False
    reference_slice: str = "ct_train/img/ct_train_slice0.tfrecords.npy"

    def __post_init__(self):
        assert self.source in ("source", "target")
        assert self.phase in ("train", "valid")
        modality = "mr" if self.source == "source" else "ct"
        split = "train" if self.phase == "train" else "val"
        base = os.path.join(self.data_dir, "PnpAda_release_data", f"{modality}_{split}")
        self._img_dir = os.path.join(base, "img")
        self._mask_dir = os.path.join(base, "mask")
        self._vert_dir = os.path.join(base, "vertices")
        self._ref_img = None
        if self.match_hist:
            self._ref_img = np.load(
                os.path.join(self.data_dir, "PnpAda_release_data", self.reference_slice)
            )

    def __len__(self):
        return len(self.ids)

    def __call__(self, index: int):
        _id = self.ids[index]
        img = np.load(os.path.join(self._img_dir, f"{_id}.npy")).astype(np.float32)
        mask = np.load(os.path.join(self._mask_dir, f"{_id}.npy")).astype(np.int32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        if self._ref_img is not None:
            img = match_histograms_single(img, self._ref_img).astype(np.float32)
        vert = None
        if self.load_vertices:
            vert = np.load(os.path.join(self._vert_dir, f"{_id}.npy")).astype(np.float32)
        return img, mask, vert
