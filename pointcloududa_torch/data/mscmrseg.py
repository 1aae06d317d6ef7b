"""MS-CMRSeg dataset adapter (bSSFP source -> LGE target; the port's own copy
of the JAX package's ``data/mscmrseg.py``, but for the PNG decoder:
``utils/png.py`` reads the files as ``cv2.imread`` does, without OpenCV).

Decoding parity with reference ``src/data_generator_mscmrseg.py:186-319``:
PNG slices (3-channel, BGR, as cv2 reads them), grayscale masks with values
{0, 85, 212, 255} -> {0, 1, 2, 3} (``:262-265``), precomputed 300x3 vertex
``.npy`` files; images /255-normalised AFTER augmentation, centre-cropped to
``crop_size``; vertices /255 (``:305-317``).

Directory contract (same as the reference):
  <data_dir>/processed/{trainA,trainAmask,testA,testAmask,trainB,trainBmask,
                        trainB_orig,trainBmask_orig}/<id>.png
  <data_dir>/vertices/{trainA,testA,trainB,trainB_orig}/<id>.npy

Unlike the reference — which interleaves file IO, augmentation and batching
in one ``__next__`` — this adapter only decodes one record; batching is the
sampler's job and augmentation runs on device (ops/augment.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


import numpy as np

from pointcloududa_torch.utils.png import IMREAD_GRAYSCALE, read_png

_MASK_LUT = None


def decode_mask_values(mask: np.ndarray) -> np.ndarray:
    """{0,85,212,255} -> {0,1,2,3} via a 256-entry LUT (single gather)."""
    global _MASK_LUT
    if _MASK_LUT is None:
        lut = np.arange(256, dtype=np.uint8)
        lut[85], lut[212], lut[255] = 1, 2, 3
        _MASK_LUT = lut
    return _MASK_LUT[mask]


@dataclass
class MSCMRSegAdapter:
    """Decodes one (img uint8 HxWx3, mask uint8 HxW, vertex f32 300x3)."""

    data_dir: str
    ids: list
    source: str = "source"  # "source" (bSSFP) | "target" (LGE)
    phase: str = "train"
    load_vertices: bool = True

    def __post_init__(self):
        assert self.source in ("source", "target")
        assert self.phase in ("train", "valid")
        if self.source == "source":
            sub = ("trainA", "trainAmask", "trainA") if self.phase == "train" else ("testA", "testAmask", "testA")
        else:
            sub = (
                ("trainB", "trainBmask", "trainB")
                if self.phase == "train"
                else ("trainB_orig", "trainBmask_orig", "trainB_orig")
            )
        self._img_dir = os.path.join(self.data_dir, "processed", sub[0])
        self._mask_dir = os.path.join(self.data_dir, "processed", sub[1])
        self._vert_dir = os.path.join(self.data_dir, "vertices", sub[2])

    def __len__(self):
        return len(self.ids)

    def __call__(self, index: int):
        _id = self.ids[index]
        img = read_png(os.path.join(self._img_dir, f"{_id}.png"))  # BGR uint8, 3ch; a missing file raises
        mask = read_png(os.path.join(self._mask_dir, f"{_id}.png"), IMREAD_GRAYSCALE)
        mask = decode_mask_values(mask)
        vert = None
        if self.load_vertices:
            vert = np.load(os.path.join(self._vert_dir, f"{_id}.npy")).astype(np.float32)
        return img, mask, vert
