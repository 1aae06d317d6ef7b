"""Minimal self-contained NIfTI-1 reader/writer (nibabel equivalent for the
paths this framework needs): the port's own copy of the JAX package's
``utils/nifti.py`` (numpy, gzip and struct only), held equal to it by
``tests/test_torch_port_imports.py``.

The reference calls ``nibabel.load`` via ``utils.load_nii``
(``src/utils/utils.py:68-80``) to read ground-truth volumes during
evaluation. nibabel is not available in this image, so this implements the
NIfTI-1 header contract directly: dims, datatype, scl_slope/inter, and the
sform/qform affine. Data is returned in Fortran order like nibabel
(``get_data`` -> (X, Y, Z) with the fastest-varying axis first).
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_nii(img_path: str) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns (data, affine, header-dict) — the reference ``load_nii``
    contract (``utils.py:68-80``)."""
    with _open(img_path) as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"truncated NIfTI header in {img_path}")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"not a NIfTI-1 file: {img_path}")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        bitpix = struct.unpack(endian + "h", hdr[72:74])[0]
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
        qform_code = struct.unpack(endian + "h", hdr[252:254])[0]
        srow = np.array(struct.unpack(endian + "12f", hdr[280:328])).reshape(3, 4)
        magic = hdr[344:348]
        if not (magic.startswith(b"n+1") or magic.startswith(b"ni1")):
            raise ValueError(f"bad NIfTI magic in {img_path}")
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        if datatype not in _DTYPES:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
        data = data.reshape(shape, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            data = data * slope + scl_inter
        affine = np.eye(4)
        if sform_code > 0:
            affine[:3, :] = srow
        elif qform_code == 0:
            # fallback: scale by pixdim (nibabel's base affine)
            affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]
        header = {
            "dim": dim,
            "pixdim": pixdim,
            "datatype": datatype,
            "bitpix": bitpix,
            "sform_code": sform_code,
            "qform_code": qform_code,
        }
        return np.asarray(data), affine, header


def save_nii(img_path: str, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a minimal NIfTI-1 single file (n+1, little-endian)."""
    data = np.asarray(data)
    code = _CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    affine = np.eye(4) if affine is None else np.asarray(affine)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"
    with _open(img_path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asarray(data, order="F").tobytes(order="F"))
