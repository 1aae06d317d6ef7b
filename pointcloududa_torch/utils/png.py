"""PNG reading and writing with zlib, struct and numpy only.

:func:`read_png` returns what ``cv2.imread`` returns for the 8-bit,
non-interlaced grey, RGB and RGBA PNGs that the MS-CMRSeg preparation writes
(``cv2.imwrite``), so the dataset adapter decodes the same arrays on a machine
without OpenCV. Every other kind of PNG (16-bit, palette, grey with alpha,
interlaced) raises ``ValueError``.

:func:`write_png` writes an array in ``cv2.imwrite``'s channel order with a
chosen scanline filter; it fabricates datasets and test files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

IMREAD_GRAYSCALE = 0  # the values of cv2's flags of the same names
IMREAD_COLOR = 1

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel: grey, RGB, RGBA
# libpng's 8-bit RGB -> grey weights in 1/32768, truncated from the 0.299 and
# 0.587 that OpenCV asks for under IMREAD_GRAYSCALE; blue takes the rest, and
# the weighted sum is truncated too
_GREY_R, _GREY_G = 9797, 19234
_GREY_B = 32768 - _GREY_R - _GREY_G


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five scanline filters: (h, 1 + stride) bytes -> (h, stride).
    Rows filtered None or Sub depend on no other row and are undone all at
    once (OpenCV writes Sub only); Up, Average and Paeth rows depend on the
    row above and are undone in order after them."""
    rows = raw.reshape(h, 1 + stride)
    kinds, data = rows[:, 0], rows[:, 1:]
    if (kinds > 4).any():
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = data.copy()
    sub = kinds == 1
    if sub.any():  # Sub: a running sum along the row, one per byte of a pixel
        out[sub] = np.cumsum(data[sub].reshape(-1, stride // bpp, bpp), axis=1, dtype=np.uint8).reshape(-1, stride)
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(kinds >= 2):
        line, kind, prev = data[y], int(kinds[y]), out[y - 1] if y else zero
        if kind == 2:  # Up
            out[y] = line + prev
            continue
        x, b = line.tolist(), prev.tolist()  # Average and Paeth depend on the byte to the left: byte by byte
        r = [0] * stride
        for i in range(stride):
            a = r[i - bpp] if i >= bpp else 0
            if kind == 3:
                r[i] = (x[i] + ((a + b[i]) >> 1)) & 255
            else:
                r[i] = (x[i] + _paeth(a, b[i], b[i - bpp] if i >= bpp else 0)) & 255
        out[y] = r
    return out


def read_png(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Decode a PNG file as ``cv2.imread(path, flags)`` does: under
    ``IMREAD_COLOR`` an (H, W, 3) uint8 array in BGR order (grey repeated into
    the three channels, alpha dropped); under ``IMREAD_GRAYSCALE`` (H, W)
    uint8 (colour weighted to grey as libpng does for OpenCV). A missing file
    raises ``FileNotFoundError``."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"flags={flags}: only IMREAD_COLOR (1) and IMREAD_GRAYSCALE (0)")
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, interlace {interlace}; "
                         "only 8-bit non-interlaced grey, RGB and RGBA are read")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (1 + w * ch)}")
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if flags == IMREAD_GRAYSCALE:
        if ch == 1:
            return img[..., 0]
        rgb = img[..., :3].astype(np.uint32)
        return ((_GREY_R * rgb[..., 0] + _GREY_G * rgb[..., 1] + _GREY_B * rgb[..., 2]) >> 15).astype(np.uint8)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def _filter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    x, b = line.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, array: np.ndarray, filters=1) -> None:
    """Write ``array`` as an 8-bit PNG in ``cv2.imwrite``'s convention: (H, W)
    grey, (H, W, 3) BGR or (H, W, 4) BGRA uint8. ``filters``: the scanline
    filter of every row (0 none, 1 sub, 2 up, 3 average, 4 Paeth), or a
    sequence that is cycled over the rows (OpenCV writes sub)."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (3, 4)):
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4) uint8, not {a.shape} {a.dtype}")
    if a.ndim == 2:
        a, ctype = a[..., None], 0
    else:
        a, ctype = np.concatenate([a[..., 2::-1], a[..., 3:]], axis=2), {3: 2, 4: 6}[a.shape[2]]
    h, w, ch = a.shape
    kinds = [filters] if isinstance(filters, int) else list(filters)
    rows, prev = [], np.zeros(w * ch, np.uint8)
    for y in range(h):
        line = a[y].reshape(-1)
        kind = kinds[y % len(kinds)]
        rows.append(bytes([kind]) + _filter_row(kind, line, prev, ch).tobytes())
        prev = line
    body = _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    body += _chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(body)
