"""The port's PNG reader (``pointcloududa_torch/utils/png.py``) against
``cv2.imread``, on PNGs in every colour type the MS-CMRSeg preparation writes
and with every scanline filter; and the rule that no module of the port
imports OpenCV or PIL (the card's machine has neither).

``cv2`` here is the oracle only: the arrays must be **equal**, dtype and shape
included.
"""

import ast
import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from pointcloududa_torch.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"grey": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4)}
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "all five": (0, 1, 2, 3, 4)}


def _image(kind, seed=0):
    """Noise with flat patches and a gradient, so that every filter sees
    runs, ramps and wraps past 255."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, SHAPES[kind], dtype=np.uint8)
    a[:10, :20] = 200
    a[20:] = (np.arange(53, dtype=np.uint8) * 9)[None, :, None][..., :a.shape[2]] if a.ndim == 3 else np.arange(53) * 9
    return a


@pytest.mark.parametrize("filters", FILTERS.values(), ids=FILTERS.keys())
@pytest.mark.parametrize("kind", SHAPES)
def test_read_png_equals_cv2_imread(kind, filters, tmp_path):
    path = str(tmp_path / "x.png")
    png.write_png(path, _image(kind), filters)
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        want, got = cv2.imread(path, flag), png.read_png(path, flag)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, (flag, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"flag {flag}")


@pytest.mark.parametrize("kind", SHAPES)
def test_read_png_reads_what_cv2_writes(kind, tmp_path):
    """cv2.imwrite's own files (its Sub filter and zlib settings) and the
    adapter's default flag."""
    path = str(tmp_path / "x.png")
    a = _image(kind, seed=1)
    cv2.imwrite(path, a)
    np.testing.assert_array_equal(png.read_png(path), cv2.imread(path))
    np.testing.assert_array_equal(png.read_png(path, png.IMREAD_GRAYSCALE), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert (png.IMREAD_COLOR, png.IMREAD_GRAYSCALE) == (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)
    if a.ndim == 3:
        np.testing.assert_array_equal(png.read_png(path)[..., :3], a[..., :3])  # BGR in, BGR out


def _png_with_header(path, w, h, depth, ctype, interlace):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    body = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    with open(path, "wb") as f:
        f.write(body + chunk(b"IDAT", zlib.compress(b"\0" * (h * (1 + w)))) + chunk(b"IEND", b""))


def test_what_is_not_read_raises(tmp_path):
    """16-bit, palette and interlaced PNGs, a file that is not a PNG, a flag
    other than colour and grey, and a missing file."""
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.full((4, 4), 40000, np.uint16))
    for path, what in ((deep, "bit depth 16"),):
        with pytest.raises(ValueError, match=what):
            png.read_png(path)
    for ctype, interlace in ((3, 0), (0, 1)):
        path = str(tmp_path / f"c{ctype}i{interlace}.png")
        _png_with_header(path, 4, 4, 8, ctype, interlace)
        with pytest.raises(ValueError, match="only 8-bit"):
            png.read_png(path)
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(junk))
    png.write_png(str(tmp_path / "ok.png"), _image("grey"))
    with pytest.raises(ValueError, match="flags"):
        png.read_png(str(tmp_path / "ok.png"), -1)
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 2), np.uint8))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    return names + [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]


def test_no_module_of_the_port_imports_opencv_or_pil():
    files = glob.glob(os.path.join(ROOT, "pointcloududa_torch", "**", "*.py"), recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) >= 40
    bad = {os.path.relpath(p, ROOT): [m for m in _imports(p) if m.split(".")[0] in ("cv2", "PIL")] for p in files}
    assert not {p: m for p, m in bad.items() if m}
