"""numpy versions of the OpenCV image operations that the host augmentation
twin (``ops/host_augment.py``) calls, so that the port needs no OpenCV: the
hosts of the card may lack it.

Each function follows what OpenCV 5.0's x86 build does for the dtypes the
twin hands it (float64 work images for uint8 batches, float32 for MM-WHS's
float batches, float32 masks and grids, uint8 for the median and the colour
conversion), and for the offline rotation of ``prep/prepare_mscmrseg.py``
(uint8 images and masks, ``rotation_matrix_2d``), down to its order of
operations where that was found:

- geometry (``warp_affine``, ``warp_perspective``, ``remap``): float64
  images take OpenCV's fixed-point route: source coordinates in 1/1024
  (affine) or doubles (perspective) rounded to a 1/32 grid, bilinear weights
  from its float32 table, summed in float64; nearest rounds the fixed-point
  coordinate. float32 images with 1 or 3 channels take its float route:
  coordinates ``fma(m0, x, m1 * y + m2)`` in float32 (``fma(m0, x, m1 * y) +
  m2`` in the last ``width % 16`` columns, its scalar tail), rounded half to
  even for nearest, and ``fma``-chained lerps for linear. A 2-channel
  float32 image takes the fixed-point route in float32. uint8 images in
  ``warp_affine`` take the float route too (linear on pixels widened to
  float32, rounded half to even and saturated).
- ``resize_linear``: coefficients from ``(d + 0.5) * src / dst - 0.5`` in
  float64 (fused for float64 images), ``fma`` lerps along x then y in the
  image's dtype; 2 channels
  take OpenCV's older float32-coefficient route, equal to within an ulp.
- filters: ``BORDER_REFLECT_101`` (the median: replicate). The Gaussian's
  taps come from ``math.exp``, where OpenCV uses a software ``exp`` that
  differs in the last bits of the outer taps, so its outputs agree to about
  1e-13 (float64) / 1e-5 (float32, on 0..255), not bit for bit; everything
  else is bit-equal to OpenCV 5.0.0 on an x86 host that dispatches its AVX2
  code (``tests/test_torch_port_host_augment.py``).
- colour: the integer RGB->HSV of OpenCV's division tables; HSV->RGB in
  float32 with ``fma`` and truncation for the first ``32 * (width // 32)``
  pixels of each row (OpenCV's 32-lane vector loop) and rounding for the
  rest.

The lane counts (16 float32 coordinates, 8 float32 filter outputs, 32 uint8
pixels) are those of OpenCV's AVX2 code paths. A host whose OpenCV took other
paths would see last-bit differences in float outputs, never in the integer
ones.

Arrays keep their channel axis: an (H, W, 1) image gives an (H, W, 1)
result where OpenCV would drop the axis; (H, W) masks stay (H, W). Sizes are
``(width, height)``, as OpenCV's.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

# OpenCV's border flags, by its numbers
BORDER_CONSTANT, BORDER_REPLICATE, BORDER_REFLECT, BORDER_WRAP, BORDER_REFLECT_101 = 0, 1, 2, 3, 4

_F32 = np.float32
_COORD_LANES = 16  # float32 coordinates per vector iteration of the warps
_FILTER_LANES = 8  # float32 outputs per vector iteration of filter2D
_U8_LANES = 32  # uint8 pixels per vector iteration of HSV -> RGB
_AB_BITS = 10  # fixed-point bits of the affine coordinates
_TAB_BITS = 5  # the bilinear table's 1/32 grid


# ---------------------------------------------------------------- arithmetic


def _fma32(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in float64,
    and the float64 sum rounds once more (off only where it lands on a
    float32 midpoint)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F32)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a  # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma64(a, b, c):
    """float64 fused multiply-add, correctly rounded: the exact product as
    two doubles, then Boldo and Melquiond's sum with the low part rounded to
    odd."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, ve = _two_sum(pl, tl)
    odd = (v.view(np.int64) & 1) == 1
    v = np.where((ve != 0) & ~odd, np.nextafter(v, np.where(ve > 0, np.inf, -np.inf)), v)
    return th + v


def _fma(a, b, c, dtype):
    return _fma64(a, b, c) if dtype == np.float64 else _fma32(a, b, c)


def _lerp(t, lo, hi, dtype):
    """``lo + t * (hi - lo)`` with one rounding for the multiply-add."""
    return _fma(t, hi - lo, lo, dtype)


# --------------------------------------------------------------- borders


def _border_index(i, n: int, mode: int):
    """OpenCV's ``borderInterpolate`` on an index array; -1 where the border
    is constant."""
    i = np.asarray(i, np.int64)
    if mode == BORDER_CONSTANT:
        return np.where((i >= 0) & (i < n), i, -1)
    if mode == BORDER_REPLICATE:
        return np.clip(i, 0, n - 1)
    if mode == BORDER_WRAP:
        return np.mod(i, n)
    if n == 1:
        return np.zeros_like(i)
    if mode == BORDER_REFLECT:
        j = np.mod(i, 2 * n)
        return np.where(j < n, j, 2 * n - 1 - j)
    if mode == BORDER_REFLECT_101:
        j = np.mod(i, 2 * n - 2)
        return np.where(j < n, j, 2 * n - 2 - j)
    raise ValueError(f"border mode {mode}")


def _gather(img3, y, x, mode: int, cval):
    """img3[y, x] for (H, W, C) ``img3`` and integer coordinate arrays, with
    the border applied; returns (..., C)."""
    h, w = img3.shape[:2]
    yi, xi = _border_index(y, h, mode), _border_index(x, w, mode)
    out = img3[np.maximum(yi, 0), np.maximum(xi, 0)]
    if mode == BORDER_CONSTANT:
        out = np.where(((yi >= 0) & (xi >= 0))[..., None], out, np.asarray(cval, img3.dtype))
    return out


def _as3(img):
    img = np.asarray(img)
    return img if img.ndim == 3 else img[..., None]


def _like(out, img):
    return out if np.ndim(img) == 3 else out[..., 0]


# ---------------------------------------------------------------- resize


@lru_cache(maxsize=64)
def _linear_taps(dn: int, sn: int, dtype: str):
    """Source index and weight of each output position: the fractional part
    of ``(d + 0.5) * (sn / dn) - 0.5`` in float64, clamped at the edges. For
    float64 images OpenCV fuses that multiply-add (one rounding); for
    float32 images it does not."""
    scale = sn / dn
    fused = np.dtype(dtype) == np.float64
    x0 = np.empty(dn, np.int64)
    frac = np.empty(dn, np.float64)
    for d in range(dn):
        if fused:
            fx = float(Fraction(d) * Fraction(scale) + Fraction(1, 2) * Fraction(scale) - Fraction(1, 2))
        else:
            fx = (d + 0.5) * scale - 0.5
        sx = math.floor(fx)
        fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= sn - 1:
            fx, sx = 0.0, sn - 1
        x0[d], frac[d] = sx, fx
    return x0, np.minimum(x0 + 1, sn - 1), frac.astype(dtype)


@lru_cache(maxsize=64)
def _legacy_linear_taps(dn: int, sn: int):
    """OpenCV's older taps (2-channel images): float32 ``(d + 0.5) * scale -
    0.5`` with ``scale = 1 / (dn / sn)``, weights ``1 - f`` and ``f``."""
    fx = ((np.arange(dn) + 0.5) * (1.0 / (dn / sn)) - 0.5).astype(_F32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(_F32)
    lo, hi = sx < 0, sx >= sn - 1
    fx[lo | hi] = 0
    sx = np.where(lo, 0, np.where(hi, sn - 1, sx))
    return sx, np.minimum(sx + 1, sn - 1), _F32(1) - fx, fx


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) of a float32/float64
    image. 1 and 3 channels: bit-equal; 2 channels (the piecewise grid):
    within an ulp (OpenCV's vertical pass there was not reproduced to the
    last bit)."""
    w, h = size
    img = np.asarray(img)
    s = _as3(img)
    dt = s.dtype
    if s.shape[2] == 2:
        x0, x1, a0, a1 = _legacy_linear_taps(w, s.shape[1])
        y0, y1, b0, b1 = _legacy_linear_taps(h, s.shape[0])
        rows = s[:, x0] * a0.astype(dt)[None, :, None] + s[:, x1] * a1.astype(dt)[None, :, None]
        out = rows[y0] * b0.astype(dt)[:, None, None] + rows[y1] * b1.astype(dt)[:, None, None]
        return _like(out.astype(dt), img)
    x0, x1, ax = _linear_taps(w, s.shape[1], dt.str)
    y0, y1, by = _linear_taps(h, s.shape[0], dt.str)
    rows = _lerp(ax[None, :, None], s[:, x0], s[:, x1], dt)
    out = _lerp(by[:, None, None], rows[y0], rows[y1], dt)
    return _like(out.astype(dt), img)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``: source index
    ``floor(d * (1 / (dn / sn)))``. Bit-equal."""
    w, h = size
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return img[ys][:, xs]


# ---------------------------------------------------------------- filters


def _reflect101_pad(s3, r: int):
    h, w = s3.shape[:2]
    return s3[_border_index(np.arange(-r, h + r), h, BORDER_REFLECT_101)][:, _border_index(np.arange(-r, w + r), w, BORDER_REFLECT_101)]


def gaussian_kernel(sigma: float, dtype) -> np.ndarray:
    """OpenCV's taps for ``GaussianBlur(img, (0, 0), sigma)`` of a float
    image: ``round(8 sigma + 1) | 1`` of them, ``exp(-x^2 / (2 sigma^2))``
    over even offsets ``x = 2 i`` scaled by 1/8, normalised by the sum taken
    as twice the half plus one (``getGaussianKernelBitExact``), with
    ``math.exp`` for OpenCV's software exponential."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    scale2x = -0.125 / (sigma * sigma)
    half = [math.exp(float(x * x) * scale2x) for x in range(1 - n, 0, 2)]
    total = 0.0
    for t in half:
        total += t
    mul = 1.0 / (total * 2.0 + 1.0)
    taps = [t * mul for t in half]
    return np.asarray(taps + [mul] + taps[::-1]).astype(dtype)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float image,
    ``BORDER_REFLECT_101``: the rows accumulated tap by tap from the left
    with fused multiply-adds, then the columns from the centre out in
    symmetric pairs (float64: plain multiply-adds, bit-equal to OpenCV given
    its taps; float32: fused, within an ulp of it)."""
    img = np.asarray(img)
    s = _as3(img)
    dt = s.dtype
    k = gaussian_kernel(sigma, dt)
    n = len(k)
    r = n // 2
    h, w = s.shape[:2]
    p = s[:, _border_index(np.arange(-r, w + r), w, BORDER_REFLECT_101)]
    rows = k[0] * p[:, 0:w]
    for j in range(1, n):
        rows = _fma(k[j], p[:, j:j + w], rows, dt)
    q = rows[_border_index(np.arange(-r, h + r), h, BORDER_REFLECT_101)]
    out = k[r] * q[r:r + h]
    for j in range(1, r + 1):
        pair = q[r + j:r + j + h] + q[r - j:r - j + h]
        out = out + pair * k[r + j] if dt == np.float64 else _fma32(pair, k[r + j], out)
    return _like(out.astype(dt), img)


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of a float image: row sums in float64
    (direct for k <= 5, else running: ``s += new - old``), running column
    sums, times ``1 / k^2``, ``BORDER_REFLECT_101``, anchor at ``k // 2``.
    Bit-equal."""
    img = np.asarray(img)
    s = _as3(img).astype(np.float64)
    h, w, c = s.shape
    r = k // 2
    src = s[:, _border_index(np.arange(-r, w + k - 1 - r), w, BORDER_REFLECT_101)]
    if k <= 5:
        rows = src[:, 0:w]
        for i in range(1, k):
            rows = rows + src[:, i:i + w]
    else:
        rows = np.empty((h, w, c))
        acc = src[:, 0]
        for i in range(1, k):
            acc = acc + src[:, i]
        rows[:, 0] = acc
        for i in range(w - 1):
            acc = acc + (src[:, i + k] - src[:, i])
            rows[:, i + 1] = acc
    rr = rows[_border_index(np.arange(-r, h + k - 1 - r), h, BORDER_REFLECT_101)]
    scale = 1.0 / (k * k)
    out = np.empty((h, w, c))
    acc = np.zeros((w, c))
    for i in range(k - 1):
        acc = acc + rr[i]
    for y in range(h):
        s0 = acc + rr[y + k - 1]
        out[y] = s0 * scale
        acc = s0 - rr[y]
    return _like(out.astype(img.dtype), img)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur`` of a uint8 image, odd ``k``: the median of each
    k x k window with replicated borders. Bit-equal."""
    img = np.asarray(img, np.uint8)
    s = _as3(img)
    r = k // 2
    p = np.pad(s, ((r, r), (r, r), (0, 0)), mode="edge")
    out = np.empty_like(s)
    mid = k * k // 2
    step = max(1, 4096 // s.shape[1])  # rows a chunk: bounds the windows' copy
    for y in range(0, s.shape[0], step):
        win = sliding_window_view(p[y:y + step + 2 * r], (k, k), axis=(0, 1))
        flat = win.reshape(win.shape[:3] + (k * k,))
        out[y:y + step] = np.partition(flat, mid, axis=-1)[..., mid]
    return _like(out, img)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` with a 3 x 3 float32 kernel: the
    kernel's non-zero taps in row-major order accumulated from 0,
    ``BORDER_REFLECT_101``. float64: plain adds; float32: fused
    multiply-adds except in the last ``(W * C) % 8`` values of each row.
    Bit-equal."""
    img = np.asarray(img)
    s = _as3(img)
    dt = s.dtype
    kk = np.asarray(kernel).astype(dt)
    h, w, c = s.shape
    p = _reflect101_pad(s, 1)
    plain = fused = None
    for i in range(3):
        for j in range(3):
            if kk[i, j] == 0:
                continue
            term = p[i:i + h, j:j + w]
            if plain is None:
                plain = fused = dt.type(0) + kk[i, j] * term
            else:
                plain = plain + kk[i, j] * term
                if dt == _F32:
                    fused = _fma32(kk[i, j], term, fused)
    if plain is None:
        return _like(np.zeros_like(s), img)
    if dt == _F32:
        n = w * c
        cut = n - n % _FILTER_LANES
        plain = np.concatenate([fused.reshape(h, n)[:, :cut], plain.reshape(h, n)[:, cut:]], 1).reshape(h, w, c)
    return _like(plain.astype(dt), img)


# ---------------------------------------------------------------- colour

_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` of a uint8 (H, W, 3) image: hue
    0..179, OpenCV's 12-bit division tables. Bit-equal."""
    img = np.asarray(img, np.uint8)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    vr = np.where(v == r, -1, 0)
    vg = np.where(v == g, -1, 0)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    hue = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))))
    hue = (hue * _HDIV[diff] + half) >> _HSV_SHIFT
    hue = hue + np.where(hue < 0, 180, 0)
    return np.stack([hue, s, v], -1).astype(np.uint8)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image with
    hue 0..179: float32 sector arithmetic, ``v * fma(-s, f, 1)``, times 255;
    truncated in the vector part of each row, rounded in its tail.
    Bit-equal."""
    img = np.asarray(img, np.uint8)
    hue = img[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = img[..., 1].astype(_F32) * _F32(1.0 / 255)
    v = img[..., 2].astype(_F32) * _F32(1.0 / 255)
    sector = np.floor(hue)
    f = hue - sector
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    idx = _SECTORS[sector.astype(np.int64) % 6]
    bgr = np.take_along_axis(tab, idx, -1) * _F32(255)
    rgb = bgr[..., ::-1]
    w = img.shape[1]
    cut = w - w % _U8_LANES
    out = np.concatenate([np.trunc(rgb[:, :cut]), np.rint(rgb[:, cut:])], 1)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- geometry


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` of float32 (4, 2) (x, y)
    points: OpenCV's 8 x 8 system (float32 products) solved by its own
    Gaussian elimination with partial pivoting, in float64. Bit-equal."""
    src = np.asarray(src, _F32)
    dst = np.asarray(dst, _F32)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy, dx, dy = src[i, 0], src[i, 1], dst[i, 0], dst[i, 1]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6] = float(-sx * dx)
        a[i][7] = float(-sy * dx)
        a[i + 4][6] = float(-sx * dy)
        a[i + 4][7] = float(-sy * dy)
        b[i], b[i + 4] = float(dx), float(dy)
    for i in range(8):
        k = i
        for j in range(i + 1, 8):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise np.linalg.LinAlgError("degenerate perspective points")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d
            for kk in range(i + 1, 8):
                a[j][kk] += alpha * a[i][kk]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for kk in range(i + 1, 8):
            s -= a[i][kk] * b[kk]
        b[i] = s / a[i][i]
    return np.array(b + [1.0]).reshape(3, 3)


def _invert_affine(m) -> list:
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert3(m) -> list:
    """``cv2.invert`` of a 3 x 3 float64 matrix (the cofactor formula)."""
    s = [[float(v) for v in row] for row in np.asarray(m, np.float64)]
    d = s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1]) - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0]) \
        + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0])
    if d == 0:
        return [0.0] * 9
    d = 1.0 / d
    return [
        (s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d, (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
        (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d, (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
        (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d, (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
        (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d, (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
        (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d,
    ]


def _bilinear_table() -> np.ndarray:
    t = np.arange(32, dtype=_F32) / _F32(32)
    c0, c1 = _F32(1) - t, t
    return np.stack([c0[:, None] * c0[None], c0[:, None] * c1[None], c1[:, None] * c0[None], c1[:, None] * c1[None]], -1)


_BILINEAR_TAB = _bilinear_table()  # [fy, fx] -> 4 float32 weights


def _fixed_point_sample(s3, xq, yq, nearest: bool, mode: int, cval):
    """OpenCV's fixed-point resampling: ``xq``, ``yq`` are pixel indices
    (nearest) or 1/32 steps (linear, the table's weights summed in the
    image's dtype)."""
    if nearest:
        return _gather(s3, yq, xq, mode, cval)
    h, w = s3.shape[:2]
    sx, sy = xq >> _TAB_BITS, yq >> _TAB_BITS
    wt = _BILINEAR_TAB[yq & 31, xq & 31].astype(s3.dtype)
    p = [_gather(s3, sy + dy, sx + dx, mode, cval) for dy in (0, 1) for dx in (0, 1)]
    out = ((p[0] * wt[..., 0:1] + p[1] * wt[..., 1:2]) + p[2] * wt[..., 2:3]) + p[3] * wt[..., 3:4]
    if mode == BORDER_CONSTANT:
        far = (sx >= w) | (sx + 1 < 0) | (sy >= h) | (sy + 1 < 0)
        out = np.where(far[..., None], np.asarray(cval, s3.dtype), out)
    return out


def _float_sample(s3, x, y, nearest: bool, mode: int, cval):
    """OpenCV's float32 resampling at float32 coordinates: nearest rounds
    half to even; linear lerps along x, then y, with fused multiply-adds."""
    if nearest:
        return _gather(s3, np.rint(y).astype(np.int64), np.rint(x).astype(np.int64), mode, cval)
    ix, iy = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    a = (x - ix.astype(_F32))[..., None]
    b = (y - iy.astype(_F32))[..., None]
    f00, f01 = _gather(s3, iy, ix, mode, cval), _gather(s3, iy, ix + 1, mode, cval)
    f10, f11 = _gather(s3, iy + 1, ix, mode, cval), _gather(s3, iy + 1, ix + 1, mode, cval)
    f0 = _fma32(a, f01 - f00, f00)
    f1 = _fma32(a, f11 - f10, f10)
    return _fma32(b, f1 - f0, f0)


def _float_route(s3) -> bool:
    return s3.dtype == _F32 and s3.shape[2] in (1, 3)


def _float_coords(m, w: int, h: int):
    """float32 coordinate rows ``fma(m0, x, m1 * y + m2)`` of the vector
    part, ``fma(m0, x, m1 * y) + m2`` of the scalar tail."""
    f = np.asarray(m, _F32)
    x = np.arange(w, dtype=_F32)[None]
    y = np.arange(h, dtype=_F32)[:, None]
    cut = w - w % _COORD_LANES
    out = []
    for i in range(0, len(f), 3):
        vec = _fma32(f[i], x[:, :cut], f[i + 1] * y + f[i + 2])
        tail = _fma32(f[i], x[:, cut:], f[i + 1] * y) + f[i + 2]
        out.append(np.concatenate([vec, tail], 1))
    return out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the 2 x 3 float64
    map rotating by ``angle`` degrees (counter-clockwise) about ``center``
    (x, y), which OpenCV holds in float32. Bit-equal."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = float(angle) * (math.pi / 180)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: np.ndarray, m: np.ndarray, size, nearest: bool = False, border: int = BORDER_CONSTANT,
                cval=0.0) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, flags, borderMode=border,
    borderValue=cval)`` for a forward 2 x 3 (x, y) map. float32 images (1 or
    3 channels) are bit-equal for nearest and linear alike; float64 images
    (the fixed-point route) are bit-equal too. uint8 images with 1, 3 or 4
    channels take OpenCV's float route as float32 ones do: nearest gathers at
    the rounded float32 coordinates, linear lerps the pixels widened to
    float32 and rounds half to even with saturation; bit-equal. 2-channel
    uint8 images take another OpenCV route, not reproduced: they raise."""
    img = np.asarray(img)
    s3 = _as3(img)
    w, h = size
    mi = _invert_affine(m)
    cv = np.full(s3.shape[2], float(cval))
    if s3.dtype == np.uint8:
        if s3.shape[2] not in (1, 3, 4):
            raise ValueError(f"warp_affine: uint8 images with {s3.shape[2]} channels are not supported")
        x, y = _float_coords(mi, w, h)
        if nearest:
            return _like(_float_sample(s3, x, y, True, border, cv), img)
        out = _float_sample(s3.astype(_F32), x, y, False, border, cv)
        return _like(np.clip(np.rint(out), 0, 255).astype(np.uint8), img)
    if _float_route(s3):
        x, y = _float_coords(mi, w, h)
        return _like(_float_sample(s3, x, y, nearest, border, cv).astype(s3.dtype), img)
    scale = 1 << _AB_BITS
    xs, ys = np.arange(w), np.arange(h)
    adelta = np.rint(mi[0] * xs * scale).astype(np.int64)
    bdelta = np.rint(mi[3] * xs * scale).astype(np.int64)
    round_delta = scale // 2 if nearest else scale >> (_TAB_BITS + 1)
    x0 = np.rint((mi[1] * ys + mi[2]) * scale).astype(np.int64) + round_delta
    y0 = np.rint((mi[4] * ys + mi[5]) * scale).astype(np.int64) + round_delta
    shift = _AB_BITS if nearest else _AB_BITS - _TAB_BITS
    xq = (x0[:, None] + adelta[None]) >> shift
    yq = (y0[:, None] + bdelta[None]) >> shift
    return _like(_fixed_point_sample(s3, xq, yq, nearest, border, cv).astype(s3.dtype), img)


def warp_perspective(img: np.ndarray, m: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    """``cv2.warpPerspective(img, m, size, flags)`` with its default
    constant-0 border. float32 (1 or 3 channels): float32 coordinates over
    ``fma`` rows divided by the third; float64: OpenCV's double coordinates,
    computed per block of 64 columns as it does, rounded to the pixel
    (nearest) or to 1/32. Bit-equal."""
    img = np.asarray(img)
    s3 = _as3(img)
    w, h = size
    mi = _invert3(m)
    cv = np.zeros(s3.shape[2])
    if _float_route(s3):
        x, y, z = _float_coords(mi, w, h)
        return _like(_float_sample(s3, x / z, y / z, nearest, BORDER_CONSTANT, cv).astype(s3.dtype), img)
    bh0 = min(16, h)
    bw0 = min(1024 // bh0, w)
    ys = np.arange(h, dtype=np.float64)[:, None]
    xq = np.empty((h, w), np.int64)
    yq = np.empty((h, w), np.int64)
    unit = 1.0 if nearest else float(1 << _TAB_BITS)
    lim = (float(np.iinfo(np.int32).min), float(np.iinfo(np.int32).max))
    for xb in range(0, w, bw0):
        x1 = np.arange(min(bw0, w - xb), dtype=np.float64)[None]
        fx = mi[0] * xb + mi[1] * ys + mi[2]
        fy = mi[3] * xb + mi[4] * ys + mi[5]
        fw = (mi[6] * xb + mi[7] * ys + mi[8]) + mi[6] * x1
        fw = np.where(fw != 0, unit / np.where(fw != 0, fw, 1.0), 0.0)
        xq[:, xb:xb + x1.shape[1]] = np.rint(np.clip((fx + mi[0] * x1) * fw, *lim)).astype(np.int64)
        yq[:, xb:xb + x1.shape[1]] = np.rint(np.clip((fy + mi[3] * x1) * fw, *lim)).astype(np.int64)
    return _like(_fixed_point_sample(s3, xq, yq, nearest, BORDER_CONSTANT, cv).astype(s3.dtype), img)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, nearest: bool = False) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, flags, borderMode=BORDER_REPLICATE)``
    with float32 maps. float32 images (1 or 3 channels) sample at the maps'
    float32 coordinates; the others at ``round(map * 32)`` (linear) or
    ``round(map)`` (nearest). Bit-equal."""
    img = np.asarray(img)
    s3 = _as3(img)
    mx, my = np.asarray(map_x, _F32), np.asarray(map_y, _F32)
    cv = np.zeros(s3.shape[2])
    if _float_route(s3):
        return _like(_float_sample(s3, mx, my, nearest, BORDER_REPLICATE, cv).astype(s3.dtype), img)
    unit = _F32(1) if nearest else _F32(1 << _TAB_BITS)
    xq, yq = np.rint(mx * unit).astype(np.int64), np.rint(my * unit).astype(np.int64)
    return _like(_fixed_point_sample(s3, xq, yq, nearest, BORDER_REPLICATE, cv).astype(s3.dtype), img)
