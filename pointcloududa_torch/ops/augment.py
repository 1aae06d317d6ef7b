"""Device-side, batched data augmentation: the port of
``pointcloududa_tpu/ops/augment.py``, all three of the reference's pipelines
(``src/data_generator_mscmrseg.py:20-167``, ``src/data_generator_mmwhs.py:
87-122``): :func:`heavy` (``augmentation``, the MS-CMRSeg default),
:func:`medium` (``augmentation2``) and :func:`light` (``light_aug``).

Structure, as in the JAX package: the four LINEAR children of the outer
``Sequential(random_order=True)`` (Fliplr, Flipud, CropAndPad, Affine) are
per-sample inverse 3x3 maps, composed in an order drawn once per batch
(imgaug's meta augmenters iterate children over the whole batch in one
permutation), and applied as ONE resample per image (:func:`_warp_one`)
together with the SomeOf geometry members (perspective in the product,
elastic and piecewise-affine as a displacement field). The twelve intensity
entries of ``SomeOf((0, 5))`` (superpixels, blur OneOf{gaussian, average,
median}, sharpen, emboss, simplex-noise edge blend, additive noise, dropout
OneOf{pixel, coarse}, invert, add, hue/saturation, multiply, grayscale) run
in an order drawn once per batch, before or after the warp as the outer
order places the SomeOf child. Masks ride the resample as a
nearest-neighbour plane with constant-0 borders (imgaug hardcodes
``mode="constant", cval=0`` for segmentation maps) and never receive
intensity ops. The remaining deviations from imgaug are the JAX package's
and are listed in its module docstring.

Each sampler is split from its arithmetic: :func:`sample_draws` is the only
function that draws random numbers; :func:`augment_from_draws` and the ops it
calls are deterministic functions of tensors, so a test can feed them the
values another framework drew.

Where the JAX package traces every entry for every sample and selects (its
``lax.switch`` over a traced order), the port decides on the host: the
per-batch orders, the SomeOf members that fire and the blur choice are drawn
on a CPU generator, and each op runs only on the samples that take it, which
gives the same images. Nothing in a call waits for the device: the host
reads only its own draws, and the sample indices go to the device in one
non-blocking copy.

``torch.nn.functional.grid_sample`` is not used: its rounding and border
rules differ (here: round-half-down nearest, per-tap constant fill), and the
masks must come out identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

_SOMEOF_EXPECTED = 2.5  # E[#active] of iaa.SomeOf((0, 5))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    fliplr: float = 0.5
    flipud: float = 0.2
    croppad_prob: float = 0.5
    croppad: Tuple[float, float] = (-0.05, 0.1)
    affine_prob: float = 0.5
    # image border handling for the crop&pad/affine resample: True = sample
    # among all five skimage modes (``mode=ia.ALL``/``pad_mode=ia.ALL``,
    # heavy/aug2); False = constant only (the light pipelines' Affine pins
    # ``mode='constant'``, data_generator_mscmrseg.py:153 / mmwhs.py:101).
    # Masks always get constant-0 borders, matching imgaug's segmap rule.
    border_mode_all: bool = True
    # exact iaa.SomeOf((0, 5)) without-replacement draw over the first
    # ``someof_n`` entries (15 heavy, 12 medium -- the medium pipeline's
    # SomeOf list is exactly the first 12 entries, reference
    # data_generator_mscmrseg.py:95-129). 0 = independent per-entry gates
    # (the *_prob / intensity_gate fields below).
    someof_n: int = 15
    someof_count: Tuple[int, int] = (0, 5)
    sometimes_p: float = 0.5  # the Sometimes(0.5) wrap on entries {0,12,13,14}
    scale: Tuple[float, float] = (0.8, 1.2)
    translate: Tuple[float, float] = (-0.2, 0.2)
    # per-axis x override for iaa.Affine translate_percent={"x": ..., "y":
    # translate}; None = same range as `translate` (the heavy pipeline is
    # x/y-symmetric, the light one is not)
    translate_x: "Tuple[float, float] | None" = None
    rotate: Tuple[float, float] = (-45.0, 45.0)
    shear: Tuple[float, float] = (-16.0, 16.0)
    # ---- SomeOf((0,5)) family: per-entry gate (2.5/15 for heavy); the
    # Sometimes(0.5)-wrapped entries use gate * 0.5
    intensity_gate: float = _SOMEOF_EXPECTED / 15
    superpixels_prob: float = 0.5 * _SOMEOF_EXPECTED / 15
    superpixels_segments: Tuple[int, int] = (20, 200)
    superpixels_replace: Tuple[float, float] = (0.0, 1.0)
    blur_sigma: Tuple[float, float] = (0.0, 3.0)
    avg_blur_k: Tuple[int, int] = (2, 7)
    median_blur_k: Tuple[int, int] = (3, 11)
    sharpen_alpha: Tuple[float, float] = (0.0, 1.0)
    sharpen_lightness: Tuple[float, float] = (0.75, 1.5)
    emboss_alpha: Tuple[float, float] = (0.0, 1.0)
    emboss_strength: Tuple[float, float] = (0.0, 2.0)
    edge_alpha: Tuple[float, float] = (0.5, 1.0)
    noise_scale: Tuple[float, float] = (0.0, 0.05 * 255)
    dropout: Tuple[float, float] = (0.01, 0.1)
    coarse_dropout: Tuple[float, float] = (0.03, 0.15)
    coarse_size: Tuple[float, float] = (0.02, 0.05)
    invert_prob: float = 0.05  # per-channel invert prob WHEN the entry fires
    add: Tuple[float, float] = (-10.0, 10.0)
    hue_sat: Tuple[float, float] = (-20.0, 20.0)
    multiply: Tuple[float, float] = (0.5, 1.5)
    grayscale_alpha: Tuple[float, float] = (0.0, 1.0)
    elastic_prob: float = 0.5 * _SOMEOF_EXPECTED / 15
    elastic_alpha: Tuple[float, float] = (0.5, 3.5)
    piecewise_prob: float = 0.5 * _SOMEOF_EXPECTED / 15
    piecewise_scale: Tuple[float, float] = (0.01, 0.05)
    perspective_prob: float = 0.5 * _SOMEOF_EXPECTED / 15
    perspective_scale: Tuple[float, float] = (0.01, 0.1)

    def __post_init__(self):
        # the median blur's stencil window is r=5 (taps beyond |d| > 5 never
        # enter the count), so a wider k would silently drop taps: reject it
        # here, as the JAX package does
        lo, hi = self.median_blur_k
        if not (1 <= lo <= hi <= 11):
            raise ValueError(
                f"median_blur_k={self.median_blur_k}: the median blur supports "
                "odd k in [1, 11] only (r=5 stencil window)"
            )


def heavy() -> AugmentConfig:
    """The reference's ``augmentation`` pipeline (flips + geometry + a
    15-entry SomeOf, ``data_generator_mscmrseg.py:20-84``)."""
    return AugmentConfig()


def medium() -> AugmentConfig:
    """``augmentation2``: crop&pad + a 12-entry SomeOf -- no flips, no
    affine, no elastic/piecewise/perspective
    (``data_generator_mscmrseg.py:86-132``)."""
    g = _SOMEOF_EXPECTED / 12
    return AugmentConfig(
        fliplr=0.0,
        flipud=0.0,
        affine_prob=0.0,
        someof_n=12,
        intensity_gate=g,
        superpixels_prob=0.5 * g,
        elastic_prob=0.0,
        piecewise_prob=0.0,
        perspective_prob=0.0,
    )


def light() -> AugmentConfig:
    """``light_aug``: flips + gentle affine, no intensity
    (``data_generator_mmwhs.py:87-122`` -- the only light pipeline the
    reference ever CALLS, from its MM-WHS generator at ``:253``). Gates
    0.2/0.2/0.3; the affine translate range is per-axis asymmetric
    (x (-0.1, 0.05), y (-0.1, 0.1))."""
    return AugmentConfig(
        fliplr=0.2,
        flipud=0.2,
        croppad_prob=0.0,
        affine_prob=0.3,
        translate=(-0.1, 0.1),
        translate_x=(-0.1, 0.05),
        rotate=(-10.0, 10.0),
        shear=(-12.0, 12.0),
        someof_n=0,
        intensity_gate=0.0,
        superpixels_prob=0.0,
        elastic_prob=0.0,
        piecewise_prob=0.0,
        perspective_prob=0.0,
        invert_prob=0.0,
        border_mode_all=False,  # both light Affines pin mode='constant'
    )


# --------------------------------------------------------------------- #
# geometry: ONE warp per image -- the four LINEAR outer children (flips,
# crop&pad, affine) as per-sample inverse matrices composed in the per-batch
# drawn order
def child_matrices_from_params(gates, p4, sy, sx, theta_deg, shear_deg, t, snap_u, h: int, w: int):
    """Per-sample inverse 3x3 maps (output (y,x,1) -> input) for the four
    linear outer-Sequential children, indexed [Fliplr, Flipud, CropAndPad,
    Affine]; identity when a child does not fire.

    ``gates`` (B, 4) bool: which child fires. The other arguments are the RAW
    draws, used only where their gate fired: ``p4`` (B, 4) crop&pad percent
    per side (top, bottom, left, right; ``iaa.CropAndPad`` with
    ``sample_independently=True`` and ``keep_size=True``: per axis
    out = (in + 0.5 + p_lo*n) / (1 + p_lo + p_hi) - 0.5); ``sy``, ``sx``
    (B,) scales; ``theta_deg``, ``shear_deg`` (B,) degrees; ``t`` (B, 2)
    translation as a fraction of (h, w); ``snap_u`` (B,) uniform in [0, 1).

    Returns ``(mats (B, 4, 3, 3), any_warp (B,), snap (B,))``: ``any_warp`` =
    crop&pad or affine fired (border mode and cval apply only then: flips
    vacate nothing); ``snap`` = the iaa.Affine ``order=[0, 1]`` draw
    (nearest-neighbour image resample half the time the affine fires).
    """
    f32 = torch.float32
    g_lr, g_ud, g_cp, g_aff = gates.unbind(-1)
    one, zero = torch.ones_like(sy, dtype=f32), torch.zeros_like(sy, dtype=f32)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    eye = mat([[one, zero, zero], [zero, one, zero], [zero, zero, one]])

    def gated(g, m):
        return torch.where(g[:, None, None], m, eye)

    m_lr = gated(g_lr, mat([[one, zero, zero], [zero, -one, one * (w - 1.0)], [zero, zero, one]]))
    m_ud = gated(g_ud, mat([[-one, zero, one * (h - 1.0)], [zero, one, zero], [zero, zero, one]]))

    p4 = torch.where(g_cp[:, None], p4.to(f32), torch.zeros((), dtype=f32, device=p4.device))
    sy_cp = 1.0 + p4[:, 0] + p4[:, 1]
    sx_cp = 1.0 + p4[:, 2] + p4[:, 3]
    m_cp = mat(
        [
            [sy_cp, zero, 0.5 * (sy_cp - 1.0) - p4[:, 0] * h],
            [zero, sx_cp, 0.5 * (sx_cp - 1.0) - p4[:, 2] * w],
            [zero, zero, one],
        ]
    )

    sy = torch.where(g_aff, sy.to(f32), one)
    sx = torch.where(g_aff, sx.to(f32), one)
    theta = torch.deg2rad(torch.where(g_aff, theta_deg.to(f32), zero))
    shear = torch.deg2rad(torch.where(g_aff, shear_deg.to(f32), zero))
    t = torch.where(g_aff[:, None], t.to(f32), torch.zeros((), dtype=f32, device=t.device))
    ty, tx = t[:, 0] * h, t[:, 1] * w

    cos, sin = torch.cos(theta), torch.sin(theta)

    def mat2(m00, m01, m10, m11):
        return torch.stack([torch.stack([m00, m01], -1), torch.stack([m10, m11], -1)], -2)

    # forward: center -> scale -> shear(x) -> rotate -> translate -> uncenter
    a = mat2(cos, -sin, sin, cos) @ mat2(one, zero, torch.tan(shear), one) @ mat2(sy, zero, zero, sx)
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv = mat2(a[:, 1, 1], -a[:, 0, 1], -a[:, 1, 0], a[:, 0, 0]) / det[:, None, None]
    c = torch.stack([torch.full_like(ty, (h - 1) / 2.0), torch.full_like(tx, (w - 1) / 2.0)], -1)
    shift = c + torch.stack([ty, tx], -1)
    # input = inv @ (out - shift) + c, as one homogeneous matrix
    trans = c - (inv @ shift[:, :, None])[:, :, 0]
    m_aff = mat(
        [
            [inv[:, 0, 0], inv[:, 0, 1], trans[:, 0]],
            [inv[:, 1, 0], inv[:, 1, 1], trans[:, 1]],
            [zero, zero, one],
        ]
    )
    snap = g_aff & (snap_u < 0.5)
    return torch.stack([m_lr, m_ud, m_cp, m_aff], dim=1), g_aff | g_cp, snap


def _select(conds, values, default):
    """First value whose condition holds, else ``default`` (``jnp.select``)."""
    out = default
    for cond, value in zip(reversed(conds), reversed(values)):
        out = torch.where(cond, value, out)
    return out


def _border_fold(i, n: int, mode):
    """Map an out-of-range integer index per skimage/np.pad border mode.

    mode: 0 constant (clip; the caller overrides with the fill value),
    1 edge, 2 symmetric (abccba), 3 reflect (abcba), 4 wrap.
    """
    edge = torch.clamp(i, 0, n - 1)
    m2 = torch.remainder(i, 2 * n)
    symmetric = torch.where(m2 < n, m2, 2 * n - 1 - m2)
    period = max(2 * n - 2, 1)
    m3 = torch.remainder(i, period)
    reflect = torch.where(m3 < n, m3, 2 * n - 2 - m3)
    wrap = torch.remainder(i, n)
    return _select([mode == 1, mode == 2, mode == 3, mode == 4], [edge, symmetric, reflect, wrap], edge)


def _fold_coord(t, n: int, mode):
    """Continuous border fold of a float sample coordinate ``t`` into the
    1-ring-padded range [-1, n] per ``mode`` (0 constant / 1 edge /
    2 symmetric / 3 reflect / 4 wrap).

    The np.pad extensions for edge/symmetric/reflect/wrap are periodic or
    reflective, so interpolating the extension at ``t`` equals interpolating
    the base samples (plus a 1-ring pad) at the folded coordinate. Constant
    mode is the identity (the caller clips indices and fills out-of-range
    taps with cval).
    """
    edge = torch.clamp(t, 0.0, n - 1.0)
    psi = torch.remainder(t + 0.5, 2.0 * n)  # symmetric: even around -0.5, period 2n
    symmetric = torch.minimum(psi, 2.0 * n - psi) - 0.5
    period = max(2 * n - 2, 1)  # reflect: even around 0, period 2n-2
    reflect = (n - 1.0) - torch.abs(torch.remainder(t, period) - (n - 1.0))
    wrap = torch.remainder(t, n)
    return _select([mode == 1, mode == 2, mode == 3, mode == 4], [edge, symmetric, reflect, wrap], t)


def _round_half_down(t):
    return torch.ceil(t - 0.5)


def _warp_one(img, M, disp, order: int, cval, mode=None, snap=None, nn=None):
    """One inverse projective warp per image, batched: ``img`` (B, H, W, C)
    f32, ``M`` (B, 3, 3) output (y, x, 1) -> input, ``disp`` (B, H, W, 2)
    additive displacement field or None.

    ``order`` 1 = bilinear, 0 = nearest (round-half-down, as scipy's order-0
    ``map_coordinates``). ``cval`` (B,) or a float: the constant fill.
    ``mode`` (B,) int or None (= constant): border handling per ``ia.ALL``
    -- 0 constant (fill = ``cval``, per tap), 1 edge, 2 symmetric,
    3 reflect, 4 wrap. ``snap`` (B,) bool or None: snap the sample
    coordinates to integers (round-half-down) before the bilinear fetch,
    the exact order-0 result through the order-1 path (iaa.Affine
    order=[0,1]). ``nn``: optional (B, H, W) plane sampled nearest
    (round-half-down) with constant-0 borders at the same coordinates -- the
    segmentation-mask path; when given, returns ``(img_out, nn_out)``.

    The image is padded by a 1-ring per ``mode`` (edge/symmetric replicate
    the border, reflect takes the second row, wrap the opposite one),
    coordinates are border-folded continuously (:func:`_fold_coord`), and
    the four taps of the 2x2 support are gathered from the padded image.
    """
    b, h, w, ch = img.shape
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)

    def m(i, j):
        return M[:, i, j, None, None]

    dnm = m(2, 0) * yy + m(2, 1) * xx + m(2, 2)
    dnm = torch.where(torch.abs(dnm) < 1e-8, torch.full_like(dnm, 1e-8), dnm)
    iy = (m(0, 0) * yy + m(0, 1) * xx + m(0, 2)) / dnm
    ix = (m(1, 0) * yy + m(1, 1) * xx + m(1, 2)) / dnm
    if disp is not None:
        iy, ix = iy + disp[..., 0], ix + disp[..., 1]
    if snap is not None:
        s = snap[:, None, None]
        iy = torch.where(s, _round_half_down(iy), iy)
        ix = torch.where(s, _round_half_down(ix), ix)

    mode_t = torch.zeros(b, dtype=torch.int32, device=dev) if mode is None else mode.to(device=dev)
    planes = img if nn is None else torch.cat([img, nn[..., None].to(img.dtype)], dim=-1)
    cp = planes.shape[-1]

    def ring(a, axis):
        n = a.shape[axis]
        md = mode_t[:, None, None, None]
        row = lambda k: a.narrow(axis, k, 1)  # noqa: E731
        lo = torch.where(md == 3, row(1), torch.where(md == 4, row(n - 1), row(0)))
        hi = torch.where(md == 3, row(n - 2), torch.where(md == 4, row(0), row(n - 1)))
        return torch.cat([lo, a, hi], dim=axis)

    ap = ring(ring(planes, 1), 2)  # (b, h+2, w+2, cp); corners fold both axes

    mode_c = mode_t[:, None, None]
    fy = _fold_coord(iy, h, mode_c)
    fx = _fold_coord(ix, w, mode_c)
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = fy - y0
    wx = fx - x0
    y0i = torch.clamp(y0.to(torch.int64), -1, h - 1) + 1  # padded row in [0, h]
    x0i = torch.clamp(x0.to(torch.int64), -1, w - 1) + 1
    item = torch.arange(b, device=dev)[:, None, None]
    # taps ordered [(0,0), (0,1), (1,0), (1,1)], each (b, h, w, cp)
    g = [ap[item, y0i + dy, x0i + dx] for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]

    constant = (mode_c == 0)
    fill = torch.as_tensor(cval, dtype=img.dtype, device=dev).reshape(-1, 1, 1, 1)

    def nearest(v, sy, sx):  # the round-half-down tap of the 2x2 support
        top = torch.where(sx[..., None], v[1], v[0])
        bot = torch.where(sx[..., None], v[3], v[2])
        return torch.where(sy[..., None], bot, top)

    ny, nx = _round_half_down(iy), _round_half_down(ix)
    nin = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)

    if order == 0:
        # the nearest tap always lies inside the bilinear 2x2 support
        val = nearest(g, wy > 0.5, wx > 0.5)
        return torch.where((nin | ~constant)[..., None], val, fill)

    # per-tap constant fill from the RAW (unfolded) indices; the folded
    # modes never fill (their taps are always in range after the fold)
    ry = torch.floor(iy).to(torch.int64)
    rx = torch.floor(ix).to(torch.int64)
    bt = []
    for tap, (dy, dx) in zip(g, ((0, 0), (0, 1), (1, 0), (1, 1))):
        ins = ((ry + dy >= 0) & (ry + dy < h) & (rx + dx >= 0) & (rx + dx < w)) | ~constant
        bt.append(torch.where(ins[..., None], tap[..., :ch], fill))
    wy_, wx_ = wy[..., None], wx[..., None]
    top = bt[0] * (1 - wx_) + bt[1] * wx_
    bot = bt[2] * (1 - wx_) + bt[3] * wx_
    out = top * (1 - wy_) + bot * wy_
    if nn is None:
        return out
    nn_out = nearest([t[..., cp - 1:] for t in g], wy > 0.5, wx > 0.5)[..., 0]
    return out, torch.where(nin, nn_out, torch.zeros((), dtype=img.dtype, device=dev))


# --------------------------------------------------------------------- #
# intensity family: each op takes a batch of images (N, H, W, C) in [0, 255]
# and its per-sample parameters as (N, ...) tensors
def _edge_index(n: int, r: int, device):
    """Indices of an edge (replicate) pad by ``r`` on each side."""
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def _reflect_index(n: int, device):
    """Indices of a reflect pad by 1 (``np.pad`` mode="reflect": abcba)."""
    i = torch.arange(-1, n + 1, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _separable(img, wgt, r: int):
    """Separable filter with per-sample taps ``wgt`` (N, 2r+1) and edge
    padding: rows first, then columns, each a sum of shifted products in tap
    order (as the JAX package sums them)."""
    n, h, w, _ = img.shape
    wgt = wgt[:, :, None, None, None]
    o = img[:, _edge_index(h, r, img.device)]
    out = 0.0
    for i in range(2 * r + 1):
        out = out + wgt[:, i] * o[:, i:i + h]
    o = out[:, :, _edge_index(w, r, img.device)]
    out = 0.0
    for i in range(2 * r + 1):
        out = out + wgt[:, i] * o[:, :, i:i + w]
    return out


def _gaussian_blur(img, sigma, max_radius: int = 5):
    """Separable gaussian with per-sample ``sigma`` (N,): a static kernel
    width, the weights exp(-x^2 / 2 sigma^2) normalised."""
    x = torch.arange(-max_radius, max_radius + 1, dtype=torch.float32, device=img.device)
    sig = torch.clamp(sigma.to(torch.float32), min=1e-3)[:, None]
    k = torch.exp(-0.5 * (x / sig) ** 2)
    return _separable(img, k / k.sum(-1, keepdim=True), max_radius)


def _avg_blur(img, k):
    """Separable box blur with per-sample width ``k`` (N,) in [1, 7]
    (iaa.AverageBlur). Even widths use half-weighted edge taps (the average of
    the two centred odd boxes)."""
    offs = torch.arange(-3, 4, dtype=torch.float32, device=img.device)
    half = (k.to(torch.float32)[:, None] - 1.0) / 2.0
    wgt = torch.clamp(half - offs.abs() + 1.0, 0.0, 1.0)
    return _separable(img, wgt / wgt.sum(-1, keepdim=True), 3)


def _median_blur(img, k):
    """Integer median filter with per-sample ODD ``k`` (N,) in [1, 11]
    (iaa.MedianBlur), edge padding; the input is rounded half to even and
    clipped to [0, 255] first (imgaug's uint8 round trip).

    Every pixel's 11 x 11 window is unfolded into 121 uint8 taps. The
    121 - k^2 taps outside the k x k window (an even number) are replaced,
    half by 0 and half by 255; the middle of the 121 sorted values is then the
    median of the k^2 taps that count. The answer is an integer, bit-equal to
    the JAX package's bit descent."""
    n, h, w, c = img.shape
    r = 5
    dev = img.device
    x = torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)
    xp = x[:, _edge_index(h, r, dev)][:, :, _edge_index(w, r, dev)]
    taps = xp.unfold(1, 2 * r + 1, 1).unfold(2, 2 * r + 1, 1)  # (n, h, w, c, 11, 11) view
    taps = taps.reshape(n, h, w, c, (2 * r + 1) ** 2)
    d = torch.arange(-r, r + 1, device=dev)
    ring = torch.maximum(d[:, None].abs(), d[None, :].abs()).reshape(-1)  # (121,) Chebyshev distance
    outside = ring[None] > ((k.to(torch.int64) - 1) // 2)[:, None]  # (n, 121)
    rank = torch.cumsum(outside.to(torch.int64), dim=1) - 1
    fill = torch.where(rank % 2 == 0, 0, 255).to(torch.uint8)
    taps = torch.where(outside[:, None, None, None], fill[:, None, None, None], taps)
    return taps.median(dim=-1).values.to(torch.float32)


def _conv3(img, kernel):
    """3x3 per-sample ``kernel`` (N, 3, 3) over every channel, reflect
    padding (cv2 filter2D)."""
    n, h, w, _ = img.shape
    x = img[:, _reflect_index(h, img.device)][:, :, _reflect_index(w, img.device)]
    kernel = kernel[..., None, None, None]
    out = 0.0
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[:, dy, dx] * x[:, dy:dy + h, dx:dx + w]
    return out


def _kernel3(rows, like):
    """A (N, 3, 3) kernel from nested lists of (N,) tensors and floats
    (``like``: an (N,) tensor on the device)."""
    return torch.stack([torch.stack([v if torch.is_tensor(v) else torch.full_like(like, v) for v in row], -1)
                        for row in rows], -2)


def _blend3(alpha, eff):
    """(1 - alpha) * identity + alpha * ``eff``, per sample."""
    ident = _kernel3([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], alpha)
    a = alpha[:, None, None]
    return (1.0 - a) * ident + a * eff


def _sharpen(img, alpha, lightness):
    """iaa.Sharpen: blend identity with [[-1,-1,-1],[-1,8+l,-1],[-1,-1,-1]]."""
    return _conv3(img, _blend3(alpha, _kernel3([[-1.0, -1.0, -1.0], [-1.0, 8.0 + lightness, -1.0],
                                                 [-1.0, -1.0, -1.0]], alpha)))


def _emboss(img, alpha, strength):
    """iaa.Emboss: blend identity with the diagonal relief kernel."""
    s = strength
    return _conv3(img, _blend3(alpha, _kernel3([[-1.0 - s, -s, 0.0], [-s, 1.0, s], [0.0, s, 1.0 + s]], s)))


def _directed_edge_kernel(direction):
    """(N, 3, 3) ``iaa.DirectedEdgeDetect`` effect matrices for ``direction``
    (N,) ~ U(0, 1) (0 = from the top, clockwise): the angle quantised to whole
    degrees, each of the 8 neighbours weighted by (1 - angle between/180)^4,
    the weights normalised and negated, the centre set to 1."""
    deg = torch.remainder(torch.floor(direction * 360.0), 360.0)
    rad = torch.deg2rad(deg) - 0.5 * torch.pi
    dx, dy = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
    offs = torch.arange(-1.0, 2.0, device=direction.device)
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")  # [y+1, x+1] cell (x, y)
    norm = torch.sqrt(gx * gx + gy * gy)
    cosang = torch.clamp((gx * dx + gy * dy) / torch.where(norm == 0, 1.0, norm), -1.0, 1.0)
    sim = (1.0 - torch.arccos(cosang) / torch.pi) ** 4
    centre = (gx == 0) & (gy == 0)
    sim = torch.where(centre, 0.0, sim)
    m = -sim / sim.sum((-2, -1), keepdim=True)
    return torch.where(centre, 1.0, m)


_PERLIN_G = 16  # max lattice cells across a dimension (imgaug size_px_max hi)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _perlin_eval_sep(theta, u, v):
    """Perlin noise on a separable grid, per sample: ``theta`` (N, S, S)
    gradient angles (the unit gradient at lattice node (i, j) is
    (sin, cos)), ``u`` (N, h) row lattice coordinates, ``v`` (N, w) column
    coordinates -> (N, h, w): the quintic-fade bilinear blend of the four
    corner gradient . offset dots."""
    i0, j0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - i0)[:, :, None], (v - j0)[:, None, :]
    i0, j0 = i0.to(torch.int64), j0.to(torch.int64)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    item = torch.arange(theta.shape[0], device=theta.device)[:, None, None]

    def grad_dot(di, dj):
        rows, cols = (i0 + di)[:, :, None], (j0 + dj)[:, None, :]
        return sin_t[item, rows, cols] * (fu - di) + cos_t[item, rows, cols] * (fv - dj)

    wu, wv = _fade(fu), _fade(fv)
    n0 = grad_dot(0, 0) * (1 - wv) + grad_dot(0, 1) * wv
    n1 = grad_dot(1, 0) * (1 - wv) + grad_dot(1, 1) * wv
    return n0 * (1 - wu) + n1 * wu


def _perlin_mask(n_iter, g, nearest, theta, thresh, h: int, w: int):
    """Gradient-noise alpha masks (N, h, w) in [0, 1], the imgaug
    SimplexNoiseAlpha recipe: per octave i < ``n_iter`` (N,) in 1..3, a noise
    layer of ``g`` (N, 3) lattice cells across, sampled continuously or, where
    ``nearest`` (N, 3), at the lattice's raster centres, from the angle
    lattices ``theta`` (N, 3, S, S); the octaves aggregated by max; sigmoid
    shaping with the threshold ``thresh`` (N,) ~ N(0, 5)."""
    dev = theta.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)
    xx = torch.arange(w, dtype=torch.float32, device=dev)
    mask = torch.zeros((theta.shape[0], h, w), dtype=torch.float32, device=dev)
    for i in range(3):
        gi = g[:, i].to(torch.float32)[:, None]
        u, v = yy * (gi / h), xx * (gi / w)
        near = nearest[:, i, None]
        u = torch.where(near, torch.floor(u) + 0.5, u)
        v = torch.where(near, torch.floor(v) + 0.5, v)
        val = _perlin_eval_sep(theta[:, i], u, v)  # ~[-0.707, 0.707]
        octave = torch.clamp(0.5 + val * (0.5 / 0.70710678), 0.0, 1.0)
        mask = torch.maximum(mask, torch.where((i < n_iter)[:, None, None], octave, 0.0))
    return torch.sigmoid(20.0 * (mask - 0.5) + thresh[:, None, None])


def _simplex_edge(img, alpha, directed, direction, perlin):
    """iaa.SimplexNoiseAlpha(OneOf(EdgeDetect, DirectedEdgeDetect)): the
    laplacian or, where ``directed``, the direction-weighted kernel, blended
    with identity by ``alpha``; the result clipped and mixed into the image
    through the Perlin mask (``perlin``: the arguments of
    :func:`_perlin_mask`)."""
    _, h, w, _ = img.shape
    lap = _kernel3([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], alpha)
    eff = torch.where(directed[:, None, None], _directed_edge_kernel(direction), lap)
    edged = torch.clamp(_conv3(img, _blend3(alpha, eff)), 0.0, 255.0)
    mask = _perlin_mask(*perlin, h, w)[..., None]
    return mask * edged + (1.0 - mask) * img


def _rgb_to_hsv(img):
    """cv2 8-bit convention: H in [0, 180), S/V in [0, 255]. Channel 0 is
    read as red, as the JAX package reads it."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = v - mn
    safe = torch.where(d > 0, d, 1.0)
    hr = 30.0 * (g - b) / safe
    hg = 60.0 + 30.0 * (b - r) / safe
    hb = 120.0 + 30.0 * (r - g) / safe
    hue = torch.where(v == r, hr, torch.where(v == g, hg, hb))
    hue = torch.where(d > 0, torch.remainder(hue, 180.0), 0.0)
    sat = torch.where(v > 0, 255.0 * d / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([hue, sat, v], dim=-1)


def _hsv_to_rgb(hsv):
    hue, sat, v = hsv[..., 0], hsv[..., 1] / 255.0, hsv[..., 2]
    hp = torch.remainder(hue, 180.0) / 30.0  # sector in [0, 6)
    i = torch.floor(hp)
    f = hp - i
    p = v * (1.0 - sat)
    q = v * (1.0 - sat * f)
    t = v * (1.0 - sat * (1.0 - f))
    i = i.to(torch.int32)
    conds = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r = _select(conds, [v, q, p, p, t], v)
    g = _select(conds, [t, v, v, q, p], p)
    b = _select(conds, [p, p, t, v, v], q)
    return torch.stack([r, g, b], dim=-1)


def _add_hue_sat(img, val):
    """iaa.AddToHueAndSaturation: one value per sample ``val`` (N,) added to
    H (wrapping) and S (clipped) in cv2 HSV space."""
    hsv = _rgb_to_hsv(img)
    val = val[:, None, None]
    hue = torch.remainder(hsv[..., 0] + val, 180.0)
    sat = torch.clamp(hsv[..., 1] + val, 0.0, 255.0)
    return torch.clamp(_hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], -1)), 0.0, 255.0)


def _resize_linear_weights(n_in: int, n_out: int, device):
    """(n_out, n_in) weights of ``jax.image.resize(..., "linear")`` along one
    axis: a triangle kernel at sample positions (i + 0.5) / scale - 0.5,
    widened by 1/scale when downsampling (antialiasing), normalised over the
    taps inside the input, zero where a sample lies outside it."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    wgt = torch.clamp(1.0 - x.abs(), min=0.0)
    total = wgt.sum(0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    wgt = torch.where(total.abs() > 1000.0 * eps, wgt / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], wgt, 0.0).T.contiguous()


def _resize_linear(x, h: int, w: int):
    """(N, H0, W0, C) -> (N, h, w, C) as ``jax.image.resize(..., "linear")``."""
    _, h0, w0, _ = x.shape
    if h != h0:
        x = torch.einsum("yh,nhwc->nywc", _resize_linear_weights(h0, h, x.device), x)
    if w != w0:
        x = torch.einsum("xw,nywc->nyxc", _resize_linear_weights(w0, w, x.device), x)
    return x


def _nearest_index(n_in: int, n_out: int, device):
    """Source index of each output of ``jax.image.resize(..., "nearest")``:
    floor((i + 0.5) * n_in / n_out) in float32."""
    return torch.floor((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out).to(torch.int64)


_SP_K = 200  # static centre count (n_segments upper bound)


def _superpixel_size(h: int, w: int):
    """Internal resolution of the superpixels (imgaug's ``max_size=128``)."""
    factor = max(1, -(-max(h, w) // 128))
    return factor, h // factor, w // factor


def _superpixels(img, n, ys, xs, p_rep, u_rep):
    """iaa.Superpixels(p_replace=(0,1), n_segments=(20,200)) via a k-means
    SLIC approximation at <=128 px, per sample: ``n`` (N,) live centres of
    200, seeded at pixels ``ys``, ``xs`` (N, 200) of the downscaled image;
    compactness m=10 on dc^2 + (m/S)^2 ds^2; two refinements; each segment's
    pixels replaced by the segment mean where ``u_rep`` (N, 200) < ``p_rep``
    (N,). Per-segment sums are one-hot matrix products: deterministic."""
    nb, h, w, c = img.shape
    dev = img.device
    factor, hs, ws = _superpixel_size(h, w)
    small = _resize_linear(img, hs, ws) if factor > 1 else img
    active = torch.arange(_SP_K, device=dev)[None] < n[:, None]  # (N, K)
    spatial_w = 10.0 / torch.sqrt(hs * ws / n.to(torch.float32))  # m / S, (N,)
    yy = torch.arange(hs, dtype=torch.float32, device=dev)[:, None].expand(hs, ws).reshape(1, -1, 1)
    xx = torch.arange(ws, dtype=torch.float32, device=dev)[None, :].expand(hs, ws).reshape(1, -1, 1)
    sw = spatial_w[:, None, None]
    flat = small.reshape(nb, hs * ws, c)
    feats = torch.cat([flat / 255.0, yy * sw, xx * sw], dim=2)  # (N, P, c+2)
    item = torch.arange(nb, device=dev)[:, None]
    centers = torch.cat([small[item, ys, xs] / 255.0, ys[..., None].to(torch.float32) * sw,
                         xs[..., None].to(torch.float32) * sw], dim=2)  # (N, K, c+2)
    ff = torch.sum(feats * feats, 2, keepdim=True)

    def assign(centers):
        d = ff - (2.0 * feats) @ centers.transpose(1, 2) + torch.sum(centers * centers, 2)[:, None]
        d = torch.where(active[:, None], d, 1e9)
        return (torch.argmin(d, dim=2)[..., None] == torch.arange(_SP_K, device=dev)).to(torch.float32)

    onehot = assign(centers)
    ones = torch.ones((nb, hs * ws, 1), dtype=torch.float32, device=dev)
    feats1 = torch.cat([feats, ones], 2)
    for _ in range(2):  # k-means refinement
        sums = onehot.transpose(1, 2) @ feats1
        centers = sums[..., :-1] / torch.clamp(sums[..., -1:], min=1.0)
        onehot = assign(centers)
    mean_col = onehot.transpose(1, 2) @ torch.cat([flat, ones], 2)
    mean_col = mean_col[..., :c] / torch.clamp(mean_col[..., -1:], min=1.0)  # (N, K, c)
    rep = (u_rep < p_rep[:, None]).to(torch.float32)
    # the per-pixel lookup as one more product at the small resolution,
    # upsampled nearest afterwards
    looked = (onehot @ torch.cat([mean_col, rep[..., None]], 2)).reshape(nb, hs, ws, c + 1)
    if factor > 1:
        looked = looked[:, _nearest_index(hs, h, dev)][:, :, _nearest_index(ws, w, dev)]
    return torch.where(looked[..., c:] > 0.5, looked[..., :c], img)


def _dropout(img, p, drop_u, p2, size_u, coarse_u, fine):
    """OneOf{Dropout(p), CoarseDropout(p2, size_percent)}: ``fine`` (N,)
    picks the pixel dropout (keep where ``drop_u`` (N, H, W, C) >= ``p``),
    else the coarse one: a keep-mask raster of ``coarse_u`` (N, Gh, Gw, C) at
    the sampled granularity round(``size_u`` * (h, w)), clipped to [2, G]."""
    _, h, w, _ = img.shape
    dev = img.device
    pixel = img * (drop_u >= p[:, None, None, None]).to(img.dtype)
    gmax_h, gmax_w = coarse_u.shape[1:3]
    gh = torch.clamp(torch.round(size_u * h), 2, gmax_h)
    gw = torch.clamp(torch.round(size_u * w), 2, gmax_w)
    iy = (torch.arange(h, dtype=torch.float32, device=dev) * gh[:, None] / h).to(torch.int64)
    ix = (torch.arange(w, dtype=torch.float32, device=dev) * gw[:, None] / w).to(torch.int64)
    keep = (coarse_u >= p2[:, None, None, None]).to(img.dtype)
    item = torch.arange(img.shape[0], device=dev)[:, None, None]
    coarse = img * keep[item, iy[:, :, None], ix[:, None, :]]
    return torch.where(fine[:, None, None, None], pixel, coarse)


def _coarse_grid(cfg: "AugmentConfig", h: int, w: int):
    """The static raster of the coarse-dropout keep-mask (5% of the image)."""
    return max(2, int(cfg.coarse_size[1] * h) + 1), max(2, int(cfg.coarse_size[1] * w) + 1)


# The twelve intensity entries of the SomeOf list, in the reference's order:
# (name, its draws, fn(images, *draws) -> images). The blur entry is split by
# its OneOf choice into three ops.
def _hue_or_identity(img, val):
    return _add_hue_sat(img, val) if img.shape[-1] == 3 else img


_OPS = {
    "superpixels": (("sp_n", "sp_ys", "sp_xs", "sp_p", "sp_u"), _superpixels),
    "gaussian_blur": (("blur_sigma",), _gaussian_blur),
    "average_blur": (("avg_k",), _avg_blur),
    "median_blur": (("median_k",), _median_blur),
    "sharpen": (("sharpen_alpha", "sharpen_lightness"), _sharpen),
    "emboss": (("emboss_alpha", "emboss_strength"), _emboss),
    "simplex_edge": (("edge_alpha", "edge_directed", "edge_direction", "perlin_n", "perlin_g", "perlin_nearest",
                      "perlin_theta", "perlin_thresh"),
                     lambda im, a, d, dr, *perlin: _simplex_edge(im, a, d, dr, perlin)),
    "noise": (("noise_scale", "noise"), lambda im, s, z: im + z * s[:, None, None, None]),
    "dropout": (("drop_p", "drop_u", "coarse_p", "coarse_size", "coarse_u", "drop_fine"), _dropout),
    "invert": (("invert_ch",), lambda im, inv: torch.where(inv[:, None, None, :], 255.0 - im, im)),
    "add": (("add",), lambda im, v: im + v[:, None, None, :]),
    "hue_saturation": (("hue",), _hue_or_identity),
    "multiply": (("multiply",), lambda im, v: im * v[:, None, None, :]),
    "grayscale": (("gray_alpha",),
                  lambda im, a: im + a[:, None, None, None] * (torch.mean(im, -1, keepdim=True) - im)),
}
ENTRIES = ("superpixels", "blur", "sharpen", "emboss", "simplex_edge", "noise", "dropout", "invert", "add",
           "hue_saturation", "multiply", "grayscale")
BLURS = ("gaussian_blur", "average_blur", "median_blur")  # the blur entry's OneOf, by its choice 0, 1, 2
MEMBERS = ENTRIES + ("elastic", "piecewise", "perspective")  # the 15 SomeOf members of the heavy pipeline
_WRAPPED = (0, 12, 13, 14)  # the members inside Sometimes(0.5)


def apply_op(name: str, images, draws):
    """One intensity op on every image of ``images``, with the draws of the
    same samples."""
    keys, fn = _OPS[name]
    return fn(images, *(draws[k] for k in keys))


# --------------------------------------------------------------------- #
# the SomeOf geometry members: a homography and a displacement field
def perspective_from_params(gate, scale, jitter, h: int, w: int):
    """iaa.PerspectiveTransform per sample: the inverse homography (B, 3, 3)
    sending the output corners to corners jittered by ``jitter`` (B, 4, 2)
    ~ N(0, 1) times ``scale`` (B,) times (h, w), where ``gate`` (B,); a DLT on
    4 points, solved as (A + 1e-8 I) h = b. ``torch.linalg.solve_ex`` does not
    check for a singular system, which would wait for the device."""
    f32 = torch.float32
    dev = jitter.device
    b = jitter.shape[0]
    jit = jitter.to(f32) * scale.to(f32)[:, None, None]
    jit = torch.where(gate[:, None, None], torch.stack([jit[..., 0] * float(h), jit[..., 1] * float(w)], -1), 0.0)
    corner = torch.arange(4, device=dev)  # (0, 0), (0, w-1), (h-1, 0), (h-1, w-1)
    y = ((corner // 2).to(f32) * (h - 1.0)).expand(b, 4)
    x = ((corner % 2).to(f32) * (w - 1.0)).expand(b, 4)
    u, v = y + jit[..., 0], x + jit[..., 1]  # the jittered input corners
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    row_u = torch.stack([y, x, one, zero, zero, zero, -u * y, -u * x], -1)  # (B, 4, 8)
    row_v = torch.stack([zero, zero, zero, y, x, one, -v * y, -v * x], -1)
    a = torch.stack([row_u, row_v], 2).reshape(b, 8, 8)
    rhs = torch.stack([u, v], 2).reshape(b, 8)
    hvec, _ = torch.linalg.solve_ex(a + 1e-8 * torch.eye(8, device=dev), rhs)
    return torch.cat([hvec, torch.ones((b, 1), dtype=f32, device=dev)], 1).reshape(b, 3, 3)


def piecewise_field(grid, scale, h: int, w: int):
    """iaa.PiecewiseAffine's induced smooth field: the (B, 4, 4, 2) control
    grid ~ N(0, 1) upsampled ``linear`` to (h, w) and scaled by
    ``scale`` (B,) times (h, w)."""
    coarse = _resize_linear(grid.to(torch.float32), h, w) * scale.to(torch.float32)[:, None, None, None]
    return torch.stack([coarse[..., 0] * float(h), coarse[..., 1] * float(w)], -1)


# --------------------------------------------------------------------- #
# draws, then arithmetic
def _uniform(generator, lo_hi, shape, device):
    lo, hi = lo_hi
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


def _legacy_probs(cfg: AugmentConfig):
    """Independent per-member gates of the legacy mode (``someof_n == 0``),
    indexed as :data:`MEMBERS`."""
    g = cfg.intensity_gate
    return ([cfg.superpixels_prob] + [g] * 6 + [g if cfg.invert_prob > 0 else 0.0] + [g] * 4
            + [cfg.elastic_prob, cfg.piecewise_prob, cfg.perspective_prob])


def live_members(cfg: AugmentConfig):
    """Indices into :data:`MEMBERS` of the members that can fire: the first
    ``someof_n`` by the SomeOf draw; in the legacy mode (``someof_n == 0``)
    the intensity entries whose gate is not 0; the geometry members beyond
    ``someof_n`` whose own gate is not 0."""
    probs = _legacy_probs(cfg)
    n = cfg.someof_n
    return [i for i in range(15) if i < n or (probs[i] > 0 and (n == 0 or i >= 12))]


def _host_generator(generator, host_generator):
    if host_generator is not None:
        return host_generator
    if generator.device.type == "cpu":
        return generator
    raise ValueError("the heavy, medium and legacy pipelines decide the order and the members that fire on the host: "
                     "pass host_generator, a torch.Generator on the CPU")


@torch.no_grad()
def sample_draws(generator: torch.Generator, cfg: AugmentConfig, b: int, device, shape=None,
                 host_generator: Optional[torch.Generator] = None) -> Dict[str, Optional[torch.Tensor]]:
    """Every random number one call of the pipeline ``cfg`` needs, for a batch
    of ``b`` images of ``shape`` (H, W, C).

    The outer children's: the per-batch order of the five outer children,
    and per sample the four gates, the children's raw parameters (see
    :func:`child_matrices_from_params`), the fill value ``cval`` ~ U(0, 255)
    and, under ``border_mode_all``, the border ``mode`` ~ U{0..4}. The light
    family needs nothing more, and ``shape`` may be omitted for it.

    Where a SomeOf member or a legacy gate can fire, also: on the CPU, from
    ``host_generator`` (default: ``generator`` when that lives on the CPU),
    the decisions the host needs to order the work without waiting for the
    device -- ``order5`` (then drawn here instead), ``perm12`` (the
    intensity entries' per-batch order), ``coin`` (the intensity block's
    side when it falls between the warp children), ``active`` (B, 15) (the
    members that fire: exactly k ~ U{someof_count} of ``someof_n`` by a rank
    draw, thinned by the Sometimes(0.5) coin on members 0, 12, 13, 14; in
    the legacy mode independent gates) and ``blur_choice`` (B,) (the blur
    OneOf); and on ``device`` each live member's parameters, the per-channel
    or shared forms already resolved (see :data:`_OPS`)."""
    u = lambda *s: torch.rand(s, generator=generator, device=device)  # noqa: E731
    live = live_members(cfg)
    host = _host_generator(generator, host_generator) if live else None
    order5 = torch.randperm(5, generator=host if cfg.someof_n > 0 else generator, device="cpu" if cfg.someof_n > 0 else device)
    gates = u(b, 4)
    probs = (cfg.fliplr, cfg.flipud, cfg.croppad_prob, cfg.affine_prob)
    tx_range = cfg.translate_x if cfg.translate_x is not None else cfg.translate
    d = {
        "order5": order5,
        "gates": torch.stack([gates[:, j] < p for j, p in enumerate(probs)], dim=-1),
        "p4": _uniform(generator, cfg.croppad, (b, 4), device),
        "sy": _uniform(generator, cfg.scale, (b,), device),
        "sx": _uniform(generator, cfg.scale, (b,), device),
        "theta_deg": _uniform(generator, cfg.rotate, (b,), device),
        "shear_deg": _uniform(generator, cfg.shear, (b,), device),
        "t": torch.stack(
            [_uniform(generator, cfg.translate, (b,), device), _uniform(generator, tx_range, (b,), device)], dim=-1
        ),
        "snap_u": u(b),
        "cval": _uniform(generator, (0.0, 255.0), (b,), device),
        "mode": torch.randint(0, 5, (b,), generator=generator, device=device, dtype=torch.int32)
        if cfg.border_mode_all
        else None,
    }
    if not live:
        return d
    d.update(_sample_host_draws(host, cfg, b))
    h, w, c = shape
    d.update(_sample_member_draws(generator, cfg, live, b, h, w, c, device))
    return d


# the draws of :func:`sample_draws` made once for the whole batch; every other
# draw holds one row per sample
_BATCH_DRAWS = ("order5", "perm12", "coin")


def draw_rows(draws: Dict[str, Optional[torch.Tensor]], lo: int, hi: int) -> Dict[str, Optional[torch.Tensor]]:
    """The draws of samples ``lo:hi`` of the batch ``draws`` were made for
    (a data-parallel rank's rows of the global batch's draws)."""
    return {k: v if v is None or k in _BATCH_DRAWS else v[lo:hi] for k, v in draws.items()}


def _sample_host_draws(host: torch.Generator, cfg: AugmentConfig, b: int):
    hu = lambda *s: torch.rand(s, generator=host)  # noqa: E731
    if cfg.someof_n > 0:
        n = cfg.someof_n
        k = torch.randint(cfg.someof_count[0], cfg.someof_count[1] + 1, (b, 1), generator=host)
        ranks = torch.argsort(torch.argsort(hu(b, n), dim=1), dim=1)
        active = torch.zeros((b, 15), dtype=torch.bool)
        active[:, :n] = ranks < k
        coin = hu(b, len(_WRAPPED)) < cfg.sometimes_p
        active[:, list(_WRAPPED)] &= coin
        for j in range(max(n, 12), 15):  # a geometry member outside the SomeOf list keeps its own gate
            active[:, j] = hu(b) < _legacy_probs(cfg)[j]
    else:
        active = hu(b, 15) < torch.tensor(_legacy_probs(cfg))
    return {
        "perm12": torch.randperm(12, generator=host),
        "coin": hu() < 0.5,
        "active": active,
        "blur_choice": torch.randint(0, 3, (b,), generator=host),
    }


def _sample_member_draws(generator, cfg: AugmentConfig, live, b: int, h: int, w: int, c: int, device):
    u = lambda *s: torch.rand(s, generator=generator, device=device)  # noqa: E731
    normal = lambda *s: torch.randn(s, generator=generator, device=device)  # noqa: E731
    rint = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=generator, device=device)  # noqa: E731
    rng = lambda lo_hi, *s: _uniform(generator, lo_hi, s, device)  # noqa: E731

    def per_channel(p_channel, pc, sh):
        """The per-channel draw where a sample's coin came up, else the shared one."""
        return torch.where((u(b) < p_channel).reshape(-1, *([1] * (pc.dim() - 1))), pc, sh)

    d = {}
    if 0 in live:
        _, hs, ws = _superpixel_size(h, w)
        d.update(sp_n=rint(cfg.superpixels_segments[0], cfg.superpixels_segments[1] + 1, b),
                 sp_ys=rint(0, hs, b, _SP_K), sp_xs=rint(0, ws, b, _SP_K),
                 sp_p=rng(cfg.superpixels_replace, b), sp_u=u(b, _SP_K))
    if 1 in live:
        lo, hi = cfg.median_blur_k
        d.update(blur_sigma=rng(cfg.blur_sigma, b), avg_k=rint(cfg.avg_blur_k[0], cfg.avg_blur_k[1] + 1, b),
                 median_k=2 * rint(lo // 2, hi // 2 + 1, b) + 1)
    if 2 in live:
        d.update(sharpen_alpha=rng(cfg.sharpen_alpha, b), sharpen_lightness=rng(cfg.sharpen_lightness, b))
    if 3 in live:
        d.update(emboss_alpha=rng(cfg.emboss_alpha, b), emboss_strength=rng(cfg.emboss_strength, b))
    if 4 in live:
        side = _PERLIN_G + 2
        d.update(edge_alpha=rng(cfg.edge_alpha, b), edge_directed=u(b) < 0.5, edge_direction=u(b),
                 perlin_n=rint(1, 4, b), perlin_g=rint(2, _PERLIN_G + 1, b, 3), perlin_nearest=u(b, 3) < 0.5,
                 perlin_theta=u(b, 3, side, side) * (2.0 * torch.pi), perlin_thresh=normal(b) * 5.0)
    if 5 in live:
        d.update(noise_scale=rng(cfg.noise_scale, b), noise=per_channel(0.5, normal(b, h, w, c), normal(b, h, w, 1)))
    if 6 in live:
        gh, gw = _coarse_grid(cfg, h, w)
        d.update(drop_p=rng(cfg.dropout, b), drop_u=per_channel(0.5, u(b, h, w, c), u(b, h, w, 1)),
                 coarse_p=rng(cfg.coarse_dropout, b), coarse_size=rng(cfg.coarse_size, b),
                 coarse_u=per_channel(0.2, u(b, gh, gw, c), u(b, gh, gw, 1)), drop_fine=u(b) < 0.5)
    if 7 in live:
        d.update(invert_ch=u(b, c) < cfg.invert_prob)
    if 8 in live:
        d.update(add=per_channel(0.5, rng(cfg.add, b, c), rng(cfg.add, b, 1)))
    if 9 in live:
        d.update(hue=rng(cfg.hue_sat, b))
    if 10 in live:
        d.update(multiply=per_channel(0.5, rng(cfg.multiply, b, c), rng(cfg.multiply, b, 1)))
    if 11 in live:
        d.update(gray_alpha=rng(cfg.grayscale_alpha, b))
    if 12 in live:
        d.update(elastic_alpha=rng(cfg.elastic_alpha, b), elastic_field=rng((-1.0, 1.0), b, h, w, 2))
    if 13 in live:
        d.update(pw_scale=rng(cfg.piecewise_scale, b), pw_grid=normal(b, 4, 4, 2))
    if 14 in live:
        d.update(persp_scale=rng(cfg.perspective_scale, b), persp_jitter=normal(b, 4, 2))
    return d


def _host(draws, key):
    t = draws[key]
    if t.device.type != "cpu":
        raise ValueError(f"draws[{key!r}] must lie on the CPU: the host orders the work by it")
    return t


def _to_device(parts, device):
    """CPU int64 vectors -> the same on ``device``, in one non-blocking copy
    from pinned memory (a blocking copy would wait for the queued work)."""
    if device.type == "cpu" or not parts:
        return parts
    flat = torch.cat(parts).pin_memory().to(device, non_blocking=True)
    return list(torch.split(flat, [len(p) for p in parts]))


def _plan(draws, order, device):
    """The intensity block as (op, sample indices on ``device``) in
    application order, from the host's ``active`` flags and blur choices:
    each op runs on the samples that take it and no others; and the device
    copy of the geometry members' gates (B, 3)."""
    active, choice = _host(draws, "active"), _host(draws, "blur_choice")
    steps = []
    for i in order:
        if i == 1:
            steps += [(BLURS[j], torch.nonzero(active[:, 1] & (choice == j))[:, 0]) for j in range(3)]
        else:
            steps.append((ENTRIES[i], torch.nonzero(active[:, i])[:, 0]))
    steps = [(name, idx) for name, idx in steps if len(idx)]
    moved = _to_device([idx for _, idx in steps] + [active[:, 12:].reshape(-1).to(torch.int64)], device)
    return [(name, idx) for (name, _), idx in zip(steps, moved[:-1])], moved[-1].reshape(-1, 3).to(torch.bool)


def apply_intensity(images, draws, steps):
    """Run the planned ops in order, each on its samples only (an op's result
    for a sample depends on that sample alone), then clip to [0, 255]."""
    for name, idx in steps:
        part = apply_op(name, images.index_select(0, idx), {k: draws[k].index_select(0, idx) for k in _OPS[name][0]})
        images = images.index_copy(0, idx, part)
    return torch.clamp(images, 0.0, 255.0)


@torch.no_grad()
def augment_from_draws(cfg: AugmentConfig, images, masks, draws):
    """The pipeline's arithmetic on the draws of :func:`sample_draws`:
    ``images`` (B, H, W, C) in [0, 255], ``masks`` (B, H, W) integer labels or
    None -> float32 images in [0, 255] and int32 masks (or None).

    The four linear outer children compose in the per-batch drawn order into
    one warp per image, with perspective on the SomeOf block's side of the
    product and the elastic and piecewise fields added to the sample
    coordinates. With SomeOf members, the SomeOf block runs before the warp
    if it was drawn before both live warp children (crop&pad, affine), after
    it if after both, and by the ``coin`` between them; its intensity entries
    run in the ``perm12`` order. The host reads only CPU tensors of the
    draws, so nothing here waits for the device."""
    images = images.to(torch.float32)
    b, h, w, _ = images.shape
    dev = images.device
    live = live_members(cfg)
    intensity_first = False
    if cfg.someof_n > 0:
        pos = torch.argsort(_host(draws, "order5")).tolist()  # pos[child] = application position
        geo_seq = sorted(range(4), key=lambda child: pos[child])
        warp_pos = [pos[child] for child, p in ((2, cfg.croppad_prob), (3, cfg.affine_prob)) if p > 0]
        coin = bool(_host(draws, "coin"))
        if warp_pos:
            before, after = pos[4] < min(warp_pos), pos[4] > max(warp_pos)
            intensity_first = before or (not after and coin)
        else:
            intensity_first = coin
        order = _host(draws, "perm12").tolist()
    else:
        # light/legacy: the drawn order among the linear children, on the device
        pos = torch.argsort(draws["order5"])
        geo_seq = torch.argsort(pos[:4])
        order = range(12)
    steps, member_gates = _plan(draws, order, dev) if live else ([], None)

    def geometry(images, masks):
        mats, any_warp, snap = child_matrices_from_params(
            draws["gates"], draws["p4"], draws["sy"], draws["sx"], draws["theta_deg"], draws["shear_deg"],
            draws["t"], draws["snap_u"], h, w,
        )
        mats = [mats[:, i] for i in geo_seq] if isinstance(geo_seq, list) else mats[:, geo_seq].unbind(1)
        M = mats[0] @ mats[1] @ mats[2] @ mats[3]  # (B, 3, 3) in application order
        disp = None
        if 14 in live:  # inverse maps compose right to left: perspective sits on the SomeOf side
            P = perspective_from_params(member_gates[:, 2], draws["persp_scale"], draws["persp_jitter"], h, w)
            M = P @ M if intensity_first else M @ P
        if 12 in live or 13 in live:
            disp = torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev)
        if 12 in live:
            field = draws["elastic_field"].to(torch.float32) * draws["elastic_alpha"].to(torch.float32)[:, None, None, None]
            disp = disp + torch.where(member_gates[:, 0, None, None, None], field, 0.0)
        if 13 in live:
            field = piecewise_field(draws["pw_grid"], draws["pw_scale"], h, w)
            disp = disp + torch.where(member_gates[:, 1, None, None, None], field, 0.0)
        # border mode and cval apply to the crop&pad/affine IMAGE resample; when
        # neither fired the composite keeps imgaug's defaults (constant 0)
        cval = torch.where(any_warp, draws["cval"].to(torch.float32), 0.0)
        mode = None
        if cfg.border_mode_all:
            mode = torch.where(any_warp, draws["mode"].to(torch.int32), torch.zeros((), dtype=torch.int32, device=dev))
        if masks is not None:
            images, m = _warp_one(images, M, disp, order=1, cval=cval, mode=mode, snap=snap, nn=masks.to(torch.float32))
            return images, m.to(torch.int32)
        return _warp_one(images, M, disp, order=1, cval=cval, mode=mode, snap=snap), None

    if intensity_first:
        images = apply_intensity(images, draws, steps)
        return geometry(images, masks)
    images, masks = geometry(images, masks)
    return apply_intensity(images, draws, steps), masks


def make_augment_fn(cfg: AugmentConfig):
    """Build ``augment(generator, images, masks=None, host_generator=None) ->
    (images, masks)``.

    ``images``: (B, H, W, C) uint8/float tensor in [0, 255]; ``masks``:
    (B, H, W) integer labels (or None). The work runs on the images' device
    and ``generator`` must live there; ``host_generator`` (a CPU generator)
    draws the decisions the host needs (see :func:`sample_draws`). Returns
    float32 images in [0, 255] (normalisation stays downstream, matching the
    reference's order of operations) and int32 masks.
    """

    def augment(generator: torch.Generator, images, masks=None, host_generator: Optional[torch.Generator] = None):
        draws = sample_draws(generator, cfg, images.shape[0], images.device, tuple(images.shape[1:]), host_generator)
        return augment_from_draws(cfg, images, masks, draws)

    return augment
