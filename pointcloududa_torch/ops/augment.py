"""Device-side, batched data augmentation: the **light** pipeline of
``pointcloududa_tpu/ops/augment.py`` (flips + a gentle affine, no intensity
entries), the only one the reference's MM-WHS generator calls
(``src/data_generator_mmwhs.py:87-122``, called at ``:253``).

The configs :func:`heavy` and :func:`medium` are here because they
are data, but :func:`make_augment_fn` builds the light family only
(``someof_n == 0`` and every intensity, elastic, piecewise and perspective
gate at 0): the twelve intensity entries and the three SomeOf geometry
members are still to be ported (ROADMAP Queue 1 item 9).

Structure, as in the JAX package: the four LINEAR children of the outer
``Sequential(random_order=True)`` (Fliplr, Flipud, CropAndPad, Affine) are
per-sample inverse 3x3 maps, composed in an order drawn once per batch
(imgaug's meta augmenters iterate children over the whole batch in one
permutation), and applied as ONE resample per image
(:func:`_warp_one`). Masks ride the same resample as a nearest-neighbour
plane with constant-0 borders (imgaug hardcodes ``mode="constant", cval=0``
for segmentation maps) and never receive intensity ops.

Each sampler is split from its arithmetic: :func:`sample_draws` is the only
function that draws random numbers (from an explicit ``torch.Generator``);
:func:`child_matrices_from_params`, :func:`_warp_one` and
:func:`augment_from_draws` are deterministic functions of tensors, so a test
can feed them the values another framework drew.

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
    c = torch.tensor([(h - 1) / 2.0, (w - 1) / 2.0], dtype=f32, device=sy.device)
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
# the light family: draws, then arithmetic
def _check_light_family(cfg: AugmentConfig) -> None:
    off = (cfg.intensity_gate, cfg.superpixels_prob, cfg.elastic_prob, cfg.piecewise_prob, cfg.perspective_prob)
    if cfg.someof_n > 0 or any(p > 0 for p in off):
        raise NotImplementedError(
            "only the light augmentation family is ported (someof_n == 0, no intensity, elastic, "
            "piecewise or perspective entries); the heavy and medium pipelines are ROADMAP Queue 1 item 9"
        )


def _uniform(generator, lo_hi, shape, device):
    lo, hi = lo_hi
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


@torch.no_grad()
def sample_draws(generator: torch.Generator, cfg: AugmentConfig, b: int, device) -> Dict[str, Optional[torch.Tensor]]:
    """Every random number one call of the light family needs, for a batch of
    ``b`` images: the per-batch order of the five outer children, and per
    sample the four gates, the children's raw parameters (see
    :func:`child_matrices_from_params`), the fill value ``cval`` ~ U(0, 255)
    and, under ``border_mode_all``, the border ``mode`` ~ U{0..4}."""
    u = lambda *shape: torch.rand(shape, generator=generator, device=device)  # noqa: E731
    probs = torch.tensor([cfg.fliplr, cfg.flipud, cfg.croppad_prob, cfg.affine_prob], device=device)
    tx_range = cfg.translate_x if cfg.translate_x is not None else cfg.translate
    return {
        "order5": torch.randperm(5, generator=generator, device=device),
        "gates": u(b, 4) < probs,
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


@torch.no_grad()
def augment_from_draws(cfg: AugmentConfig, images, masks, draws):
    """The light family's arithmetic on the draws of :func:`sample_draws`:
    ``images`` (B, H, W, C) in [0, 255], ``masks`` (B, H, W) integer labels or
    None -> float32 images in [0, 255] and int32 masks (or None)."""
    _check_light_family(cfg)
    images = images.to(torch.float32)
    _, h, w, _ = images.shape
    # per-batch outer order of [Fliplr, Flipud, CropAndPad, Affine, SomeOf]:
    # pos[child] = application position; the 4 linear children in that order
    pos = torch.argsort(draws["order5"])
    geo_seq = torch.argsort(pos[:4])
    mats, any_warp, snap = child_matrices_from_params(
        draws["gates"], draws["p4"], draws["sy"], draws["sx"], draws["theta_deg"], draws["shear_deg"],
        draws["t"], draws["snap_u"], h, w,
    )
    mats = mats[:, geo_seq]  # (B, 4, 3, 3) in application order
    M = mats[:, 0] @ mats[:, 1] @ mats[:, 2] @ mats[:, 3]
    # border mode and cval apply to the crop&pad/affine IMAGE resample; when
    # neither fired the composite keeps imgaug's defaults (constant 0)
    zero = torch.zeros((), dtype=torch.float32, device=images.device)
    cval = torch.where(any_warp, draws["cval"].to(torch.float32), zero)
    mode = None
    if cfg.border_mode_all:
        mode = torch.where(any_warp, draws["mode"].to(torch.int32), torch.zeros((), dtype=torch.int32, device=images.device))
    if masks is not None:
        images, m = _warp_one(images, M, None, order=1, cval=cval, mode=mode, snap=snap, nn=masks.to(torch.float32))
        masks = m.to(torch.int32)
    else:
        images = _warp_one(images, M, None, order=1, cval=cval, mode=mode, snap=snap)
    # every intensity gate of the family is 0: what is left of the intensity
    # block is its final clip
    return torch.clamp(images, 0.0, 255.0), masks


def make_augment_fn(cfg: AugmentConfig):
    """Build ``augment(generator, images, masks=None) -> (images, masks)``.

    ``images``: (B, H, W, C) uint8/float tensor in [0, 255]; ``masks``:
    (B, H, W) integer labels (or None). The work runs on the images' device
    and ``generator`` must live there. Returns float32 images in [0, 255]
    (normalisation stays downstream, matching the reference's order of
    operations) and int32 masks. Raises ``NotImplementedError`` for a config
    outside the light family.
    """
    _check_light_family(cfg)

    def augment(generator: torch.Generator, images, masks=None):
        draws = sample_draws(generator, cfg, images.shape[0], images.device)
        return augment_from_draws(cfg, images, masks, draws)

    return augment
