"""Host-side (numpy) augmentation: the slow-path twin of ``ops/augment.py``
(counterpart of the JAX package's ``ops/host_augment.py``).

Exists for one reason (SURVEY.md §7 "hard parts"): the MM-WHS point-cloud
path of the reference regenerates vertex ground truth from the *warped*
masks (``src/data_generator_mmwhs.py:256-264``), which needs the warped mask
on the host before batch assembly. ``build_mmwhs_pipelines(...,
host_cloud_regen=True)`` and the MS-CMRSeg CLI's ``-host_aug`` run it in the
loader's feeder thread, overlapped with the step on the card; every other
configuration uses the device pipeline.

It is a full twin: the same 15-entry SomeOf family as the device pipeline,
gates and parameter ranges read from the same
:class:`~pointcloududa_torch.ops.augment.AugmentConfig`, per-batch outer and
SomeOf orders, without-replacement SomeOf draws, Perlin-gradient simplex
masks and sampled coarse-dropout granularity. Every draw comes from the
caller's numpy ``Generator`` in the JAX package's order, so one seed gives
both packages' twins the same stream (the Generator's state after a call is
equal). Where the JAX package calls OpenCV, this module calls
``ops/host_image.py``: numpy versions of the same operations, equal to
OpenCV 5.0 bit for bit apart from the Gaussian blur's taps and the 2-channel
resize of the piecewise grid, each within an ulp or two (see that module).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from pointcloududa_torch.ops import augment as augment_cfg
from pointcloududa_torch.ops import host_image


def _child_mats_np(rng, h, w, cfg: "augment_cfg.AugmentConfig"):
    """Forward 3x3 (y, x, 1) maps for the four linear outer children
    [Fliplr, Flipud, CropAndPad, Affine] — numpy twin of the device
    ``_child_matrices`` (forward form; the caller composes them in the
    per-batch drawn order). CropAndPad samples its percent PER SIDE
    (``sample_independently=True``); the affine translate ranges are
    per-axis. Returns ``(mats, any_warp, aff_fired)``."""
    eye = np.eye(3)
    m_lr = (
        np.array([[1.0, 0.0, 0.0], [0.0, -1.0, w - 1.0], [0.0, 0.0, 1.0]])
        if rng.uniform() < cfg.fliplr
        else eye
    )
    m_ud = (
        np.array([[-1.0, 0.0, h - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        if rng.uniform() < cfg.flipud
        else eye
    )
    gate_cp = rng.uniform() < cfg.croppad_prob
    pt, pb, pl, pr = rng.uniform(*cfg.croppad, size=4) if gate_cp else (0.0,) * 4
    sy_cp, sx_cp = 1.0 + pt + pb, 1.0 + pl + pr
    # forward per axis (keep_size pixel-center resize): out = (in + 0.5 + p_lo*n)/s - 0.5
    m_cp = np.array(
        [
            [1.0 / sy_cp, 0.0, (0.5 + pt * h) / sy_cp - 0.5],
            [0.0, 1.0 / sx_cp, (0.5 + pl * w) / sx_cp - 0.5],
            [0.0, 0.0, 1.0],
        ]
    )
    gate_aff = rng.uniform() < cfg.affine_prob
    sy = rng.uniform(*cfg.scale) if gate_aff else 1.0
    sx = rng.uniform(*cfg.scale) if gate_aff else 1.0
    theta = np.deg2rad(rng.uniform(*cfg.rotate)) if gate_aff else 0.0
    sh = np.deg2rad(rng.uniform(*cfg.shear)) if gate_aff else 0.0
    tx_range = cfg.translate_x if cfg.translate_x is not None else cfg.translate
    t = (
        np.array([rng.uniform(*cfg.translate), rng.uniform(*tx_range)])
        if gate_aff
        else np.zeros(2)
    )  # (ty, tx): per-axis translate_percent ranges (light: x (-0.1, 0.05))
    ty, tx = t[0] * h, t[1] * w
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    shr = np.array([[1.0, 0.0], [np.tan(sh), 1.0]])
    scl = np.array([[sy, 0.0], [0.0, sx]])
    a = rot @ shr @ scl
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    offset = center + np.array([ty, tx]) - a @ center
    m_aff = np.array(
        [
            [a[0, 0], a[0, 1], offset[0]],
            [a[1, 0], a[1, 1], offset[1]],
            [0.0, 0.0, 1.0],
        ]
    )
    return [m_lr, m_ud, m_cp, m_aff], (gate_aff or gate_cp), gate_aff


def _kernel3(alpha, eff):
    ident = np.zeros((3, 3), np.float32)
    ident[1, 1] = 1.0
    return (1.0 - alpha) * ident + alpha * eff


def _superpixels_np(rng, img, cfg):
    """Downscaled k-means SLIC, numpy twin of the device kernel."""
    h, w, c = img.shape
    factor = max(1, -(-max(h, w) // 128))
    small = host_image.resize_linear(img, (w // factor, h // factor)) if factor > 1 else img
    if small.ndim == 2:
        small = small[..., None]
    hs, ws = small.shape[:2]
    n = int(rng.integers(cfg.superpixels_segments[0], cfg.superpixels_segments[1] + 1))
    ys = rng.integers(0, hs, n)
    xs = rng.integers(0, ws, n)
    sw = 10.0 / math.sqrt(hs * ws / n)
    yy, xx = np.mgrid[0:hs, 0:ws].astype(np.float32)
    feats = np.concatenate(
        [small.reshape(-1, c) / 255.0, (yy.reshape(-1, 1) * sw), (xx.reshape(-1, 1) * sw)], 1
    )
    centers = np.concatenate(
        [small[ys, xs] / 255.0, ys[:, None] * sw, xs[:, None] * sw], 1
    ).astype(np.float32)
    for _ in range(3):
        d = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
        seg = d.argmin(1)
        for k in range(n):
            sel = seg == k
            if sel.any():
                centers[k] = feats[sel].mean(0)
    means = np.stack(
        [small.reshape(-1, c)[seg == k].mean(0) if (seg == k).any() else np.zeros(c) for k in range(n)]
    )
    p_rep = rng.uniform(*cfg.superpixels_replace)
    rep = rng.uniform(size=n) < p_rep
    seg_img = seg.reshape(hs, ws)
    if factor > 1:
        seg_img = host_image.resize_nearest(seg_img.astype(np.float32), (w, h)).astype(int)
    out = img.copy()
    mask = rep[seg_img]
    out[mask] = means[seg_img[mask]]
    return out


def someof_draw_np(rng, cfg):
    """Exact host-side ``iaa.SomeOf((0, 5))`` SELECTION draw (per sample):
    k ~ U{0..5} entries chosen WITHOUT replacement; Sometimes(0.5)-wrapped
    entries (0, 12, 13, 14) thinned by a coin. Returns the active-entry
    set. The APPLICATION order is per-batch (``random_order=True`` shuffles
    once per batch in imgaug) — the caller filters its batch-level
    permutation by this set."""
    if cfg.someof_n <= 0:
        return set()
    k = int(rng.integers(cfg.someof_count[0], cfg.someof_count[1] + 1))
    chosen = rng.permutation(cfg.someof_n)[:k]
    return {
        int(e)
        for e in chosen
        if e not in (0, 12, 13, 14) or rng.uniform() < cfg.sometimes_p
    }


def _directed_edge_kernel_np(direction):
    """numpy twin of the device ``_directed_edge_kernel`` (iaa.
    DirectedEdgeDetect effect matrix: degree-quantised direction, neighbour
    weights (1 - angle/180)^4 normalised, negated, centre 1)."""
    rad = np.deg2rad(np.floor(direction * 360.0) % 360.0) - 0.5 * np.pi
    dx, dy = np.cos(rad), np.sin(rad)
    offs = np.array([-1.0, 0.0, 1.0])
    gx, gy = np.meshgrid(offs, offs, indexing="xy")
    norm = np.sqrt(gx * gx + gy * gy)
    cosang = np.clip((gx * dx + gy * dy) / np.where(norm == 0, 1.0, norm), -1.0, 1.0)
    sim = (1.0 - np.arccos(cosang) / np.pi) ** 4
    sim[1, 1] = 0.0
    m = -sim / sim.sum()
    m[1, 1] = 1.0
    return m.astype(np.float32)


def _perlin_mask_np(rng, h, w):
    """numpy twin of the device ``_perlin_mask`` (gradient noise, sampled
    granularity, 1-3 max-aggregated draws, sigmoid shaping)."""
    G = augment_cfg._PERLIN_G  # shared with the device kernel — cannot drift
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mask = np.zeros((h, w))
    for _ in range(int(rng.integers(1, 4))):
        g = float(rng.integers(2, G + 1))
        u = yy * (g / h)
        v = xx * (g / w)
        if rng.uniform() < 0.5:  # nearest upscale: snap to raster centers
            u = np.floor(u) + 0.5
            v = np.floor(v) + 0.5
        theta = rng.uniform(0, 2 * np.pi, size=(G + 2, G + 2))
        i0 = np.floor(u).astype(int)
        j0 = np.floor(v).astype(int)
        fu, fv = u - i0, v - j0

        def gd(di, dj):
            th = theta[i0 + di, j0 + dj]
            return np.sin(th) * (fu - di) + np.cos(th) * (fv - dj)

        def fade(t):
            return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

        wu, wv = fade(fu), fade(fv)
        n0 = gd(0, 0) * (1 - wv) + gd(0, 1) * wv
        n1 = gd(1, 0) * (1 - wv) + gd(1, 1) * wv
        val = n0 * (1 - wu) + n1 * wu
        mask = np.maximum(mask, np.clip(0.5 + val * (0.5 / 0.70710678), 0.0, 1.0))
    thresh = rng.normal(0, 5.0)
    return 1.0 / (1.0 + np.exp(-(20.0 * (mask - 0.5) + thresh)))


def _intensity_np(rng, img, cfg, order=None, active=None):
    """The SomeOf family on one (H, W, C) float image in [0, 255] —
    op-for-op twin of the device `_intensity_ops`. ``order``/``active``
    from :func:`someof_draw_np` (exact SomeOf); None = legacy independent
    gates via ``intensity_gate``/``*_prob`` (test mode)."""
    h, w, c = img.shape
    g = cfg.intensity_gate
    exact = order is not None

    def fires(entry, prob=None):
        if exact:
            return entry in active
        p = g if prob is None else prob
        return p > 0 and rng.uniform() < p

    def as3(x):
        return x[..., None] if x.ndim == 2 else x

    def e_superpixels(img):
        return _superpixels_np(rng, img, cfg)

    def e_blur(img):
        choice = rng.integers(0, 3)
        if choice == 0:
            sigma = rng.uniform(*cfg.blur_sigma)
            if sigma > 1e-3:
                img = as3(host_image.gaussian_blur(img, sigma))
        elif choice == 1:
            k = int(rng.integers(cfg.avg_blur_k[0], cfg.avg_blur_k[1] + 1))
            if k > 1:
                img = as3(host_image.box_blur(img, k))
        else:
            k = 2 * int(rng.integers(cfg.median_blur_k[0] // 2, cfg.median_blur_k[1] // 2 + 1)) + 1
            if k > 1:
                img = as3(host_image.median_blur(np.clip(img, 0, 255).astype(np.uint8), k).astype(np.float64))
        return img

    def e_sharpen(img):
        a = rng.uniform(*cfg.sharpen_alpha)
        light = rng.uniform(*cfg.sharpen_lightness)
        eff = np.array([[-1, -1, -1], [-1, 8 + light, -1], [-1, -1, -1]], np.float32)
        return as3(host_image.filter2d(img, _kernel3(a, eff)))

    def e_emboss(img):
        a = rng.uniform(*cfg.emboss_alpha)
        s = rng.uniform(*cfg.emboss_strength)
        eff = np.array([[-1 - s, -s, 0], [-s, 1, s], [0, s, 1 + s]], np.float32)
        return as3(host_image.filter2d(img, _kernel3(a, eff)))

    def e_simplex(img):
        a = rng.uniform(*cfg.edge_alpha)
        if rng.uniform() < 0.5:  # OneOf: directed variant
            eff = _directed_edge_kernel_np(rng.uniform())
        else:
            eff = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
        edged = np.clip(as3(host_image.filter2d(img, _kernel3(a, eff))), 0, 255)
        m = _perlin_mask_np(rng, h, w)[..., None]
        return m * edged + (1 - m) * img

    def e_noise(img):
        scale = rng.uniform(*cfg.noise_scale)
        shape = img.shape if rng.uniform() < 0.5 else img.shape[:2] + (1,)
        return img + rng.normal(0, 1, size=shape) * scale

    def e_dropout(img):
        if rng.uniform() < 0.5:
            p = rng.uniform(*cfg.dropout)
            shape = img.shape if rng.uniform() < 0.5 else img.shape[:2] + (1,)
            return img * (rng.uniform(size=shape) >= p)
        p = rng.uniform(*cfg.coarse_dropout)
        # sampled size_percent granularity (iaa.CoarseDropout (0.02, 0.05))
        s = rng.uniform(*cfg.coarse_size)
        gh, gw = max(2, round(s * h)), max(2, round(s * w))
        ch = c if rng.uniform() < 0.2 else 1
        keep = (rng.uniform(size=(gh, gw, ch)) >= p).astype(np.float32)
        keep = host_image.resize_nearest(keep, (w, h))
        return img * (keep[..., None] if keep.ndim == 2 else keep)

    def e_invert(img):
        if cfg.invert_prob <= 0:
            return img
        inv = rng.uniform(size=c) < cfg.invert_prob
        return np.where(inv, 255.0 - img, img)

    def e_add(img):
        v = rng.uniform(*cfg.add, size=c) if rng.uniform() < 0.5 else rng.uniform(*cfg.add)
        return img + v

    def e_huesat(img):
        if c != 3:
            return img
        v = rng.uniform(*cfg.hue_sat)
        hsv = host_image.rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float64)
        hsv[..., 0] = np.mod(hsv[..., 0] + v, 180.0)
        hsv[..., 1] = np.clip(hsv[..., 1] + v, 0, 255)
        return host_image.hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float64)

    def e_multiply(img):
        v = rng.uniform(*cfg.multiply, size=c) if rng.uniform() < 0.5 else rng.uniform(*cfg.multiply)
        return img * v

    def e_gray(img):
        a = rng.uniform(*cfg.grayscale_alpha)
        return img + a * (img.mean(-1, keepdims=True) - img)

    entries = {
        0: (e_superpixels, cfg.superpixels_prob),
        1: (e_blur, None),
        2: (e_sharpen, None),
        3: (e_emboss, None),
        4: (e_simplex, None),
        5: (e_noise, None),
        6: (e_dropout, None),
        7: (e_invert, None),
        8: (e_add, None),
        9: (e_huesat, None),
        10: (e_multiply, None),
        11: (e_gray, None),
    }
    if exact:
        for e in order:  # true random application order (someof_draw_np)
            if e in entries:
                img = entries[e][0](img)
    else:
        for e in sorted(entries):
            fn, prob = entries[e]
            if fires(e, prob):
                img = fn(img)
    return np.clip(img, 0, 255)


def augment_batch(
    images: np.ndarray,
    masks: Optional[np.ndarray],
    rng: Optional[np.random.Generator] = None,
    cfg: Optional["augment_cfg.AugmentConfig"] = None,
):
    """(B, H, W, C) images + (B, H, W) int masks -> augmented pair.

    Float images are min-max mapped to the 0..255 uint8 range around the
    warp and mapped back, reproducing the MM-WHS round-trip
    (``data_generator_mmwhs.py:245-254``).
    """
    rng = rng or np.random.default_rng()
    cfg = cfg or augment_cfg.light()
    images = np.asarray(images)
    is_float = images.dtype != np.uint8
    lo, hi = float(images.min()), float(images.max())
    if is_float:
        work = (images - lo) * 255.0 / (hi - lo + 1e-12)
    else:
        work = images.astype(np.float64)
    out_i = np.empty_like(work)
    out_m = None if masks is None else np.empty_like(masks)
    h, w = images.shape[1:3]
    # np.pad/skimage mode index -> OpenCV border flag (ia.ALL for the affine/
    # crop&pad resample): constant, edge, symmetric, reflect, wrap
    border_flags = [
        host_image.BORDER_CONSTANT, host_image.BORDER_REPLICATE, host_image.BORDER_REFLECT,
        host_image.BORDER_REFLECT_101, host_image.BORDER_WRAP,
    ]
    # per-batch drawn orders (random_order=True shuffles ONCE per batch in
    # imgaug): a (5,) outer order of [Fliplr, Flipud, CropAndPad, Affine,
    # SomeOf] and a (12,) SomeOf order; same derivation as the device twin
    order5 = rng.permutation(5)
    pos = np.argsort(order5)  # pos[child] = application position
    geo_seq = np.argsort(pos[:4])  # the 4 linear children, in order
    # only statically-LIVE warp children count (device twin: aug2/medium
    # has no affine child, so its SomeOf-vs-CropAndPad order is exact)
    sp = int(pos[4])
    warp_pos = [int(pos[c]) for c, p in ((2, cfg.croppad_prob), (3, cfg.affine_prob)) if p > 0]
    coin = rng.uniform() < 0.5
    if warp_pos:
        before = sp < min(warp_pos)
        after = sp > max(warp_pos)
        intensity_first = bool(before or (not after and coin))
    else:
        intensity_first = bool(coin)
    perm12 = [int(e) for e in rng.permutation(12)]
    for b in range(len(images)):
        img = work[b]
        msk = None if masks is None else masks[b]
        active = someof_draw_np(rng, cfg)
        order_e = [e for e in perm12 if e in active]  # batch order ∩ sample draw
        exact = cfg.someof_n > 0

        def apply_intensity(img):
            if exact:
                return _intensity_np(rng, img, cfg, order=order_e, active=active)
            return _intensity_np(rng, img, cfg)

        if intensity_first:
            img = apply_intensity(img)
        mats, warped, aff_fired = _child_mats_np(rng, h, w, cfg)
        fwd = np.eye(3)
        for p in geo_seq:  # forward composition in the drawn order
            fwd = mats[int(p)] @ fwd
        # (y, x) 3x3 -> OpenCV's (x, y) 2x3
        m = np.array(
            [
                [fwd[1, 1], fwd[1, 0], fwd[1, 2]],
                [fwd[0, 1], fwd[0, 0], fwd[0, 2]],
            ]
        )
        persp_on = (14 in active) if exact else (
            cfg.perspective_prob > 0 and rng.uniform() < cfg.perspective_prob
        )

        def apply_perspective(img, msk):
            s = rng.uniform(*cfg.perspective_scale)
            jit = rng.normal(0, s, size=(4, 2)) * np.array([w, h])  # OpenCV's (x, y)
            dst = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
            src = (dst + jit).astype(np.float32)
            hmat = host_image.perspective_transform(src, dst)
            img = host_image.warp_perspective(img, hmat, (w, h))
            if msk is not None:
                msk = host_image.warp_perspective(
                    msk.astype(np.float32), hmat, (w, h), nearest=True
                ).astype(masks.dtype)
            return img, msk

        # perspective is a SomeOf member: it precedes the linear composite
        # when the SomeOf child was drawn before it (device twin: P @ M vs
        # M @ P by intensity_first)
        if persp_on and intensity_first:
            img, msk = apply_perspective(img, msk)
        flips_fired = not (
            np.array_equal(mats[0], np.eye(3)) and np.array_equal(mats[1], np.eye(3))
        )
        if warped or flips_fired:
            # iaa.Affine's order=[0, 1] draw belongs to the affine only — a
            # crop&pad-only warp resamples bilinearly (device twin: the snap
            # coin is gated on gate_aff, augment.py _child_matrices); a pure
            # flip is an exact integer map: nearest keeps it lossless
            if warped:
                nearest = bool(aff_fired and rng.uniform() < 0.5)
                cval = float(rng.uniform(0, 255))
            else:
                nearest, cval = True, 0.0
            # pad_mode/mode=ia.ALL (heavy/aug2); light pins constant
            border = (
                border_flags[int(rng.integers(0, 5))]
                if (cfg.border_mode_all and warped)
                else host_image.BORDER_CONSTANT
            )
            img = host_image.warp_affine(img, m, (w, h), nearest=nearest, border=border, cval=cval)
            if msk is not None:
                # imgaug segmaps: constant-0 regardless of the image mode
                msk = host_image.warp_affine(
                    msk.astype(np.float32), m, (w, h), nearest=True, border=host_image.BORDER_CONSTANT, cval=0.0
                ).astype(masks.dtype)
        if persp_on and not intensity_first:
            img, msk = apply_perspective(img, msk)
        # elastic + piecewise displacement fields via one remap
        disp = None
        el_on = (12 in active) if exact else (
            cfg.elastic_prob > 0 and rng.uniform() < cfg.elastic_prob
        )
        if el_on:
            alpha = rng.uniform(*cfg.elastic_alpha)
            disp = rng.uniform(-1, 1, size=(h, w, 2)).astype(np.float32) * alpha
        pw_on = (13 in active) if exact else (
            cfg.piecewise_prob > 0 and rng.uniform() < cfg.piecewise_prob
        )
        if pw_on:
            s = rng.uniform(*cfg.piecewise_scale)
            grid = rng.normal(0, 1, size=(4, 4, 2)).astype(np.float32)
            coarse = host_image.resize_linear(grid, (w, h)) * s * np.array([h, w], np.float32)
            disp = coarse if disp is None else disp + coarse
        if disp is not None:
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            map_x = xx + disp[..., 1]
            map_y = yy + disp[..., 0]
            img = host_image.remap(img, map_x, map_y)
            if msk is not None:
                msk = host_image.remap(msk.astype(np.float32), map_x, map_y, nearest=True).astype(masks.dtype)
        if not intensity_first:
            img = apply_intensity(img)
        out_i[b] = img
        if out_m is not None:
            out_m[b] = msk
    if is_float:
        out_i = lo + out_i.astype(np.float32) * (hi - lo + 1e-12) / 255.0
    else:
        out_i = np.clip(out_i, 0, 255).astype(np.float64)
    return out_i.astype(images.dtype if not is_float else np.float32), out_m


def make_host_augment(aug: str):
    """Loader hook: (images, masks, rng) -> (images, masks). Gates and
    ranges come from the same AugmentConfig as the device pipeline."""
    if aug == "heavy":
        cfg = augment_cfg.heavy()
    elif aug == "aug2":
        cfg = augment_cfg.medium()
    elif aug == "light":
        cfg = augment_cfg.light()
    else:
        return None
    return lambda i, m, rng: augment_batch(i, m, rng, cfg=cfg)
