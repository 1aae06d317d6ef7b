"""The port's host augmentation twin and host cloud regeneration against the
JAX package's, and the numpy image operations that stand in for OpenCV
(``pointcloududa_torch/ops/host_image.py``) against OpenCV itself.

Both twins are numpy on the host, so nothing here compiles JAX. ``cv2`` is
the oracle for ``host_image`` only; no module of the port imports it.

What is held, and how tightly:

- ``host_image`` against ``cv2`` at the dtypes the twin hands it (float64
  work images of uint8 batches, float32 of MM-WHS's float batches, float32
  masks and grids, uint8 for the median and the colour conversion) and the
  offline rotation hands it (uint8 images and masks, linear and nearest,
  with ``rotation_matrix_2d`` against ``cv2.getRotationMatrix2D``), with
  1 and 3 channels, every interpolation and border flag the twin uses:
  **bit-equal** for the warps, the remap, the perspective matrix, the
  resizes of 1 and 3 channels, the nearest resize, the box and median
  blurs, ``filter2D`` and both colour conversions. Two are within a
  tolerance, each for a reason found against OpenCV 5.0.0:
  the Gaussian blur (OpenCV computes its taps with a software ``exp`` that
  differs from ``math.exp`` in the last bits of the outer taps: rtol 1e-12
  in float64, 1e-6 of the 0..255 scale in float32) and the linear resize of
  the 2-channel piecewise grid (OpenCV's older vertical pass, within
  4 float32 ulps);
- ``augment_batch`` of heavy, medium and light on uint8 and float32
  batches, from one seed, with every SomeOf member forced on once: the
  masks equal, the Generator's state after the call equal, and the images
  within ``IMG_ATOL`` of the 0..255 scale at all but ``UNTOUCHED_SHARE`` of a
  sample's pixels (a last-bit difference from the Gaussian taps can cross an
  integer before a truncating uint8 cast), or ``TOUCHED_SHARE`` where the
  superpixels touched the sample: their k-means amplifies any last-bit
  difference (``tests/diag_torch_port_superpixels_spread.py``; the device
  pipeline's tests hold such a sample at the same share);
- ``mask_to_point_cloud``, ``boundary_voxels`` and
  ``farthest_point_sampling`` against the JAX package's (which take the
  native host library, ``csrc/pcuda_host.cpp``, where it builds) and against
  that library directly: bit for bit, for empty masks, masks at and just
  above the 50-pixel threshold, clouds with fewer boundary voxels than
  points, and ordinary shapes, with a seed and with numpy's global
  generator seeded alike.
"""

import cv2
import numpy as np
import pytest

from pointcloududa_tpu.data import pointcloud as ref_pc
from pointcloududa_tpu.ops import augment as ref_aug
from pointcloududa_tpu.ops import host_augment as ref_host
from pointcloududa_torch.data import pointcloud as pc
from pointcloududa_torch.ops import augment as aug
from pointcloududa_torch.ops import host_augment as host
from pointcloududa_torch.ops import host_image as hi

BORDERS = {"constant": cv2.BORDER_CONSTANT, "replicate": cv2.BORDER_REPLICATE, "reflect": cv2.BORDER_REFLECT,
           "reflect101": cv2.BORDER_REFLECT_101, "wrap": cv2.BORDER_WRAP}
# (height, width, channels): widths below, at and past OpenCV's vector widths
SHAPES = [(24, 40, 3), (17, 21, 1), (12, 48, 3)]
DTYPES = {"float64": np.float64, "float32": np.float32}
IMG_ATOL = 1e-3
UNTOUCHED_SHARE, TOUCHED_SHARE = 0.01, 0.5


def _image(shape, dtype, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dtype)


def _same(got, want, what):
    want = np.asarray(want).reshape(np.shape(got))  # OpenCV drops a size-1 channel
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_fused_multiply_add_rounds_once():
    """The emulated ``fma`` behind the resize and the float32 warps: one
    rounding of the exact ``a * b + c``, in float64 (against fractions) and
    in float32, also where the two roundings of ``a * b + c`` differ."""
    from fractions import Fraction

    rng = np.random.default_rng(30)
    a, b = rng.uniform(-300, 300, 2000), rng.uniform(-1, 1, 2000)
    c = -np.round(a * b, 3) * rng.choice([1.0, 1.0 + 2.0 ** -40], 2000)  # heavy cancellation
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    got = hi._fma64(a, b, c)
    np.testing.assert_array_equal(got, want)
    assert (got != a * b + c).any()  # the cases where two roundings differ are in the sample
    def to_f32(exact):  # the float32 nearest to a fraction, ties to even
        x = np.float32(float(exact))
        near = [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
        return min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.array(v).view(np.int32)) & 1))

    a32, b32, c32 = (v.astype(np.float32) for v in (a, b, c))
    want32 = np.array([to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))) for x, y, z in zip(a32, b32, c32)],
                      np.float32)
    np.testing.assert_array_equal(hi._fma32(a32, b32, c32), want32)


def _affine(rng, k):
    if k % 3 == 0:  # a flip and a half-pixel shift: exact ties for nearest
        return np.array([[-1.0, 0.0, 20.5], [0.0, 1.0, -0.5]])
    a = rng.uniform(-1.5, 1.5, (2, 2)) if k % 3 == 1 else np.eye(2) * rng.uniform(0.8, 1.2) + rng.normal(0, 0.1, (2, 2))
    return np.concatenate([a, rng.uniform(-10, 10, (2, 1))], 1)


@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warp_affine_equals_opencv(dtype, nearest, border):
    rng = np.random.default_rng(1)
    flag = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for h, w, c in SHAPES:
        img = _image((h, w, c), DTYPES[dtype], 2)
        for k in range(4):
            m, cval = _affine(rng, k), float(rng.uniform(0, 255))
            want = cv2.warpAffine(img, m, (w, h), flags=flag, borderMode=BORDERS[border], borderValue=(cval,) * 3)
            _same(hi.warp_affine(img, m, (w, h), nearest=nearest, border=BORDERS[border], cval=cval), want, f"{(h, w, c)} {k}")


# the offline rotation's shapes (prep/prepare_mscmrseg.py rotate): the case
# the uint8 route was repaired on, the training crop, and widths with
# w % 16 != 0 (OpenCV's scalar tail of the coordinates)
U8_SHAPES = [(64, 70), (224, 224), (37, 53), (19, 300)]


@pytest.mark.parametrize("angle", [15.0, -15.0])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
def test_uint8_warp_affine_equals_opencv(nearest, channels, angle):
    """uint8 images and masks rotated about their centre as the offline
    rotation does: bit-equal to ``cv2.warpAffine`` (constant-0 border), with
    the matrix from ``rotation_matrix_2d``; a label mask with few values as
    well as noise."""
    rng = np.random.default_rng(7)
    flag = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for h, w in U8_SHAPES:
        shape = (h, w, channels) if channels == 3 else (h, w)
        noise = rng.integers(0, 256, shape, dtype=np.uint8)
        labels = np.array([0, 85, 212, 255], np.uint8)[rng.integers(0, 4, (h // 4 + 1, w // 4 + 1))]
        labels = np.repeat(np.repeat(labels, 4, 0), 4, 1)[:h, :w]
        for img in (noise, labels if channels == 1 else np.repeat(labels[..., None], 3, -1)):
            m = hi.rotation_matrix_2d((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
            want = cv2.warpAffine(img, m, (w, h), flags=flag, borderValue=0)
            _same(hi.warp_affine(img, m, (w, h), nearest=nearest), want, f"{shape} {angle}")


@pytest.mark.parametrize("border", ["constant", "replicate", "reflect101"])
def test_uint8_warp_affine_of_four_channels_and_other_borders_equals_opencv(border):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)
    for k in range(3):
        m = _affine(rng, k)
        for nearest, flag in ((False, cv2.INTER_LINEAR), (True, cv2.INTER_NEAREST)):
            want = cv2.warpAffine(img, m, (50, 30), flags=flag, borderMode=BORDERS[border], borderValue=0)
            _same(hi.warp_affine(img, m, (50, 30), nearest=nearest, border=BORDERS[border]), want, f"{k} {nearest}")
    with pytest.raises(ValueError, match="2 channels"):
        hi.warp_affine(img[..., :2], m, (50, 30))


def test_rotation_matrix_equals_opencv():
    rng = np.random.default_rng(9)
    cases = [((w / 2 - 0.5, h / 2 - 0.5), a, 1.0) for h, w in U8_SHAPES for a in (15.0, -15.0, 0.0, 90.0)]
    cases += [(tuple(rng.uniform(-300, 300, 2)), float(rng.uniform(-360, 360)), float(rng.uniform(0.1, 3)))
              for _ in range(500)]
    for center, angle, scale in cases:
        got = hi.rotation_matrix_2d(center, angle, scale)
        want = cv2.getRotationMatrix2D(center, angle, scale)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=f"{center} {angle} {scale}")


def _perspective_points(rng, h, w):
    dst = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
    return (dst + rng.normal(0, 0.06, size=(4, 2)) * np.array([w, h])).astype(np.float32), dst


@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_perspective_transform_and_warp_equal_opencv(dtype, nearest):
    """``getPerspectiveTransform`` (OpenCV's own elimination, bit-equal) and
    ``warpPerspective`` (float32: float coordinates over ``fma`` rows;
    float64: double coordinates in 64-column blocks), images and masks."""
    rng = np.random.default_rng(3)
    flag = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for h, w, c in SHAPES + [(20, 80, 3)]:
        img = _image((h, w, c), DTYPES[dtype], 4)
        mask = rng.integers(0, 4, (h, w)).astype(np.float32)
        for _ in range(4):
            src, dst = _perspective_points(rng, h, w)
            m = hi.perspective_transform(src, dst)
            _same(m, cv2.getPerspectiveTransform(src, dst), "matrix")
            _same(hi.warp_perspective(img, m, (w, h), nearest=nearest), cv2.warpPerspective(img, m, (w, h), flags=flag), "image")
            _same(hi.warp_perspective(mask, m, (w, h), nearest=True), cv2.warpPerspective(mask, m, (w, h), flags=cv2.INTER_NEAREST),
                  "mask")


@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_remap_equals_opencv(dtype, nearest):
    """Elastic and piecewise displacement maps (float32), replicated border."""
    rng = np.random.default_rng(5)
    flag = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for h, w, c in SHAPES:
        img = _image((h, w, c), DTYPES[dtype], 6)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for scale in (0.4, 3.0, 9.0):
            disp = (rng.uniform(-1, 1, (h, w, 2)) * scale).astype(np.float32)
            mx, my = xx + disp[..., 1], yy + disp[..., 0]
            want = cv2.remap(img, mx, my, flag, borderMode=cv2.BORDER_REPLICATE)
            _same(hi.remap(img, mx, my, nearest=nearest), want, f"{(h, w, c)} x{scale}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_linear_resize_equals_opencv(dtype):
    """The superpixels' downscale (by 2 and by odd ratios) and upscales,
    1 and 3 channels, bit-equal; the piecewise grid's (4, 4, 2) float32
    upscale within 4 ulps."""
    for h, w, c in SHAPES + [(33, 35, 3), (7, 9, 1)]:
        img = _image((h, w, c), DTYPES[dtype], 7)
        for size in ((w // 2, h // 2), (w // 3 + 1, h // 3 + 2), (2 * w + 3, h + 5)):
            _same(hi.resize_linear(img, size), cv2.resize(img, size), f"{(h, w, c)} -> {size}")
    grid = np.random.default_rng(8).normal(size=(4, 4, 2)).astype(np.float32)
    for size in ((40, 24), (224, 224), (256, 256)):
        want = cv2.resize(grid, size)
        np.testing.assert_allclose(hi.resize_linear(grid, size), want, rtol=0, atol=4 * float(np.spacing(np.abs(want).max())))


def test_nearest_resize_equals_opencv():
    """The superpixels' label upscale and the coarse-dropout keep mask."""
    rng = np.random.default_rng(9)
    for (sh, sw), (dh, dw), c in (((12, 20), (24, 40), 1), ((5, 7), (17, 21), 3), ((2, 2), (48, 12), 1), ((112, 112), (224, 224), 1)):
        src = rng.integers(0, 50, (sh, sw, c) if c > 1 else (sh, sw)).astype(np.float32)
        _same(hi.resize_nearest(src, (dw, dh)), cv2.resize(src, (dw, dh), interpolation=cv2.INTER_NEAREST), f"{(sh, sw)}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gaussian_blur_within_the_taps_tolerance(dtype, monkeypatch):
    """OpenCV's taps come from its software ``exp``; given OpenCV's own taps
    the float64 blur is bit-equal."""
    for h, w, c in SHAPES:
        img = _image((h, w, c), DTYPES[dtype], 10)
        for sigma in (0.1, 0.45, 1.3, 2.9):
            got, want = hi.gaussian_blur(img, sigma), cv2.GaussianBlur(img, (0, 0), sigma).reshape(img.shape)
            assert got.dtype == want.dtype
            tol = dict(rtol=1e-12, atol=0) if dtype == "float64" else dict(rtol=0, atol=1e-6 * 255)
            np.testing.assert_allclose(got, want, **tol, err_msg=f"{(h, w, c)} sigma {sigma}")
    taps = cv2.getGaussianKernel(13, 1.5, cv2.CV_64F).ravel()
    np.testing.assert_allclose(hi.gaussian_kernel(1.5, np.float64), taps, rtol=1e-14, atol=0)
    img = _image((24, 40, 3), np.float64, 11)
    monkeypatch.setattr(hi, "gaussian_kernel",
                        lambda sigma, dt: cv2.getGaussianKernel(int(np.rint(sigma * 8 + 1)) | 1, sigma, cv2.CV_64F).ravel())
    _same(hi.gaussian_blur(img, 1.5), cv2.GaussianBlur(img, (0, 0), 1.5), "with OpenCV's taps")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_box_blur_equals_opencv(dtype):
    for h, w, c in SHAPES:
        img = _image((h, w, c), DTYPES[dtype], 12)
        for k in range(2, 8):  # the heavy pipeline's (2, 7); even k anchors at k // 2
            _same(hi.box_blur(img, k), cv2.blur(img, (k, k)), f"{(h, w, c)} k {k}")


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
def test_median_blur_equals_opencv(k):
    for h, w, c in SHAPES + [(5, 6, 3)]:
        img = np.random.default_rng(13).integers(0, 256, (h, w, c), dtype=np.uint8)
        _same(hi.median_blur(img, k), cv2.medianBlur(img, k), f"{(h, w, c)}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_filter2d_equals_opencv(dtype):
    """Sharpen, emboss and edge kernels (float32, 3 x 3, zeros included)."""
    rng = np.random.default_rng(14)
    for h, w, c in SHAPES + [(9, 11, 3)]:
        img = _image((h, w, c), DTYPES[dtype], 15)
        for kernel in (host._kernel3(0.7, np.array([[-1, -1, -1], [-1, 9.2, -1], [-1, -1, -1]], np.float32)),
                       host._kernel3(0.4, np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)),
                       host._directed_edge_kernel_np(0.3), rng.normal(size=(3, 3)).astype(np.float32)):
            _same(hi.filter2d(img, kernel), cv2.filter2D(img, -1, kernel), f"{(h, w, c)}")


def test_colour_conversions_equal_opencv():
    """RGB -> HSV over every red and green with every fifth blue (and 255);
    HSV -> RGB over every hue 0..179 with every fifth saturation and every
    value, in rows wide enough for OpenCV's vector loop and with its scalar
    tail."""
    blue = np.unique(np.r_[np.arange(0, 256, 5), 255])
    colours = np.stack(np.meshgrid(np.arange(256), np.arange(256), blue, indexing="ij"), -1).astype(np.uint8)
    colours = colours.reshape(-1, 256, 3)
    _same(hi.rgb_to_hsv(colours), cv2.cvtColor(colours, cv2.COLOR_RGB2HSV), "rgb -> hsv")
    hsv = np.stack(np.meshgrid(np.arange(180), np.unique(np.r_[np.arange(0, 256, 5), 255]), np.arange(256), indexing="ij"), -1)
    hsv = hsv.astype(np.uint8)
    for width in (256, 40, 7):
        rows = hsv.reshape(-1, 3)[: (hsv.size // 3) // width * width].reshape(-1, width, 3)
        _same(hi.hsv_to_rgb(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2RGB), f"hsv -> rgb, width {width}")


# --------------------------------------------------------------- the twin

PIPELINES = {"heavy": (aug.heavy, ref_aug.heavy), "medium": (aug.medium, ref_aug.medium), "light": (aug.light, ref_aug.light)}
CASES = [(p, m) for p, (make, _) in PIPELINES.items() for m in [None] + list(range(make().someof_n))]


def _batch(kind, seed, b=4, h=40, w=48):
    rng = np.random.default_rng(100 + seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 127 + 60 * np.sin(yy / 5.0)[..., None] * np.cos(xx / 7.0)[..., None] + rng.normal(0, 25, (b, h, w, 3))
    imgs = np.clip(smooth, 0, 255).astype(np.uint8) if kind == "uint8" else (smooth * 3.1 - 200).astype(np.float32)
    masks = np.zeros((b, h, w), np.int64)
    masks[:, 8:30, 10:36] = 1
    masks[:, 14:24, 16:28] = rng.integers(2, 4, (b, 1, 1))
    return imgs, masks


def _run_twin(module, cfg, imgs, masks, seed, member, monkeypatch):
    """``augment_batch`` with ``member`` added to every sample's SomeOf
    draw (the draws themselves unchanged); returns the outputs, the
    Generator's state after the call and each sample's active set."""
    orig, active = module.someof_draw_np, []

    def draw(rng, c):
        got = orig(rng, c) | ({member} if member is not None else set())
        active.append(got)
        return got

    with monkeypatch.context() as mp:
        mp.setattr(module, "someof_draw_np", draw)
        rng = np.random.default_rng(seed)
        out_i, out_m = module.augment_batch(imgs, masks, rng, cfg=cfg)
    return out_i, out_m, rng.bit_generator.state, active


def _images_close(got, want, span, touched, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    for b in range(len(want)):
        far = np.abs(got[b].astype(np.float64) - want[b].astype(np.float64)) / span > IMG_ATOL
        share = TOUCHED_SHARE if touched[b] else UNTOUCHED_SHARE
        assert far.mean() <= share, f"{what} sample {b}: {far.mean():.4f} of its pixels beyond {IMG_ATOL} (superpixels: {touched[b]})"


@pytest.mark.parametrize("pipeline,member", CASES, ids=[f"{p}-{'none' if m is None else m}" for p, m in CASES])
def test_augment_batch_equals_the_jax_twin(pipeline, member, monkeypatch):
    make, ref_make = PIPELINES[pipeline]
    for kind in ("uint8", "float32"):
        for seed in (0, 1):
            imgs, masks = _batch(kind, seed)
            got_i, got_m, got_state, active = _run_twin(host, make(), imgs, masks, seed, member, monkeypatch)
            want_i, want_m, want_state, _ = _run_twin(ref_host, ref_make(), imgs, masks, seed, member, monkeypatch)
            what = f"{pipeline} {kind} seed {seed}"
            assert got_state == want_state, what  # the same draws, in the same order
            assert got_m.dtype == want_m.dtype
            np.testing.assert_array_equal(got_m, want_m, err_msg=what)
            span = 1.0 if kind == "uint8" else float(imgs.max() - imgs.min()) / 255.0
            touched = [0 in a for a in active] if active else [False] * len(imgs)
            _images_close(got_i, want_i, span, touched, what)


@pytest.mark.parametrize("name", ["heavy", "aug2", "light", ""])
def test_make_host_augment_is_the_loaders_hook(name):
    """The loader's hook: ``(images, masks, rng)``, the config by name, and
    no hook without augmentation."""
    got, want = host.make_host_augment(name), ref_host.make_host_augment(name)
    assert (got is None) is (want is None) is (name == "")
    if got is not None:
        imgs, masks = _batch("uint8", 3)
        (gi, gm), (wi, wm) = got(imgs, masks, np.random.default_rng(4)), want(imgs, masks, np.random.default_rng(4))
        np.testing.assert_array_equal(gm, wm)
        _images_close(gi, wi, 1.0, [True] * len(imgs), name)


# ---------------------------------------------------------- cloud regeneration


def _masks():
    """name -> (H, W) or (H, W, 1) integer mask."""
    out = {"empty": np.zeros((40, 48), np.int64)}
    at = np.zeros((40, 48), np.uint8)
    at.reshape(-1)[:50] = 1  # exactly the threshold: no cloud
    out["50 pixels"] = at
    above = at.copy()
    above.reshape(-1)[50] = 1
    out["51 pixels"] = above  # fewer boundary voxels than points
    rect = np.zeros((64, 72, 1), np.int64)
    rect[10:50, 12:60] = 2
    out["rectangle (H, W, 1)"] = rect
    yy, xx = np.mgrid[0:96, 0:96]
    out["ring"] = (((yy - 48) ** 2 + (xx - 40) ** 2 < 900) & ((yy - 48) ** 2 + (xx - 40) ** 2 > 300)).astype(np.int64) * 3
    out["noise"] = (np.random.default_rng(20).uniform(size=(48, 48)) < 0.4).astype(np.int64)
    return out


@pytest.mark.parametrize("name", list(_masks()))
def test_mask_to_point_cloud_equals_the_jax_package(name):
    mask = _masks()[name]
    for seed in (0, 7):
        got = pc.mask_to_point_cloud(mask, seed=seed)
        want = ref_pc.mask_to_point_cloud(mask, seed=seed)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (pc.NUM_POINTS, 3)
        np.testing.assert_array_equal(got, want)
    np.random.seed(11)
    got = pc.mask_to_point_cloud(mask)
    after = np.random.get_state()[1].copy()
    np.random.seed(11)
    want = ref_pc.mask_to_point_cloud(mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(after, np.random.get_state()[1])  # the same global draws
    binary = (np.asarray(mask).reshape(mask.shape[:2]) > 0)
    if binary.sum() <= 50:
        assert not got.any()
    else:
        slab = np.stack([binary] * 3).astype(np.uint8)
        on_boundary = {tuple(p) for p in pc.boundary_voxels(slab)}
        assert all(tuple(p) in on_boundary for p in got.astype(np.int64))


def test_boundary_voxels_and_fps_equal_the_native_library():
    """Both against ``csrc/pcuda_host.cpp`` (what the JAX package calls
    where it builds), ties included: a grid of integer points has many
    equidistant candidates, and both take the first maximum."""
    from pointcloududa_tpu.utils import native

    if not native.available():
        pytest.skip("the native host library did not build here")
    for name, mask in _masks().items():
        binary = (np.asarray(mask).reshape(mask.shape[:2]) > 0).astype(np.uint8)
        slab = np.stack([binary] * 3)
        got = pc.boundary_voxels(slab)
        np.testing.assert_array_equal(got, native.boundary_voxels(np.ascontiguousarray(slab)), err_msg=name)
        if len(got):
            pts = got.astype(np.float64)
            for seed in (0, 1, 2):
                start = int(np.random.default_rng(seed).integers(len(pts)))
                np.testing.assert_array_equal(pc.farthest_point_sampling(pts, 300, seed=seed), native.fps(pts, 300, start),
                                              err_msg=f"{name} start {start}")
