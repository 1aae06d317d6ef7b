"""Host-side (numpy) post-processing utilities.

Equivalents of reference ``src/utils/utils.py`` — kept on host on purpose:
the evaluation chain (argmax → keep-largest-connected-components → relabel →
metric) must match the reference bit-for-bit, and these ops are cheap,
irregular, and not on the training hot path.

The port's own copy of the JAX package's ``ops/postprocess.py``, held equal
to it by ``tests/test_torch_port_imports.py``, except ``resize_volume``: the
JAX package calls OpenCV's INTER_AREA resize, which this package writes in
numpy (the port does not depend on OpenCV).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def to_categorical(mask: np.ndarray, num_classes: int, channel: str = "channel_last") -> np.ndarray:
    """Integer mask → one-hot (uint8).

    Mirrors reference ``src/utils/utils.py:7-29`` including its validation
    and the squeeze of a singleton channel axis at position 1 or -1.
    Default layout is channel_last (TPU-native NHWC); pass
    ``channel='channel_first'`` for the reference's NCHW contract.
    """
    if channel not in ("channel_first", "channel_last"):
        raise ValueError("channel should be either 'channel_first' or 'channel_last'")
    if num_classes <= 1:
        raise ValueError("num_classes should be greater than 1")
    mask = np.asarray(mask)
    unique = np.unique(mask)
    if len(unique) > num_classes:
        raise ValueError("number of unique values should be <= num_classes")
    if unique.max() >= num_classes:
        raise ValueError("maximum value in the mask should be < num_classes")
    if mask.ndim > 1 and mask.shape[1] == 1:
        mask = np.squeeze(mask, axis=1)
    if mask.ndim > 1 and mask.shape[-1] == 1:
        mask = np.squeeze(mask, axis=-1)
    eye = np.eye(num_classes, dtype="uint8")
    out = eye[mask.astype(np.int64)]
    if channel == "channel_first":
        out = np.moveaxis(out, -1, 1)
    return out


def soft_to_hard_pred(pred: np.ndarray, channel_axis: int = -1) -> np.ndarray:
    """Per-pixel one-hot of the max class (reference ``utils.py:32-40``).

    Note the reference semantics: *every* channel equal to the max gets a 1
    (ties produce multi-hot rows), via equality against the max — reproduced
    exactly because the train-time Dice depends on it.
    """
    pred = np.asarray(pred)
    max_value = np.max(pred, axis=channel_axis, keepdims=True)
    return np.where(pred == max_value, 1, 0)


def keep_largest_connected_components(mask: np.ndarray, num_classes: int | None = None) -> np.ndarray:
    """Keep only the largest 3-D connected component of each foreground label.

    Equivalent of reference ``src/utils/utils.py:43-65`` (which uses
    ``skimage.measure.label(connectivity=1)``): here scipy's 6-connected
    3-D labeling — the same connectivity-1 structure. The reference derives
    the number of structures from ``mask.shape[1]`` (a latent bug when slices
    are square); we default to ``mask.max()`` which is the intended set of
    labels, or accept an explicit ``num_classes`` (number of foreground ids).
    """
    mask = np.asarray(mask)
    out_img = np.zeros(mask.shape, dtype=np.uint8)
    n = int(num_classes) if num_classes is not None else int(mask.max())
    structure = ndimage.generate_binary_structure(mask.ndim, 1)
    for struc_id in range(1, n + 1):
        binary_img = mask == struc_id
        blobs, n_blobs = ndimage.label(binary_img, structure=structure)
        if n_blobs == 0:
            continue
        areas = np.bincount(blobs.ravel())[1:]  # skip background count
        largest = int(np.argmax(areas)) + 1
        out_img[blobs == largest] = struc_id
    return out_img


def _area_taps(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: for each output index the source
    indices it averages and their float32 weights (a partial cell at either
    end, whole cells between), padded with weight-0 taps to one width."""
    taps = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        row = [(s1 - 1, (s1 - f1) / cell)] if s1 - f1 > 1e-3 else []
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(row) for row in taps)
    idx = np.zeros((dsize, width), np.int64)
    alpha = np.zeros((dsize, width), np.float32)
    for d, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            idx[d, k], alpha[d, k] = s, a
    return idx, alpha


def _shrink(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """INTER_AREA when both axes shrink by a factor that is not an integer:
    area weights, rows first, each sum accumulated in float32 in OpenCV's
    order (``ResizeArea_Invoker``)."""
    ix, ax = _area_taps(x.shape[-1], w, 1.0 / (w / x.shape[-1]))
    iy, ay = _area_taps(x.shape[-2], h, 1.0 / (h / x.shape[-2]))
    rows = np.zeros(x.shape[:-1] + (w,), np.float32)
    for k in range(ix.shape[1]):
        rows = rows + x[..., ix[:, k]] * ax[:, k]
    out = np.zeros(x.shape[:-2] + (h, w), np.float32)
    for k in range(iy.shape[1]):
        out = out + rows[..., iy[:, k], :] * ay[:, k, None]
    return out


def _box(x: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """INTER_AREA when both axes shrink by an integer factor: the mean of
    each fy x fx box, summed in OpenCV's order (``resizeAreaFast_``: pairs
    for 2 x 2, else four terms at a time) and scaled by 1 / area."""
    h, w = x.shape[-2] // fy, x.shape[-1] // fx
    v = x[..., : h * fy, : w * fx].reshape(x.shape[:-2] + (h, fy, w, fx))
    terms = [v[..., a, :, b] for a in range(fy) for b in range(fx)]
    if fy == fx == 2:
        return ((terms[0] + terms[1]) + (terms[2] + terms[3])) * np.float32(0.25)
    acc, k = np.zeros(terms[0].shape, np.float32), 0
    while k <= len(terms) - 4:
        acc = acc + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
        k += 4
    for t in terms[k:]:
        acc = acc + t
    return acc * np.float32(1.0 / (fx * fy))


def _area_linear_coeffs(ssize: int, dsize: int):
    """The source index, the float32 weight of the next one, and the first
    output index that takes one tap only, of OpenCV's bilinear route with
    INTER_AREA's coefficients (``resize`` with ``area_mode``)."""
    inv = dsize / ssize
    scale = 1.0 / inv
    src = np.zeros(dsize, np.int64)
    frac = np.zeros(dsize, np.float32)
    one_tap = dsize
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
        if s + 1 >= ssize:
            one_tap = min(one_tap, d)
            if s >= ssize - 1:
                f, s = np.float32(0.0), ssize - 1
        src[d], frac[d] = s, f
    return src, frac, one_tap


def _enlarge(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """INTER_AREA when an axis grows: bilinear with INTER_AREA's weights,
    rows first, in float32 (``HResizeLinear`` then ``VResizeLinear``)."""
    sx, fx, one_tap = _area_linear_coeffs(x.shape[-1], w)
    sy, fy, _ = _area_linear_coeffs(x.shape[-2], h)
    nx, ny = np.minimum(sx + 1, x.shape[-1] - 1), np.minimum(sy + 1, x.shape[-2] - 1)
    rows = x[..., sx] * (np.float32(1.0) - fx) + x[..., nx] * fx
    rows[..., one_tap:] = x[..., sx[one_tap:]]
    return rows[..., sy, :] * (np.float32(1.0) - fy)[:, None] + rows[..., ny, :] * fy[:, None]


def resize_volume(img_volume: np.ndarray, w: int = 256, h: int = 256) -> np.ndarray:
    """Per-slice ``cv2.resize(im, dsize=(w, h), interpolation=cv2.INTER_AREA)``
    of float32 planes (reference ``utils.py:83-92``) in numpy: (N, H, W) ->
    (N, h, w). OpenCV takes one of three routes, and so does this: when both
    axes shrink, a box mean for integer factors and area weights otherwise;
    when either axis grows, bilinear with INTER_AREA's coefficients. Equal to
    OpenCV's result, value for value, in ``tests/test_torch_port_eval.py``.
    """
    x = np.asarray(img_volume, np.float32)
    sh, sw = x.shape[-2:]
    if (sh, sw) == (h, w):
        return x.copy()
    scale_x, scale_y = sw / w, sh / h
    if scale_x >= 1 and scale_y >= 1:
        fx, fy = round(scale_x), round(scale_y)
        if abs(scale_x - fx) < np.finfo(np.float64).eps and abs(scale_y - fy) < np.finfo(np.float64).eps:
            return _box(x, fy, fx)
        return _shrink(x, h, w)
    return _enlarge(x, h, w)


def crop_volume(vol: np.ndarray, crop_size: int = 112) -> np.ndarray:
    """Center crop of a (N, H, W, ...) volume to 2*crop_size.

    Reference ``src/data_generator_mscmrseg.py:179-183``.
    """
    h0 = int(vol.shape[1] / 2)
    w0 = int(vol.shape[2] / 2)
    return np.array(vol[:, h0 - crop_size : h0 + crop_size, w0 - crop_size : w0 + crop_size])


def reconstruct_volume(vol: np.ndarray, crop_size: int = 112, origin_size: int = 256) -> np.ndarray:
    """Reverse of :func:`crop_volume` — zero-pad back to the original canvas.

    Reference ``src/evaluate_mscmrseg.py:30-44`` (channel-last in/out).
    """
    num_class = vol.shape[-1]
    recon = np.zeros((len(vol), origin_size, origin_size, num_class), dtype=np.float32)
    c0 = origin_size // 2
    recon[:, c0 - crop_size : c0 + crop_size, c0 - crop_size : c0 + crop_size, :] = vol
    return recon
