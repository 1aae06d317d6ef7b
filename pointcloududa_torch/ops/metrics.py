"""Host-side segmentation metrics: Dice, Hausdorff, average surface distance.

Self-contained numpy/scipy equivalents of the medpy calls the reference
leans on (``medpy.metric.binary.{dc,hd,asd}``, imported at reference
``src/utils/metric.py:2``), plus the three aggregation helpers mirroring
``src/utils/metric.py`` exactly. Surface distances are intentionally host
code — they are irregular (EDT over binary borders) and off the hot path.

The port's own copy of the JAX package's ``ops/metrics.py`` (numpy and
``scipy.ndimage``), held equal to it by ``tests/test_torch_port_imports.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice_binary(result: np.ndarray, reference: np.ndarray) -> float:
    """Dice coefficient of two binary masks (medpy ``dc`` equivalent)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    intersection = np.count_nonzero(result & reference)
    denom = np.count_nonzero(result) + np.count_nonzero(reference)
    if denom == 0:
        return 0.0
    return 2.0 * intersection / float(denom)


def _surface_distances(
    result: np.ndarray, reference: np.ndarray, voxelspacing=None, connectivity: int = 1
) -> np.ndarray:
    """Distances from the surface voxels of ``result`` to the surface of
    ``reference`` (medpy ``__surface_distances`` equivalent)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    if not result.any():
        raise ValueError("the first supplied array does not contain any binary object")
    if not reference.any():
        raise ValueError("the second supplied array does not contain any binary object")
    footprint = ndimage.generate_binary_structure(result.ndim, connectivity)
    result_border = result ^ ndimage.binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hausdorff_distance(result: np.ndarray, reference: np.ndarray, voxelspacing=None) -> float:
    """Symmetric Hausdorff distance (medpy ``hd`` equivalent)."""
    hd1 = _surface_distances(result, reference, voxelspacing).max()
    hd2 = _surface_distances(reference, result, voxelspacing).max()
    return float(max(hd1, hd2))


def average_surface_distance(result: np.ndarray, reference: np.ndarray, voxelspacing=None) -> float:
    """Asymmetric average surface distance (medpy ``asd`` equivalent):
    mean distance from ``result``'s surface to ``reference``'s surface."""
    return float(_surface_distances(result, reference, voxelspacing).mean())


def evaluate(img_gt: np.ndarray, img_pred: np.ndarray, apply_hd: bool = False, apply_asd: bool = False) -> dict:
    """Per-structure metrics for MS-CMRSeg labels {1: myo, 2: lv, 3: rv}.

    Mirrors reference ``src/utils/metric.py:39-81`` (note the reference
    passes ``asd(gt, pred)`` — gt as the "result" argument — reproduced).
    """
    if img_gt.ndim != img_pred.ndim:
        raise ValueError(
            "The arrays 'img_gt' and 'img_pred' should have the same dimension, "
            f"{img_gt.ndim} against {img_pred.ndim}"
        )
    res = {}
    for c, cls_name in zip([1, 2, 3], ["myo", "lv", "rv"]):
        gt_c = np.clip(np.where(img_gt != c, 0, img_gt), 0, 1)
        pred_c = np.clip(np.where(img_pred != c, 0, img_pred), 0, 1)
        dice = dice_binary(gt_c, pred_c)
        h_d = hausdorff_distance(gt_c, pred_c) if apply_hd else 0
        a_sd = average_surface_distance(gt_c, pred_c) if apply_asd else 0
        res[cls_name] = [dice, h_d, a_sd]
    return res


def metrics2(img_gt: np.ndarray, img_pred: np.ndarray, apply_hd: bool = False, apply_asd: bool = False) -> dict:
    """Per-structure metrics for MM-WHS labels {1: myo, 2: la, 3: lv, 4: aa}.

    Mirrors reference ``src/utils/metric.py:84-113``.
    """
    if img_gt.ndim != img_pred.ndim:
        raise ValueError(
            "The arrays 'img_gt' and 'img_pred' should have the same dimension, "
            f"{img_gt.ndim} against {img_pred.ndim}"
        )
    res = {}
    for c, cls_name in zip([1, 2, 3, 4], ["myo", "la", "lv", "aa"]):
        gt_c = np.where(img_gt == c, 1, 0)
        pred_c = np.where(img_pred == c, 1, 0)
        dice = dice_binary(gt_c, pred_c)
        h_d = hausdorff_distance(gt_c, pred_c) if apply_hd else 0
        a_sd = average_surface_distance(gt_c, pred_c) if apply_asd else 0
        res[cls_name] = [dice, h_d, a_sd]
    return res


def compute_metrics_on_files(gt: np.ndarray, pred: np.ndarray, ifhd: bool = True, ifasd: bool = True, toprint: bool = True):
    """Volume-level Dice/HD/ASD against raw MS-CMRSeg label values
    {500: endo, 600: rv, 200: myo} with -1 sentinels for empty structures.

    Mirrors reference ``src/utils/metric.py:116-174`` including the order
    of the returned 9-tuple (endo, rv, myo) and the console format.
    """
    res = []
    for c in [500, 600, 200]:
        gt_c = np.clip(np.where(gt != c, 0, gt), 0, 1)
        pred_c = np.clip(np.where(pred != c, 0, pred), 0, 1)
        dice = dice_binary(gt_c, pred_c)
        h_d, a_sd = -1.0, -1.0
        if ifhd or ifasd:
            if np.sum(gt_c) == 0 or np.sum(pred_c) == 0:
                dice = -1.0
            else:
                h_d = hausdorff_distance(gt_c, pred_c) if ifhd else h_d
                a_sd = average_surface_distance(gt_c, pred_c) if ifasd else a_sd
        res += [dice, h_d, a_sd]
    if toprint:
        res_str = ["{:.3f}".format(r) for r in res]
        fmt = "Endo {:>8} , {:>8} , {:>8} , RV {:>8} , {:>8} , {:>8} , Myo {:>8} , {:>8} , {:>8}"
        print(fmt.format(*res_str))
    return res


def metrics_mmwhs_volume(img_gt: np.ndarray, img_pred: np.ndarray, ifhd: bool = True, ifasd: bool = True, toprint: bool = True):
    """Volume-level metrics for the 4 MM-WHS structures with try/except -1
    sentinels — mirrors reference ``src/evaluate_mmwhs.py:32-79``."""
    res = []
    for c in range(1, 5):
        gt_c = np.where(img_gt == c, 1, 0)
        pred_c = np.where(img_pred == c, 1, 0)
        dice = dice_binary(gt_c, pred_c)
        try:
            h_d = hausdorff_distance(gt_c, pred_c) if ifhd else -1
        except ValueError:
            h_d = -1
        try:
            a_sd = average_surface_distance(gt_c, pred_c) if ifasd else -1
        except ValueError:
            a_sd = -1
        res += [dice, h_d, a_sd]
    if toprint:
        res_str = ["{:.3f}".format(r) for r in res]
        fmt = (
            "Myo {:>8} , {:>8} , {:>8} , LA-blood {:>8} , {:>8} , {:>8} , "
            "LV-blood {:>8} , {:>8} , {:>8} , AA {:>8} , {:>8} , {:>8}"
        )
        print(fmt.format(*res_str))
    return res
