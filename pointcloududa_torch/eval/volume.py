"""Volume inference and scoring for both workloads (counterpart of the JAX
package's ``eval/volume.py``; the same arguments, printing and CSV rows, with
the generator module in place of its flax module and weights).

MS-CMRSeg parity (``src/evaluate_mscmrseg.py:80-231``): per patient 6..45 —
read per-slice PNGs, centre-crop 224, /255, batched forward, reconstruct the
256 canvas, per-class INTER_AREA resize to the native nii size, argmax,
keep-largest-connected-components, relabel {1,2,3}->{200,500,600}, volume
Dice/HD/ASD vs raw labels {500,600,200}.

MM-WHS parity (``src/evaluate_mmwhs.py:82-201``): patients
[1003,1008,1014,1019] — nii volumes flipped up/down+left/right, 2.5-D
stacking of [i-1, i, (i+1)%N] slices as channels, forward, argmax, KLC,
4-structure metrics with try/except -1 sentinels.

The forward runs on the card (or the device the caller names) over
fixed-size batches, the tail zero-padded and sliced off; everything after it
is numpy and scipy on the host, with no OpenCV, PIL or matplotlib (the
port depends on none of them): the LGE slices are decoded by ``utils/png.py``,
CLAHE is ``ops/clahe.py``, the resize ``ops/postprocess.py:resize_volume``,
and the triptychs are written as PNGs by ``utils/png.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.ops import metrics as metrics_lib
from pointcloududa_torch.ops.clahe import clahe as clahe_plane
from pointcloududa_torch.ops.postprocess import (
    crop_volume,
    keep_largest_connected_components,
    reconstruct_volume,
    resize_volume,
    to_categorical,
)
from pointcloududa_torch.utils.device import resolve_device
from pointcloududa_torch.utils.nifti import load_nii
from pointcloududa_torch.utils.png import IMREAD_COLOR, read_png, write_png
from pointcloududa_torch.utils.timer import timeit


def make_volume_forward(gen: torch.nn.Module, device=None, bs: int = 8):
    """Batched logits-only forward with tail padding: ``run(volume_nhwc)``
    takes an (N, H, W, C) float32 numpy volume and returns its (N, H, W,
    n_class) logits as numpy. Each batch of ``bs`` slices goes to ``device``
    in one copy (``None``: the card, raising without one; ``gen`` must live
    there), through ``gen`` in eval mode under ``torch.inference_mode``; the
    module's previous mode is restored afterwards."""
    device = resolve_device(device)

    def run(volume_nhwc: np.ndarray) -> np.ndarray:
        was_training = gen.training
        gen.eval()
        outs = []
        try:
            with torch.inference_mode():
                for i in range(0, len(volume_nhwc), bs):
                    chunk = volume_nhwc[i : i + bs]
                    pad = bs - len(chunk)
                    if pad:
                        chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                    logits = gen(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))[0]
                    outs.append(logits[: bs - pad].cpu().numpy())
        finally:
            gen.train(was_training)
        return np.concatenate(outs, axis=0)

    return run


def apply_clahe(images: np.ndarray, clip_limit: float = 4.0, tile: int = 8) -> np.ndarray:
    """CLAHE per slice/channel (the reference pipes through albumentations'
    CLAHE, ``evaluate_mscmrseg.py:58-61``), equal to OpenCV's bit for bit."""
    out = np.empty_like(images)
    for i, img in enumerate(images):
        for c in range(img.shape[-1]):
            out[i, ..., c] = clahe_plane(img[..., c].astype(np.uint8), clip_limit, tile)
    return out


def _grey(panel: np.ndarray, lo: float, hi: float) -> np.ndarray:
    scaled = (np.asarray(panel, np.float64) - lo) / (hi - lo) if hi > lo else np.zeros(np.shape(panel))
    return np.round(np.clip(scaled, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_triptychs(
    images: np.ndarray, pred: np.ndarray, gt: np.ndarray, outdir: str, prefix: str, vmax: int = 600
) -> None:
    """Write per-slice input/prediction/GT comparison images.

    Headless equivalent of the reference's interactive ``toplot`` loop
    (``evaluate_mscmrseg.py:155-168``): each slice is saved as
    ``<outdir>/<prefix>_<i>.png``, three grey panels side by side, 4 black
    columns apart and top-aligned: the input (first channel) scaled from its
    minimum to its maximum, the prediction and the ground truth from 0 to
    ``vmax``.
    """
    os.makedirs(outdir, exist_ok=True)
    for i, (x, p, m) in enumerate(zip(images, pred, gt)):
        x = x[..., 0] if x.ndim == 3 else x
        panels = [_grey(x, float(x.min()), float(x.max())), _grey(p, 0, vmax), _grey(m, 0, vmax)]
        height = max(q.shape[0] for q in panels)
        gap = np.zeros((height, 4), np.uint8)
        row = []
        for q in panels:
            row += [np.pad(q, ((0, height - q.shape[0]), (0, 0))), gap]
        write_png(os.path.join(outdir, f"{prefix}_{i}.png"), np.concatenate(row[:-1], axis=1))


def _read_lge_slices(data_dir: str, pat_id: int, n_slices: int, clahe: bool) -> np.ndarray:
    imgs = []
    for i in range(n_slices):
        p = os.path.join(data_dir, f"processed/trainB/pat_{pat_id}_lge_{i}.png")
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
        imgs.append(read_png(p, IMREAD_COLOR))
    vol = np.array(imgs)
    return apply_clahe(vol) if clahe else vol


def _summary(acc: dict) -> Dict[str, Dict[str, float]]:
    out = {}
    for s, d in acc.items():
        out[s] = {
            "dice_mean": float(np.around(np.mean(d["dc"]), 3)),
            "dice_std": float(np.around(np.std(d["dc"]), 3)),
            "hd_mean": float(np.around(np.mean(d["hd"]), 3)) if d["hd"] else -1.0,
            "hd_std": float(np.around(np.std(d["hd"]), 3)) if d["hd"] else -1.0,
            "asd_mean": float(np.around(np.mean(d["asd"]), 3)) if d["asd"] else -1.0,
            "asd_std": float(np.around(np.std(d["asd"]), 3)) if d["asd"] else -1.0,
        }
    return out


@timeit
def evaluate_mscmrseg(
    cfg: UDAConfig,
    gen: torch.nn.Module,
    data_dir: str,
    bs: int = 8,
    clahe: bool = False,
    ifhd: bool = True,
    ifasd: bool = True,
    pat_id_range=(6, 46),
    crop_size: int = 224,
    klc: bool = True,
    per_patient_csv: Optional[str] = None,
    toprint: bool = True,
    plot_dir: Optional[str] = None,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Returns {structure: {dice_mean, dice_std, hd_mean, ...}} over the
    patient range. Structures: endo (label 500), rv (600), myo (200).
    ``device``: where the forward runs (``None``: the card)."""
    run = make_volume_forward(gen, device, bs=bs)
    acc = {s: {"dc": [], "hd": [], "asd": []} for s in ("endo", "rv", "myo")}
    rows = []
    for pat_id in range(pat_id_range[0], pat_id_range[1]):
        gt_path = os.path.join(
            data_dir, f"raw_data/labels/lge_test_gt/patient{pat_id}_LGE_manual.nii.gz"
        )
        nimg, _, _ = load_nii(gt_path)
        vol = _read_lge_slices(data_dir, pat_id, nimg.shape[2], clahe)
        vol = crop_volume(vol, crop_size=crop_size // 2)
        x = vol.astype(np.float32) / 255.0  # NHWC already
        logits = run(x)  # (N, 224, 224, C)
        pred = reconstruct_volume(logits, crop_size=crop_size // 2, origin_size=256)
        planes = [
            resize_volume(pred[..., c], w=nimg.shape[0], h=nimg.shape[1])
            for c in range(pred.shape[-1])
        ]
        pred = np.argmax(np.stack(planes, axis=-1), axis=-1)
        if klc:
            pred = keep_largest_connected_components(pred)
        pred = pred.astype(np.uint16)
        for src, dst in ((1, 200), (2, 500), (3, 600)):
            pred = np.where(pred == src, dst, pred)
        masks = nimg.T  # (Z, Y, X) like the per-slice predictions
        if plot_dir:
            save_triptychs(vol, pred, masks, plot_dir, f"pat{pat_id}")
        res = metrics_lib.compute_metrics_on_files(masks, pred, ifhd=ifhd, ifasd=ifasd, toprint=toprint)
        # res order: endo(500), rv(600), myo(200) triplets
        for i, s in enumerate(("endo", "rv", "myo")):
            d, h, a = res[3 * i : 3 * i + 3]
            acc[s]["dc"].append(d)
            if h != -1:
                acc[s]["hd"].append(h)
            if a != -1:
                acc[s]["asd"].append(a)
            rows.append({"DSC": d, "HD": h, "ASD": a, "cat": s, "pad_id": pat_id})
    if per_patient_csv:
        import csv

        with open(per_patient_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["DSC", "HD", "ASD", "cat", "pad_id"])
            w.writeheader()
            w.writerows(rows)
    out = _summary(acc)
    if toprint:
        m = out
        print(
            "Ave endo DC: {dice_mean}, {dice_std}".format(**m["endo"]),
            "| rv: {dice_mean}, {dice_std}".format(**m["rv"]),
            "| myo: {dice_mean}, {dice_std}".format(**m["myo"]),
        )
        print(
            "Ave Dice: {:.3f}".format(
                (m["endo"]["dice_mean"] + m["rv"]["dice_mean"] + m["myo"]["dice_mean"]) / 3.0
            )
        )
    return out


def read_mmwhs_volume(data_dir: str, pat_id: int):
    """2.5-D stacked CT test volume + one-hot GT
    (``evaluate_mmwhs.py:11-29``)."""
    base = os.path.join(data_dir, "PnpAda_release_data/test_ct_image_n_labels")
    img, _, _ = load_nii(os.path.join(base, f"image_ct_{pat_id}.nii.gz"))
    mask, _, _ = load_nii(os.path.join(base, f"gth_ct_{pat_id}.nii.gz"))
    mask = np.asarray(mask, dtype=np.int64)
    img = np.moveaxis(img, 2, 0)[:, ::-1, ::-1]
    mask = np.moveaxis(mask, 2, 0)[:, ::-1, ::-1]
    n = img.shape[0]
    stacked = np.stack([img[[i - 1, i, (i + 1) % n]] for i in range(n)])  # (N,3,H,W)
    stacked = np.moveaxis(stacked, 1, -1)  # NHWC
    onehot = to_categorical(mask[:, np.newaxis], num_classes=5, channel="channel_first")
    return stacked.astype(np.float32), onehot


@timeit
def evaluate_mmwhs(
    cfg: UDAConfig,
    gen: torch.nn.Module,
    data_dir: str,
    bs: int = 8,
    ifhd: bool = True,
    ifasd: bool = True,
    pat_ids=(1003, 1008, 1014, 1019),
    toprint: bool = True,
    per_patient_csv: Optional[str] = None,
    model_name: str = "",
    plot_dir: Optional[str] = None,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """4-structure CT evaluation; structures follow the reference's result
    ordering: myo, la (LA-blood), lv (LV-blood), aa. ``per_patient_csv``
    appends one row of structure-mean DC/HD/ASD per patient (the
    reference's ``save=True`` path, ``evaluate_mmwhs.py:96-103,133-139``).
    ``device``: where the forward runs (``None``: the card).
    """
    run = make_volume_forward(gen, device, bs=bs)
    names = ("myo", "la", "lv", "aa")
    acc = {s: {"dc": [], "hd": [], "asd": []} for s in names}
    rows = []
    for pat_id in pat_ids:
        x, mask_onehot = read_mmwhs_volume(data_dir, pat_id)
        logits = run(x)
        pred = np.argmax(logits, axis=-1)
        pred = keep_largest_connected_components(pred).astype(np.uint16)
        gt = np.argmax(mask_onehot, axis=1)
        if plot_dir:
            save_triptychs(x, pred, gt, plot_dir, f"ct{pat_id}", vmax=4)
        res = metrics_lib.metrics_mmwhs_volume(gt, pred, ifhd=ifhd, ifasd=ifasd, toprint=toprint)
        for i, s in enumerate(names):
            d, h, a = res[3 * i : 3 * i + 3]
            acc[s]["dc"].append(d)
            if h != -1:
                acc[s]["hd"].append(h)
            if a != -1:
                acc[s]["asd"].append(a)
        rows.append(
            {
                "DC": float(np.mean([res[n] for n in (0, 3, 6, 9)])),
                "HD": float(np.mean([res[n] for n in (1, 4, 7, 10)])),
                "ASD": float(np.mean([res[n] for n in (2, 5, 8, 11)])),
                "model": model_name,
                "pad_id": pat_id,
            }
        )
    if per_patient_csv:
        import csv

        exists = os.path.exists(per_patient_csv)
        with open(per_patient_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["DC", "HD", "ASD", "model", "pad_id"])
            if not exists:
                w.writeheader()
            w.writerows(rows)
    out = _summary(acc)
    if toprint:
        mean_dice = np.mean([out[s]["dice_mean"] for s in names])
        print(f"Ave Dice: {mean_dice:.3f}")
    return out
