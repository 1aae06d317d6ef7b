"""MS-CMRSeg offline prep: raw NIfTI volumes -> per-slice PNG / npy (the
port's counterpart of the repository's ``tools/prepare_mscmrseg.py``, with
the same subcommands and flags, and no OpenCV: the nearest resize, the
rotation and its matrix are ``ops/host_image.py``, CLAHE ``ops/clahe.py`` and
the PNGs ``utils/png.py``, each equal to OpenCV's call on these inputs).

Equivalent of reference ``src/utils/read_nii_image.py``:

PNG chain (``read_*_nii_save_png``, ``:89-199``):
  min-max rescale to uint8 (labels {0,200,500,600} land on {0,85,212,255} —
  exactly the values the data generator decodes back,
  ``data_generator_mscmrseg.py:262-265``) -> resize to 256 INTER_NEAREST if
  needed -> centre-crop 224 -> CLAHE(clip=2, tiles 4x4) on images only ->
  write one PNG per slice.

NPY chain (``read_*_nii_save_npy``, ``:202-411``):
  resample in-plane to spacing (1.2, 1.2) via linear zoom -> crop ->
  z-score (images) or {200,500,600} -> {1,2,3} (labels) -> one npy per slice.

Usage:
  python -m pointcloududa_torch.prep.prepare_mscmrseg png --modality lge \
      --input ./input --out ./input/processed/trainB --pat 6 46
  python -m pointcloududa_torch.prep.prepare_mscmrseg npy --modality lge --labels ...
  python -m pointcloududa_torch.prep.prepare_mscmrseg rotate --csv ... --out-csv ...
"""

import argparse
import os

import numpy as np

from pointcloududa_torch.data.manifest import load_ids, write_ids
from pointcloududa_torch.data.pointcloud import mask_to_point_cloud
from pointcloududa_torch.ops import host_image
from pointcloududa_torch.ops.clahe import clahe
from pointcloududa_torch.utils.nifti import load_nii
from pointcloududa_torch.utils.png import IMREAD_COLOR, IMREAD_GRAYSCALE, read_png, write_png

MODALITY_FILES = {
    "lge": ("patient{}_LGE.nii.gz", "patient{}_LGE_manual.nii.gz", "lge"),
    "bssfp": ("patient{}_C0.nii.gz", "patient{}_C0_manual.nii.gz", "bSSFP"),
    "t2": ("patient{}_T2.nii.gz", "patient{}_T2_manual.nii.gz", "T2"),
}


def rescale_uint8(vol: np.ndarray) -> np.ndarray:
    """SimpleITK RescaleIntensity + uint8 cast equivalent (truncating)."""
    vol = vol.astype(np.float64)
    lo, hi = vol.min(), vol.max()
    if hi == lo:
        return np.zeros(vol.shape, np.uint8)
    return ((vol - lo) * 255.0 / (hi - lo)).astype(np.uint8)


def resize_nearest(vol: np.ndarray, w: int = 256, h: int = 256) -> np.ndarray:
    return np.array([host_image.resize_nearest(s, (w, h)) for s in vol])


def clahe_volume(vol: np.ndarray) -> np.ndarray:
    return np.array([clahe(s, 2.0, 4) for s in vol])


def crop(vol: np.ndarray, crop_size: int) -> np.ndarray:
    c = crop_size // 2
    h0, w0 = vol.shape[1] // 2, vol.shape[2] // 2
    return vol[:, h0 - c : h0 + c, w0 - c : w0 + c]


def load_volume_zyx(path: str) -> np.ndarray:
    data, _, _ = load_nii(path)  # (X, Y, Z) fortran order like nibabel
    return np.ascontiguousarray(data.T)  # (Z, Y, X) like sitk.GetArrayFromImage


def _raw_path(args, pat_id: int) -> str:
    img_tpl, lbl_tpl, _ = MODALITY_FILES[args.modality]
    sub = os.path.join("labels", args.labels_subdir) if args.labels else "dataset"
    return os.path.join(args.input, "raw_data", sub, (lbl_tpl if args.labels else img_tpl).format(pat_id))


def save_png(args):
    tag = MODALITY_FILES[args.modality][2]
    os.makedirs(args.out, exist_ok=True)
    for pat_id in range(args.pat[0], args.pat[1]):
        vol = rescale_uint8(load_volume_zyx(_raw_path(args, pat_id)))
        if vol.shape[1] != 256 or vol.shape[2] != 256:
            vol = resize_nearest(vol)
        vol = crop(vol, args.crop)
        if not args.labels:
            vol = clahe_volume(vol)
        for i, s in enumerate(vol):
            write_png(os.path.join(args.out, f"pat_{pat_id}_{tag}_{i}.png"), s)
        print(f"saved patient {pat_id} ({len(vol)} slices)")


def save_npy(args):
    from scipy import ndimage

    tag = MODALITY_FILES[args.modality][2]
    os.makedirs(args.out, exist_ok=True)
    for pat_id in range(args.pat[0], args.pat[1]):
        data, affine, header = load_nii(_raw_path(args, pat_id))
        vol = np.ascontiguousarray(data.T).astype(np.float64)
        spacing = np.abs(np.array(header["pixdim"][1:3]))
        factor = spacing / np.array(args.spacing[:2])
        if args.labels:
            # reference chain (read_nii_image.py:252-266): map raw label
            # values first, one-hot, bilinear-zoom the one-hot planes,
            # argmax back, crop — NOT a nearest-neighbour zoom of labels
            for src, dst in ((200, 1), (500, 2), (600, 3)):
                vol = np.where(vol == src, dst, vol)
            onehot = np.eye(4)[vol.astype(np.int64)]  # (Z, H, W, 4)
            onehot = np.moveaxis(onehot, -1, 1)  # (Z, 4, H, W)
            zoomed = ndimage.zoom(onehot, [1.0, 1.0, factor[1], factor[0]], order=1)
            vol = np.argmax(zoomed, axis=1).astype(np.uint8)
            vol = crop(vol, args.crop)
        else:
            vol = ndimage.zoom(vol, [1.0, factor[1], factor[0]], order=1)
            vol = crop(vol, args.crop)
            vol = ((vol - vol.mean()) / vol.std()).astype(np.float32)
        for i, s in enumerate(vol):
            np.save(os.path.join(args.out, f"pat_{pat_id}_{tag}_{i}.npy"), s)
        print(f"saved patient {pat_id} ({len(vol)} slices)")


def offline_rotate(args):
    """Write ``<id>_r1/_r2`` rotated copies of processed image/mask PNGs and
    an augmented datalist including them.

    The reference's MS-CMRSeg datalists contain ``_r1``/``_r2``
    offline-rotation-augmented ids (SURVEY.md §2.2 L1) but its repo ships
    only the csv, not the generator. Convention here: r1 = +angle,
    r2 = -angle (default 15°), nearest-neighbour for masks, bilinear for
    images, constant-0 border. Vertex clouds for the rotated copies are
    regenerated from the rotated masks (data/pointcloud.py).
    """
    ids = load_ids(args.csv)
    # idempotency: when --csv == --out-csv (the reproduce.py chain) a rerun
    # must not double-rotate — skip ids that are themselves rotations
    ids = [i for i in ids if not i.endswith(("_r1", "_r2"))]
    out_ids = list(ids)
    for i, _id in enumerate(ids):
        try:
            img = read_png(os.path.join(args.img_dir, f"{_id}.png"), IMREAD_COLOR)
            mask = read_png(os.path.join(args.mask_dir, f"{_id}.png"), IMREAD_GRAYSCALE)
        except FileNotFoundError:
            raise SystemExit(f"missing slice files for id {_id}")
        h, w = mask.shape
        for tag, sign in (("r1", 1.0), ("r2", -1.0)):
            m = host_image.rotation_matrix_2d((w / 2 - 0.5, h / 2 - 0.5), sign * args.angle, 1.0)
            ri = host_image.warp_affine(img, m, (w, h), nearest=False)
            rm = host_image.warp_affine(mask, m, (w, h), nearest=True)
            rid = f"{_id}_{tag}"
            write_png(os.path.join(args.img_dir, f"{rid}.png"), ri)
            write_png(os.path.join(args.mask_dir, f"{rid}.png"), rm)
            if args.vert_dir:
                np.save(
                    os.path.join(args.vert_dir, f"{rid}.npy"),
                    mask_to_point_cloud((rm > 0).astype(np.uint8), seed=i),
                )
            out_ids.append(rid)
        if i % 100 == 0:
            print(f"{i}/{len(ids)}")
    write_ids(args.out_csv, out_ids)
    print(f"wrote {len(out_ids)} ids to {args.out_csv}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sp = p.add_subparsers(dest="cmd", required=True)
    q = sp.add_parser("rotate", help="offline rotation augmentation (_r1/_r2 ids)")
    q.add_argument("--csv", required=True, help="input datalist")
    q.add_argument("--out-csv", required=True, help="augmented datalist to write")
    q.add_argument("--img-dir", required=True)
    q.add_argument("--mask-dir", required=True)
    q.add_argument("--vert-dir", default="", help="also regenerate vertex npys here")
    q.add_argument("--angle", type=float, default=15.0)
    q.set_defaults(fn=offline_rotate)
    for cmd, fn in (("png", save_png), ("npy", save_npy)):
        q = sp.add_parser(cmd)
        q.add_argument("--modality", choices=list(MODALITY_FILES), required=True)
        q.add_argument("--labels", action="store_true")
        q.add_argument("--input", default="./input")
        q.add_argument("--out", required=True)
        q.add_argument(
            "--labels-subdir",
            default="",
            help="subdirectory under raw_data/labels (the reference varies: "
            "'' for training labels, 'lge_test_gt' for the LGE npy chain, "
            "'t2gt'/'c0gt' for T2/bSSFP)",
        )
        q.add_argument("--pat", nargs=2, type=int, default=[1, 46])
        q.add_argument("--crop", type=int, default=224)
        if cmd == "npy":
            q.add_argument("--spacing", nargs=3, type=float, default=[1.2, 1.2, 5.0])
        q.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
