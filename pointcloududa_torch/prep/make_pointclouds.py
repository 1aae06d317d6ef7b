"""Offline point-cloud ground truth: mask files -> 300x3 vertex ``.npy`` (the
port's counterpart of the repository's ``tools/make_pointclouds.py``).

Equivalent of reference ``src/utils/npy2point.py:33-98`` (``npy2point``):
binarise -> stack x3 -> surface extraction -> farthest-point sampling ->
int voxel coords; zero array when the mask is (near) empty. Surface
extraction is boundary-voxel based (see data/pointcloud.py for the
documented deviation from PyMCubes) and FPS runs in the port's host library
(``utils/host_native.py``).

Supports both dataset layouts:
  - MM-WHS: ``<dir>/mask/*.npy`` -> ``<dir>/vertices/*.npy``
  - MS-CMRSeg: ``<dir>/*.png`` mask images -> ``<out>/*.npy``
Optionally writes 2-D "plots" (256x256 binary images of the sampled points,
``npy2point.py:88,96``) with --plots. Outputs that exist are skipped.
"""

import argparse
import glob
import os

import numpy as np

from pointcloududa_torch.data.pointcloud import mask_to_point_cloud
from pointcloududa_torch.utils.png import IMREAD_GRAYSCALE, read_png


def load_mask(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        m = np.load(path)
        return m[..., 0] if m.ndim == 3 else m
    return read_png(path, IMREAD_GRAYSCALE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--masks", required=True, help="directory of mask .npy/.png files")
    p.add_argument("--out", required=True, help="output vertices directory")
    p.add_argument("--plots", default="", help="optional plots output directory")
    p.add_argument("--points", type=int, default=300)
    p.add_argument("--seed", type=int, default=-1, help=">=0 for deterministic FPS start")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.plots:
        os.makedirs(args.plots, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.masks, "*.npy"))) or sorted(
        glob.glob(os.path.join(args.masks, "*.png"))
    )
    if not paths:
        raise SystemExit(f"no mask files in {args.masks}")
    for i, path in enumerate(paths):
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out, name + ".npy")
        if os.path.exists(out_path):
            continue
        mask = load_mask(path)
        seed = None if args.seed < 0 else args.seed + i
        verts = mask_to_point_cloud(mask, number_points=args.points, seed=seed)
        np.save(out_path, verts)
        if args.plots:
            plot = np.zeros(mask.shape[:2])
            v = verts.astype(int)
            valid = verts.sum() != 0
            if valid:
                plot[np.clip(v[:, 1], 0, plot.shape[0] - 1), np.clip(v[:, 2], 0, plot.shape[1] - 1)] = 1
            np.save(os.path.join(args.plots, name + ".npy"), plot)
        if i % 200 == 0:
            print(f"{i}/{len(paths)}")
    print("finish")


if __name__ == "__main__":
    main()
