"""The D4 (point-cloud adversary) calibration task and its arms
(counterpart of ``tools/calibrate_d4.py``, whose docstring holds the task's
design and its calibration record on the JAX package).

Both domains share one true-structure distribution (nested disks), but
TARGET images also hold a DISTRACTOR: a second nested-disk lookalike that
is an imaging artifact, labelled background. Intensity and entropy
alignment cannot reject it (it is locally indistinguishable from the true
structure); the point-cloud adversary sees the predicted target clouds as
two-lobed, unlike the compact source clouds, and pushes the features to
suppress the distractor. ``tests/test_d4_quality_gate.py`` (and the port's
``quality_gates.gate_d4``) asserts that (D2+D4) beats (D2) on it.

Usage (the card; seeded):
  python -m pointcloududa_torch.smoke.calibrate_d4 --arms none d2 d2d4 --seeds 0 1 --steps 400
Prints one line per (arm, seed) with the best and the last probe Dice.

``run_arm`` is :func:`make_pool` (numpy only: batches, clouds, evaluation
batches, in the JAX tool's order of draws) followed by :func:`train_arm`
(the loop over a given train state), so a test can start the loop from
weights of its choosing.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_shift_batch(rng, bs, size, distractor=True, shape="disk", n_class=4):
    """Source-style batch plus (optionally) a target-only distractor.

    Returns (imgs, onehot_mask, label_mask). The distractor reuses the
    true structure's rendering (same intensity profile) but is labelled
    background — only its GEOMETRY (a second blob => two-lobed shape)
    distinguishes it. ``shape="bar"`` renders the distractor as an
    elongated bar instead of a disk: a shape signature absent from the
    source cloud family entirely.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.empty((bs, size, size, 3), np.float32)
    masks = np.zeros((bs, size, size), np.int32)

    def render(lvl, cy, cx, r):
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        return lvl + 0.9 * (d < r) - 0.4 * (d < 0.6 * r) + 0.3 * (d < 0.3 * r), d

    def render_bar(lvl, cy, cx, r):
        # same nested intensity profile, anisotropic (4:1) support
        d = np.sqrt(((yy - cy) / 2.0) ** 2 + ((xx - cx) * 2.0) ** 2)
        return lvl + 0.9 * (d < r) - 0.4 * (d < 0.6 * r) + 0.3 * (d < 0.3 * r), d

    for b in range(bs):
        cy, cx = rng.uniform(0.30, 0.70, size=2) * size
        r = rng.uniform(0.12, 0.22) * size
        lvl = rng.normal(0.1, 0.05, size=(size, size)).astype(np.float32)
        lvl, d = render(lvl, cy, cx, r)
        if distractor:
            # distractor in the opposite half, same rendering, background GT
            dy = cy + (size / 2 if cy < size / 2 else -size / 2)
            dx = cx + (size / 2 if cx < size / 2 else -size / 2)
            dr_ = rng.uniform(0.10, 0.18) * size
            rfn = render_bar if shape == "bar" else render
            lvl, _ = rfn(lvl, dy, dx, dr_)
        imgs[b] = np.clip(lvl, 0, 1.3)[..., None].repeat(3, -1)
        masks[b][d < r] = 1
        masks[b][d < 0.6 * r] = 2
        masks[b][d < 0.3 * r] = 3
    onehot = np.eye(n_class, dtype=np.float32)[masks]
    return imgs, onehot, masks


def style_target(imgs, rng, contrast=0.55, shift=0.35, noise=0.06):
    return (imgs * contrast + shift + rng.normal(0, noise, imgs.shape)).astype(np.float32)


ARMS = ("none", "d2", "d2d4", "d4aux")


def arm_config(arm: str, size=32, bs=8, dr=0.05, wp=1.0, d4lr=2.5e-5):
    """The arm's configuration (the JAX tool's), through the kernels."""
    from pointcloududa_torch.cli.common import with_kernels
    from pointcloududa_torch.config import mscmrseg_default

    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS} (got {arm!r})")
    d2 = arm in ("d2", "d2d4", "d4aux")
    d4 = arm == "d2d4"
    return with_kernels(mscmrseg_default(
        crop_size=size, fc_inch=9, n_block=2, filters=8, bs=bs,
        d2=d2, d4=d4, d4aux=(arm == "d4aux"), dr=dr, wp=wp, d4lr=d4lr,
    ))


def make_pool(seed: int, point: bool, size=32, bs=8, pool_n=6, shape="disk", src_distractor=False):
    """``pool_n`` pairs of (train batch, target evaluation batch) drawn from
    ``np.random.default_rng(seed)`` in the JAX tool's order; with ``point``
    (the arm has a point head) the clouds of both domains' label masks,
    divided by 255."""
    from pointcloududa_torch.data.pointcloud import mask_to_point_cloud

    rng = np.random.default_rng(seed)

    def clouds(label_masks):
        return (
            np.stack([mask_to_point_cloud(m, seed=0) for m in label_masks]).astype(np.float32)
            / 255.0
        )

    pool = []
    for _ in range(pool_n):
        # --src_distractor: the lookalike appears in the SOURCE domain too,
        # with distractor-excluding GT masks AND clouds
        img_s, mask_s, lab_s = make_shift_batch(
            rng, bs, size, distractor=src_distractor, shape=shape
        )
        img_t_src, mask_t, lab_t = make_shift_batch(rng, bs, size, distractor=True, shape=shape)
        img_t = style_target(img_t_src, rng)
        batch = {"img_s": img_s, "mask_s": mask_s, "img_t": img_t}
        tgt_eval = {"img": style_target(img_t_src, rng), "mask": mask_t}
        if point:
            batch["vert_s"] = clouds(lab_s)
            batch["vert_t"] = clouds(lab_t)
            tgt_eval["vert"] = batch["vert_t"]
        pool.append((batch, tgt_eval))
    return pool


def probe_dice(ev, pool) -> float:
    """Mean target Dice of the evaluation step ``ev`` over the pool."""
    return float(np.mean([float(ev(te)["dice"]) for _, te in pool]))


def train_arm(cfg, state, pool, steps: int, probes=(200, 300, 400), verbose=False, label=""):
    """Train ``state`` for ``steps`` steps cycling ``pool``, probing target
    Dice after the steps in ``probes`` and after the last; returns (best,
    last) probe Dice, or (nan, i) when step i's ``seg_loss`` is not finite."""
    from pointcloududa_torch.train.step import make_eval_step, make_train_step

    step = make_train_step(cfg, state.models, state.optimizers)
    ev = make_eval_step(cfg, state.models[0])
    best, last = 0.0, 0.0
    for i in range(steps):
        batch, _ = pool[i % len(pool)]
        state, m = step(state, batch)
        if not np.isfinite(float(m["seg_loss"])):
            return float("nan"), i
        if i + 1 in probes or i + 1 == steps:
            dice = probe_dice(ev, pool)
            best, last = max(best, dice), dice
            if verbose:
                extra = ""
                if cfg.d4:
                    extra = f" d4 {float(m['dis4_acc1']):.2f}/{float(m['dis4_acc2']):.2f}"
                print(f"  [{label}] step {i + 1} tgt_dice {dice:.3f} "
                      f"src_dice {float(m['seg_dice']):.3f}{extra}", flush=True)
    return best, last


def run_arm(arm: str, seed: int, steps: int, size=32, bs=8, pool_n=6,
            dr=0.05, wp=1.0, d4lr=2.5e-5, shape="disk", probes=(200, 300, 400),
            src_distractor=False, verbose=False, device=None):
    """One (arm, seed) run of the JAX tool's protocol: the port's initial
    weights from ``seed``, the pool from ``seed``; returns (best, last)
    probe Dice. ``device=None`` is the card (raising without one)."""
    from pointcloududa_torch.train.state import create_train_state

    cfg = arm_config(arm, size=size, bs=bs, dr=dr, wp=wp, d4lr=d4lr)
    state = create_train_state(cfg, seed=seed, device=device)
    pool = make_pool(seed, cfg.point_head, size=size, bs=bs, pool_n=pool_n, shape=shape,
                     src_distractor=src_distractor)
    return train_arm(cfg, state, pool, steps, probes=probes, verbose=verbose, label=f"{arm} s{seed}")


def main(argv=None, device=None):
    """Print one line per (arm, seed) and return ``{(arm, seed): (best,
    last)}``. ``device=None`` is the card (raising without one),
    ``device="cpu"`` the CPU."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arms", nargs="+", default=["none", "d2", "d2d4"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--dr", type=float, default=0.05)
    p.add_argument("--wp", type=float, default=1.0)
    p.add_argument("--d4lr", type=float, default=2.5e-5)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--shape", default="disk", choices=["disk", "bar"])
    p.add_argument(
        "--probe_every", type=int, default=0,
        help="probe every N steps from 100 (like the UDA gate's dense "
        "protocol — adversarial trajectories are non-monotone); default "
        "keeps the sparse probes (200,300,400)",
    )
    p.add_argument(
        "--src_distractor", action="store_true",
        help="render the lookalike in SOURCE images too (GT-excluded): "
        "isolates the target-side adversary from source-transfer effects",
    )
    p.add_argument("-v", action="store_true")
    args = p.parse_args(argv)

    from pointcloududa_torch.utils.device import describe, resolve_device

    where = describe(resolve_device(device))
    probes = (
        tuple(range(100, args.steps + 1, args.probe_every))
        if args.probe_every
        else (200, 300, 400)
    )
    results = {}
    for seed in args.seeds:
        for arm in args.arms:
            t0 = time.perf_counter()
            best, last = run_arm(
                arm, seed, args.steps, size=args.size, bs=args.bs,
                dr=args.dr, wp=args.wp, d4lr=args.d4lr, shape=args.shape,
                probes=probes,
                src_distractor=args.src_distractor, verbose=args.v, device=device,
            )
            results[(arm, seed)] = (best, last)
            print(
                f"arm={arm:5s} seed={seed} shape={args.shape} src_dis={int(args.src_distractor)} "
                f"dr={args.dr} wp={args.wp} d4lr={args.d4lr} "
                f"best={best:.3f} last={last:.3f} ({time.perf_counter() - t0:.0f}s on {where})",
                flush=True,
            )
    return results


if __name__ == "__main__":
    main()
