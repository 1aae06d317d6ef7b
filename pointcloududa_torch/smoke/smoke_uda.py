"""Adversarial-path smoke: the whole UDA training step on a synthetic
two-domain task (counterpart of ``tools/smoke_uda.py``).

Source domain: bright nested disks on dark noise (labelled). Target domain:
the same geometry, inverted contrast and heavier noise (labels withheld from
training, used only to score target Dice). Runs the port's triple-phase step
with D1+D2 (and D4 with ``--d4``, on point clouds made from the masks) through
the hand-written kernels and checks the mechanics:

- all losses stay finite through ``--steps`` steps,
- the discriminators train (their accuracies leave 0.5 and stay in (0, 1)),
- source Dice rises as in the supervised smoke (>= 0.5 at the last step),
- target Dice is reported (what this horizon can show is stability, not the
  paper's converged gains, which take the reference's 25k-step schedule).

  python -m pointcloududa_torch.smoke.smoke_uda --steps 150 --d4

The packed layouts of the JAX tool's ``--packed`` are not ported.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from pointcloududa_torch.smoke.smoke_train import make_batch


def style_target(imgs, rng):
    """Invert contrast + extra noise: a crude 'other modality'."""
    out = 1.1 - imgs + rng.normal(0, 0.08, size=imgs.shape).astype(np.float32)
    return np.clip(out, 0, 1.3)


def make_pool(rng, n, bs, size, d4):
    """``n`` pairs of (train batch, target evaluation batch), drawn from
    ``rng`` in the JAX tool's order; with ``d4`` the (B, 300, 3) clouds of
    both domains' masks, divided by 255 as the device preprocess would."""
    from pointcloududa_torch.data.pointcloud import mask_to_point_cloud

    pool = []
    for _ in range(n):
        img_s, mask_s = make_batch(rng, bs, size)
        img_t_src, mask_t = make_batch(rng, bs, size)
        img_t = style_target(img_t_src, rng)
        batch = {"img_s": img_s, "mask_s": mask_s, "img_t": img_t}
        if d4:
            lab_s = np.argmax(mask_s, -1)
            lab_t = np.argmax(mask_t, -1)
            batch["vert_s"] = (
                np.stack([mask_to_point_cloud(m, seed=0) for m in lab_s]).astype(np.float32) / 255.0
            )
            batch["vert_t"] = (
                np.stack([mask_to_point_cloud(m, seed=0) for m in lab_t]).astype(np.float32) / 255.0
            )
        tgt_eval = {"img": img_t, "mask": mask_t}
        if d4:
            tgt_eval["vert"] = batch["vert_t"]
        pool.append((batch, tgt_eval))
    return pool


def main(argv=None, device=None):
    """Train ``--steps`` steps from seed 0, probing target Dice every 25th
    step and at the last, and return the probes, one dict of the printed
    values a probe; exits 1 on a non-finite metric or a last source Dice
    below 0.5. ``device=None`` is the card (raising without one),
    ``device="cpu"`` the CPU."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--pool", type=int, default=12, help="pre-generated batches to cycle")
    p.add_argument("--d4", action="store_true")
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)

    from pointcloududa_torch.cli.common import with_kernels
    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_eval_step, make_train_step
    from pointcloududa_torch.utils.device import describe

    cfg = with_kernels(mscmrseg_default(
        crop_size=args.size,
        fc_inch=81 if args.size == 224 else 1,
        bs=args.bs,
        d1=True,
        d2=True,
        d4=args.d4,
        compute_dtype=args.dtype,
    ))
    state = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, state.models, state.optimizers)
    eval_step = make_eval_step(cfg, state.models[0])
    pool = make_pool(np.random.default_rng(0), args.pool, args.bs, args.size, args.d4)

    t0 = time.perf_counter()
    ok = True
    probes = []
    for i in range(args.steps):
        batch, tgt_eval = pool[i % len(pool)]
        state, m = step(state, batch)
        if i % 25 == 0 or i == args.steps - 1:
            te = eval_step(tgt_eval)
            vals = {k: float(v) for k, v in m.items()}
            tgt_dice = float(te["dice"])
            probes.append({"step": i, "tgt_dice": tgt_dice, **vals})
            print(
                f"step {i:4d} seg_loss {vals['seg_loss']:.4f} adv {vals['adv_loss']:.4f} "
                f"src_dice {vals['seg_dice']:.3f} tgt_dice {tgt_dice:.3f} "
                f"d1 {vals['dis1_acc1']:.2f}/{vals['dis1_acc2']:.2f} "
                f"d2 {vals['dis2_acc1']:.2f}/{vals['dis2_acc2']:.2f}"
                + (f" d4 {vals['dis4_acc1']:.2f}/{vals['dis4_acc2']:.2f}" if args.d4 else "")
            )
            if not all(np.isfinite(v) for v in vals.values()):
                ok = False
                break
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps * args.bs / dt:.0f} slices/s) "
          f"on {describe(next(state.models[0].parameters()).device)}")
    src_dice = float(m["seg_dice"])
    if not ok:
        print("FAIL: non-finite metrics")
        sys.exit(1)
    if src_dice < 0.5:
        print(f"FAIL: source dice {src_dice:.3f} < 0.5")
        sys.exit(1)
    print(f"PASS: finite adversarial training, source dice {src_dice:.3f}")
    return probes


if __name__ == "__main__":
    main()
