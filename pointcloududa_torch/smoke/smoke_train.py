"""Convergence smoke: supervised training on a synthetic learnable task
(counterpart of ``tools/smoke_train.py``).

Fabricates slices whose mask is a deterministic function of the image
(nested bright disks -> classes 1..3), runs the port's UDA train step in
supervised-only mode through the hand-written kernels, and reports the
train-Dice trajectory. Passing bar: Dice >= ``--bar`` (0.85) at the last
of ``--steps`` steps: evidence that the losses, the optimiser and the model
wiring learn, beyond the unit tests.

  python -m pointcloududa_torch.smoke.smoke_train --steps 80 --bs 16 --size 224

The packed layouts of the JAX tool's ``--packed`` are not ported.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def make_batch(rng, bs, size, n_class=4):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.empty((bs, size, size, 3), np.float32)
    masks = np.zeros((bs, size, size), np.int32)
    for b in range(bs):
        cy, cx = rng.uniform(0.3, 0.7, size=2) * size
        r = rng.uniform(0.12, 0.25) * size
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        base = rng.normal(0.1, 0.05, size=(size, size)).astype(np.float32)
        lvl = base + 0.9 * (d < r) - 0.4 * (d < 0.6 * r) + 0.3 * (d < 0.3 * r)
        imgs[b] = np.clip(lvl, 0, 1.3)[..., None].repeat(3, -1)
        masks[b][d < r] = 1
        masks[b][d < 0.6 * r] = 2
        masks[b][d < 0.3 * r] = 3
    onehot = np.eye(n_class, dtype=np.float32)[masks]
    return imgs, onehot


def main(argv=None, device=None):
    """Train ``--steps`` steps from seed 0 and return the Dice trajectory,
    ``[(step, seg_dice), ...]`` at every 10th step and the last; exits 1 when
    the last Dice is below ``--bar``. ``device=None`` is the card (raising
    without one), ``device="cpu"`` the CPU."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bar", type=float, default=0.85)
    args = p.parse_args(argv)

    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils.device import describe

    cfg = mscmrseg_default(
        crop_size=args.size, fc_inch=81 if args.size == 224 else 1, bs=args.bs,
        lr=args.lr, compute_dtype=args.dtype,
    )
    state = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, state.models, state.optimizers)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    dices = []
    for i in range(args.steps):
        imgs, masks = make_batch(rng, args.bs, args.size)
        batch = {"img_s": imgs, "mask_s": masks, "img_t": imgs.copy()}
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            d = float(metrics["seg_dice"])
            dices.append((i, d))
            print(f"step {i:4d} seg_loss {float(metrics['seg_loss']):.4f} seg_dice {d:.4f}")
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps * args.bs / dt:.0f} slices/s incl. host datagen) "
          f"on {describe(next(state.models[0].parameters()).device)}")
    final = dices[-1][1]
    if final < args.bar:
        print(f"FAIL: final dice {final:.3f} < {args.bar}")
        sys.exit(1)
    print(f"PASS: final dice {final:.3f} >= {args.bar}")
    return dices


if __name__ == "__main__":
    main()
