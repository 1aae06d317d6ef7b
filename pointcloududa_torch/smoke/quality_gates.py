"""The two quality gates of the JAX package, run by the port: the protocols of
``tests/test_uda_quality_gate.py`` and ``tests/test_d4_quality_gate.py``
(their docstrings hold the tasks' design, calibration and history) as
functions, with their seeds, step counts, probes and thresholds unchanged.

- :func:`gate_uda`: UDA (D1+D2) must beat no UDA on target Dice. A
  synthetic two-domain task (bright nested disks; target = contrast 0.45x +
  brightness +0.45 + noise 0.08), 400 steps at 32^2, bs 8, the best probe
  every 50 steps from step 100, over seeds 0, 1, 2: the mean margin above
  +0.01 and at least 2 of 3 seeds positive, with no UDA's best in (0.15,
  0.70) on every seed.
- :func:`gate_d4`: D2+D4 must beat D2 alone on the distractor task of
  ``calibrate_d4`` (400 steps, probes at 200, 300, 400), over seeds 0 and 1:
  the mean margin above +0.05, with D2's best in (0.15, 0.75) on every seed.

Each gate returns its per-seed table; :func:`check_uda` and
:func:`check_d4` raise ``AssertionError`` with the JAX gate's message when
the table fails its conditions. Every run trains from the port's initial
weights drawn from the seed, through the hand-written kernels, in float32
(the configuration's default, as the JAX gates run).

  python -m pointcloududa_torch.smoke.quality_gates

runs both on the card, prints each table beside the JAX gates' calibration
and exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from pointcloududa_torch.smoke.calibrate_d4 import probe_dice, run_arm
from pointcloududa_torch.smoke.smoke_train import make_batch

UDA_SEEDS = (0, 1, 2)
UDA_STEPS = 400
D4_SEEDS = (0, 1)
D4_STEPS = 400
D4_MARGIN = 0.05

# the JAX gates' calibration tables, best target Dice (their docstrings)
UDA_JAX = {"CPU": {0: (0.386, 0.423), 1: (0.419, 0.465), 2: (0.313, 0.395)}}  # seed: (no UDA, D1+D2)
D4_JAX = {"CPU": {0: (0.413, 0.547), 1: (0.441, 0.730)}, "TPU": {0: (0.300, 0.794), 1: (0.475, 0.716)}}  # seed: (d2, d2d4)


def _style_target(imgs, rng):
    """Strong contrast compression + brightness shift + noise: harsh
    enough that source-only training reliably plateaus mid-low on target."""
    return (imgs * 0.45 + 0.45 + rng.normal(0, 0.08, imgs.shape)).astype(np.float32)


def uda_config(uda: bool, size=32, bs=8):
    """The UDA gate's arm (D1+D2 when ``uda``, else none)."""
    from pointcloududa_torch.config import mscmrseg_default

    return mscmrseg_default(
        crop_size=size, fc_inch=0, n_block=2, filters=8, bs=bs,
        d1=uda, d2=uda, dr=0.05,
    )


def uda_pool(seed: int, size=32, bs=8):
    """The gate's 6 pairs of (train batch, target evaluation batch), drawn
    from ``np.random.default_rng(seed)`` in the JAX gate's order."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(6):
        img_s, mask_s = make_batch(rng, bs, size)
        img_t_src, mask_t = make_batch(rng, bs, size)
        pool.append(
            (
                {"img_s": img_s, "mask_s": mask_s, "img_t": _style_target(img_t_src, rng)},
                {"img": _style_target(img_t_src, rng), "mask": mask_t},
            )
        )
    return pool


def uda_train(cfg, state, pool, steps=UDA_STEPS) -> float:
    """Train ``state`` for ``steps`` steps cycling ``pool``; returns the best
    probe Dice (every 50 steps from step 100; 0.0 before the first)."""
    from pointcloududa_torch.train.step import make_eval_step, make_train_step

    step = make_train_step(cfg, state.models, state.optimizers)
    ev = make_eval_step(cfg, state.models[0])
    best = 0.0
    for i in range(steps):
        batch, _ = pool[i % len(pool)]
        state, m = step(state, batch)
        if not np.isfinite(float(m["seg_loss"])):
            raise AssertionError(f"non-finite at step {i}")
        if (i + 1) % 50 == 0 and i + 1 >= 100:
            best = max(best, probe_dice(ev, pool))
    return best


def uda_run(uda: bool, seed: int, steps=UDA_STEPS, device=None) -> float:
    from pointcloududa_torch.train.state import create_train_state

    cfg = uda_config(uda)
    return uda_train(cfg, create_train_state(cfg, seed=seed, device=device), uda_pool(seed), steps)


def gate_uda(seeds=UDA_SEEDS, steps=UDA_STEPS, device=None) -> list:
    """Per seed: no UDA's and D1+D2's best target Dice, their margin and
    each arm's seconds. ``device=None`` is the card (raising without one)."""
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        no_uda = uda_run(False, seed, steps, device)
        t1 = time.perf_counter()
        uda = uda_run(True, seed, steps, device)
        rows.append(dict(seed=seed, no_uda=no_uda, uda=uda, margin=uda - no_uda,
                         seconds=(t1 - t0, time.perf_counter() - t1)))
    return rows


def check_uda(rows) -> None:
    for r in rows:
        # task sanity: source-only must land mid-range (not degenerate,
        # not saturated) for the comparison to mean anything
        if not 0.15 < r["no_uda"] < 0.70:
            raise AssertionError(f"task drifted: seed {r['seed']} no-UDA best {r['no_uda']:.3f}")
    margins = [r["margin"] for r in rows]
    mean_margin = float(np.mean(margins))
    n_positive = sum(m > 0 for m in margins)
    detail = ", ".join(f"seed {r['seed']}: {r['margin']:+.3f}" for r in rows)
    if not (mean_margin > 0.01 and n_positive >= 2):
        raise AssertionError(
            f"UDA (D1+D2) does not beat no-UDA: mean margin {mean_margin:+.3f}, "
            f"{n_positive}/{len(rows)} seeds positive ({detail})"
        )


def gate_d4(seeds=D4_SEEDS, steps=D4_STEPS, device=None) -> list:
    """Per seed: D2's and D2+D4's best target Dice, their margin and each
    arm's seconds. ``device=None`` is the card (raising without one)."""
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        d2_best, _ = run_arm("d2", seed, steps, device=device)
        t1 = time.perf_counter()
        d2d4_best, _ = run_arm("d2d4", seed, steps, device=device)
        rows.append(dict(seed=seed, d2=d2_best, d2d4=d2d4_best, margin=d2d4_best - d2_best,
                         seconds=(t1 - t0, time.perf_counter() - t1)))
    return rows


def check_d4(rows) -> None:
    for r in rows:
        # task sanity: D2-only must land mid-range (not degenerate, not
        # saturated) for the comparison to mean anything
        if not 0.15 < r["d2"] < 0.75:
            raise AssertionError(f"task drifted: seed {r['seed']} d2 best {r['d2']:.3f}")
    mean_margin = float(np.mean([r["margin"] for r in rows]))
    detail = ", ".join(f"seed {r['seed']}: {r['margin']:+.3f}" for r in rows)
    if not mean_margin > D4_MARGIN:
        raise AssertionError(
            f"D2+D4 does not beat D2-only by the calibrated mean margin "
            f"{D4_MARGIN} ({detail})"
        )


def table_lines(rows, arms, jax_tables) -> list:
    """The per-seed table, each row beside the JAX gate's calibration on
    the same seed (``jax_tables``: backend -> seed -> the two arms' bests)."""
    a, b = arms
    lines = [f"  seed  {a:>7s} {b:>7s}  margin   seconds a arm   | JAX calibration ({', '.join(jax_tables)})"]
    for r in rows:
        jax = "; ".join(f"{name} {t[r['seed']][0]:.3f} {t[r['seed']][1]:.3f} {t[r['seed']][1] - t[r['seed']][0]:+.3f}"
                        for name, t in jax_tables.items() if r["seed"] in t)
        lines.append(f"  {r['seed']:4d}  {r[a]:7.3f} {r[b]:7.3f}  {r['margin']:+.3f}  "
                     f"{r['seconds'][0]:6.1f} {r['seconds'][1]:6.1f}   | {jax or '-'}")
    lines.append(f"  mean  {np.mean([r[a] for r in rows]):7.3f} {np.mean([r[b] for r in rows]):7.3f}  "
                 f"{np.mean([r['margin'] for r in rows]):+.3f}")
    return lines


def main(argv=None, device=None):
    """Run both gates at the JAX gates' settings, print their tables and
    return them as ``{"uda": rows, "d4": rows}``; exits 1 if a gate fails.
    ``device=None`` is the card (raising without one), ``device="cpu"`` the
    CPU."""
    argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    from pointcloududa_torch.utils.device import describe, resolve_device

    print(f"quality gates on {describe(resolve_device(device))}")
    tables, failed = {}, []
    for name, gate, check, arms, jax_tables in (("uda", gate_uda, check_uda, ("no_uda", "uda"), UDA_JAX),
                                                 ("d4", gate_d4, check_d4, ("d2", "d2d4"), D4_JAX)):
        tables[name] = rows = gate(device=device)
        print(f"gate_{name}:")
        print("\n".join(table_lines(rows, arms, jax_tables)))
        try:
            check(rows)
            print(f"PASS: gate_{name}")
        except AssertionError as e:
            failed.append(name)
            print(f"FAIL: gate_{name}: {e}")
    if failed:
        sys.exit(1)
    return tables


if __name__ == "__main__":
    main()
