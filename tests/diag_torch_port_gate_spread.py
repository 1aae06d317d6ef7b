"""How far the two quality gates' outcomes move when nothing changes but the
order of f32 sums or the initial draw, in JAX and in the port.

The gates (``tests/test_uda_quality_gate.py``, ``tests/test_d4_quality_gate.py``;
the port's ``pointcloududa_torch/smoke/quality_gates.py``) take the best
target-Dice probe of a 400-step adversarial run at a few seeds. This script
runs their four arms (UDA gate: no UDA and D1+D2; D4 gate: D2 and D2+D4) over
any seeds, with the gates' pools, steps and probes, and prints each run's
best probe and each gate's margins:

- ``jax``: the JAX package on the CPU, from its own initial weights for the
  seed (the gates' runs); ``--permuted`` reorders each batch's samples (the
  same function of the batch, its sums in another order).
- ``export DIR``: JAX's initial weights of every arm and seed to
  ``DIR/<arm>_s<seed>.npz``.
- ``port``: the port on ``--device`` (``cuda`` on the card), from its own
  initial weights for the seed (the port's gates' runs), or with ``--init
  DIR`` from JAX's exported ones (on the card too: this mode imports no JAX).

- ``init``: the port's initial weights against JAX's, per tensor of every
  arm's nets pooled over the seeds: standard deviation, excess kurtosis and
  the share beyond two standard deviations (the same distribution or not).

``--log FILE`` writes each run's per-step metrics as JSON lines;
``diverge A B`` prints, for two such files, the first step at which each
metric of the same (arm, seed) differs by 1e-4, 1e-3 and 1e-2.

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/diag_torch_port_gate_spread.py jax --seeds 0 1 2 3 4 5 --jobs 8
  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/diag_torch_port_gate_spread.py export build/gate_init
  PYTHONPATH=. python tests/diag_torch_port_gate_spread.py port --device cuda --init build/gate_init
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ARMS = {"uda": ("none", "uda"), "d4": ("d2", "d2d4")}
LOGGED = ("seg_loss", "adv_loss", "d1_loss", "d2_loss", "d4_loss", "seg_dice")


def _probes(gate):
    return tuple(range(100, 401, 50)) if gate == "uda" else (200, 300, 400)


def _port_config(arm):
    from pointcloududa_torch.smoke import calibrate_d4, quality_gates

    return quality_gates.uda_config(arm == "uda") if arm in ARMS["uda"] else calibrate_d4.arm_config(arm)


def _pool(arm, seed, permuted):
    """The gate's pool (the port's copy, bit-equal to the JAX gates' pools:
    tests/test_torch_port_quality_gates.py), each batch's samples reordered
    under ``permuted``."""
    from pointcloududa_torch.smoke import calibrate_d4, quality_gates

    pool = quality_gates.uda_pool(seed) if arm in ARMS["uda"] else calibrate_d4.make_pool(seed, arm == "d2d4")
    if not permuted:
        return pool
    rng = np.random.default_rng(1000 + seed)
    out = []
    for batch, tgt_eval in pool:
        p, q = rng.permutation(len(batch["img_s"])), rng.permutation(len(batch["img_t"]))
        out.append(({k: v[q] if k in ("img_t", "vert_t") else v[p] for k, v in batch.items()}, tgt_eval))
    return out


def _jax_config(arm):
    from pointcloududa_tpu.config import mscmrseg_default

    if arm in ARMS["uda"]:
        return mscmrseg_default(crop_size=32, fc_inch=0, n_block=2, filters=8, bs=8, d1=arm == "uda", d2=arm == "uda",
                                dr=0.05)
    return mscmrseg_default(crop_size=32, fc_inch=9, n_block=2, filters=8, bs=8, d2=True, d4=arm == "d2d4", dr=0.05,
                            wp=1.0, d4lr=2.5e-5)


def run(mode, gate, arm, seed, permuted=False, init=None, device="cpu"):
    """One 400-step run; returns its record (best probe, probes, per-step metrics)."""
    probes = _probes(gate)
    pool = _pool(arm, seed, permuted)
    log, traj = [], []
    t0 = time.perf_counter()
    if mode == "jax":
        import jax

        from pointcloududa_tpu.train.state import build_models, build_optimizers, create_train_state
        from pointcloududa_tpu.train.step import make_eval_step, make_train_step

        cfg = _jax_config(arm)
        state = create_train_state(cfg, jax.random.PRNGKey(seed))
        models = build_models(cfg)
        step = make_train_step(cfg, models, build_optimizers(cfg))
        ev = make_eval_step(cfg, models[0])

        def probe(st):
            return float(np.mean([float(ev(st.gen, te)["dice"]) for _, te in pool]))
    else:
        import torch

        from pointcloududa_torch.smoke.calibrate_d4 import probe_dice
        from pointcloududa_torch.train.state import create_train_state
        from pointcloududa_torch.train.step import make_eval_step, make_train_step
        from pointcloududa_torch.utils import weights

        torch.set_num_threads(1)
        cfg = _port_config(arm)
        state = create_train_state(cfg, seed=seed, device=device)
        if init:
            weights.load_jax_variables(state.models, _nested(os.path.join(init, f"{arm}_s{seed}.npz")))
        step = make_train_step(cfg, state.models, state.optimizers)
        port_ev = make_eval_step(cfg, state.models[0])

        def probe(st):
            return probe_dice(port_ev, pool)
    for i in range(400):
        state, m = step(state, pool[i % len(pool)][0])
        log.append({k: float(v) for k, v in m.items() if k in LOGGED})
        if i + 1 in probes:
            traj.append((i + 1, probe(state)))
    return {"mode": mode, "gate": gate, "arm": arm, "seed": seed, "permuted": permuted,
            "init": "jax" if init or mode == "jax" else "port", "device": str(device),
            "best": max(d for _, d in traj), "probes": traj, "steps": log, "seconds": time.perf_counter() - t0}


def _nested(path):
    """An exported npz (``net/params/...`` keys) -> the nets of ``utils/weights.py:load_jax_variables``."""
    z = np.load(path)
    tree = {}
    for key in z.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return tree


def export(directory, seeds, gates):
    import jax

    from pointcloududa_tpu.train.state import create_train_state

    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if hasattr(v, "items") else {prefix + k: np.asarray(v)})
        return out

    os.makedirs(directory, exist_ok=True)
    for gate in gates:
        for arm in ARMS[gate]:
            for seed in seeds:
                state = create_train_state(_jax_config(arm), jax.random.PRNGKey(seed))  # eager, as the gates draw it
                arrays = {}
                for net in ("gen", "d1", "d2", "d4"):
                    ns = getattr(state, net)
                    if ns is not None:
                        arrays.update(flat(dict(ns.params), f"{net}/params/"))
                        arrays.update(flat(dict(ns.batch_stats), f"{net}/batch_stats/"))
                np.savez(os.path.join(directory, f"{arm}_s{seed}.npz"), **arrays)


def init_stats(seeds):
    import jax
    import torch

    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.utils import weights
    from pointcloududa_tpu.train.state import create_train_state as jax_create_train_state

    pooled = {}
    for arm in ("uda", "d2d4"):  # between them every net of every arm
        for seed in seeds:
            port = create_train_state(_port_config(arm), seed=seed, device="cpu")
            state = jax_create_train_state(_jax_config(arm), jax.random.PRNGKey(seed))
            nets = {k: {"params": jax.tree_util.tree_map(np.asarray, getattr(state, k).params),
                        "batch_stats": jax.tree_util.tree_map(np.asarray, getattr(state, k).batch_stats)}
                    for k in ("gen", "d1", "d2", "d4") if getattr(state, k) is not None}
            ref = weights.state_dicts(nets)
            for key, module in zip(("gen", "d1", "d2", "d4"), port.models):
                for name, t in (module.state_dict().items() if module is not None else ()):
                    if t.dtype == torch.float32 and "running" not in name and t.numel() > 1:
                        for who, x in (("port", t.numpy()), ("jax", ref[key][name].numpy())):
                            pooled.setdefault((arm, key, name), {}).setdefault(who, []).append(x.ravel())
    for (arm, key, name), both in sorted(pooled.items()):
        row = []
        for who in ("port", "jax"):
            x = np.concatenate(both[who])
            sd = x.std()
            kurt = float(((x - x.mean()) ** 4).mean() / sd ** 4 - 3) if sd > 0 else 0.0
            row.append(f"{who} std {sd:.4g} kurt {kurt:+.2f} beyond 2 sd {np.mean(np.abs(x - x.mean()) > 2 * sd):.4f}")
        print(f"{arm:4s} {key:3s} {name:36s} n={x.size:8d}  " + "; ".join(row))


def _run_star(kw):
    return run(**kw)


def report(records):
    by = {(r["gate"], r["arm"], r["seed"]): r for r in records}
    for gate, (a, b) in ARMS.items():
        seeds = sorted({s for g, _, s in by if g == gate})
        if not seeds:
            continue
        print(f"{gate} gate: seed, best {a}, best {b}, margin")
        margins = []
        for s in seeds:
            if (gate, a, s) in by and (gate, b, s) in by:
                x, y = by[gate, a, s]["best"], by[gate, b, s]["best"]
                margins.append(y - x)
                print(f"  {s}  {x:.3f}  {y:.3f}  {y - x:+.3f}")
        if margins:
            print(f"  mean margin {np.mean(margins):+.3f}, {sum(m > 0 for m in margins)}/{len(margins)} positive")


def diverge(path_a, path_b):
    a = {(r["gate"], r["arm"], r["seed"]): r for r in map(json.loads, open(path_a))}
    b = {(r["gate"], r["arm"], r["seed"]): r for r in map(json.loads, open(path_b))}
    for key in sorted(set(a) & set(b)):
        for metric in LOGGED:
            if metric not in a[key]["steps"][0]:
                continue
            d = np.abs(np.array([s[metric] for s in a[key]["steps"]]) - np.array([s[metric] for s in b[key]["steps"]]))
            first = [int(np.argmax(d > t)) if (d > t).any() else None for t in (1e-4, 1e-3, 1e-2)]
            print(f"{key}: {metric} first step differing by 1e-4, 1e-3, 1e-2: {first}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["jax", "port", "export", "diverge", "init"])
    p.add_argument("paths", nargs="*", help="export: DIR; diverge: two --log files")
    p.add_argument("--gates", nargs="+", default=["uda", "d4"], choices=list(ARMS))
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--permuted", action="store_true")
    p.add_argument("--init", default=None, help="port: a directory that export wrote")
    p.add_argument("--device", default="cpu")
    p.add_argument("--jobs", type=int, default=1, help="runs at once, each in its own process (CPU)")
    p.add_argument("--log", default=None)
    args = p.parse_args(argv)
    if args.mode == "export":
        return export(args.paths[0], args.seeds, args.gates)
    if args.mode == "diverge":
        return diverge(*args.paths)
    if args.mode == "init":
        return init_stats(args.seeds)
    if args.device != "cpu":
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    jobs = [dict(mode=args.mode, gate=g, arm=a, seed=s, permuted=args.permuted,
                 init=args.init, device=args.device) for g in args.gates for a in ARMS[g] for s in args.seeds]
    records = []
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn")) as pool:
            for r in pool.map(_run_star, jobs):
                records.append(r)
                print(f"{r['gate']} {r['arm']} seed {r['seed']}: best {r['best']:.3f} ({r['seconds']:.0f} s)", flush=True)
    else:
        for kw in jobs:
            r = run(**kw)
            records.append(r)
            print(f"{r['gate']} {r['arm']} seed {r['seed']}: best {r['best']:.3f} ({r['seconds']:.0f} s)", flush=True)
    if args.log:
        with open(args.log, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    report(records)


if __name__ == "__main__":
    main()
