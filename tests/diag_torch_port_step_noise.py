"""How far f32 summation order alone moves the MM-WHS train step: the noise
floor behind the tolerances of ``test_torch_port_step.py``.

Not a test (pytest does not collect it). Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/diag_torch_port_step_noise.py

It steps three ways from the same weights on the same batches: the JAX step,
the port's step, and the JAX step again on each batch with its samples
permuted (the same function in another sum order). Part 1 prints, for the
``softmax + D1 + D2 + etpls`` configuration over three steps, every metric
where port-vs-JAX or JAX-vs-permuted-JAX exceeds a tenth of the step tolerance
(rtol 2e-3, atol 2e-4), as multiples of it. Part 2 prints, for ``-sgd`` over
two steps, each generator tensor's largest difference as a share of its
largest update, for both pairs. Filters 8, 96^2, bs 4, CPU.
"""

import os
import sys

import numpy as np
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_step import ATOL, BS, RTOL, _mmwhs_cfg, _steps  # noqa: E402
from pointcloududa_tpu.data.synthetic import synthetic_batch  # noqa: E402
from pointcloududa_torch.utils import weights  # noqa: E402

PERM = np.array([2, 0, 3, 1])


def _three_ways(cfg, steps, seed0):
    jfn, jst, st, step = _steps(cfg)
    _, jst_p, _, _ = _steps(cfg)
    for i in range(steps):
        batch = synthetic_batch(cfg, BS, seed=seed0 + i)
        jst, jm = jfn(jst, batch)
        st, tm = step(st, batch)
        jst_p, pm = jfn(jst_p, {k: v[PERM] for k, v in batch.items()})
        yield i, jst, st, jst_p, jm, tm, pm


def metrics_noise():
    print("softmax + D1 + D2 + etpls, default init: |difference| / (atol + rtol * |jax|)")
    for i, _, _, _, jm, tm, pm in _three_ways(_mmwhs_cfg(d1=True, etpls=True), 3, 10):
        for key in sorted(jm):
            a, b, c = float(jm[key]), float(tm[key]), float(pm[key])
            tol = ATOL + RTOL * abs(a)
            if max(abs(a - b), abs(a - c)) > 0.1 * tol:
                print(f"  step {i} {key:16s} jax {a:.6f}  port {abs(a - b) / tol:6.2f}x (|d| {abs(a - b):.2e})  "
                      f"jax permuted {abs(a - c) / tol:6.2f}x (|d| {abs(a - c):.2e})")


def sgd_update_noise():
    print("-sgd, two steps: max |difference| / max |update| per generator tensor (updates > 1e-6)")
    cfg = _mmwhs_cfg(sgd=True)
    init = None
    for _, jst, st, jst_p, _, _, _ in _three_ways(cfg, 2, 20):
        if init is None:  # the port's weights after step 0 are not the init; rebuild it
            init = {k: v.clone() for k, v in _steps(cfg)[2].models[0].state_dict().items()}
    as_sd = lambda s: weights.generator_state_dict(  # noqa: E731
        jax.device_get({"params": s.gen.params, "batch_stats": s.gen.batch_stats}))
    want, perm, got = as_sd(jst), as_sd(jst_p), st.models[0].state_dict()
    worst = [0.0, 0.0]
    for key, w in want.items():
        if "running" in key or key.endswith("num_batches_tracked"):
            continue
        upd = float((w - init[key]).abs().max())
        if upd <= 1e-6:
            continue
        r = [float((got[key] - w).abs().max()) / upd, float((perm[key] - w).abs().max()) / upd]
        worst = [max(a, b) for a, b in zip(worst, r)]
        print(f"  {key:32s} update {upd:.2e}  port {r[0]:.2e}  jax permuted {r[1]:.2e}")
    print(f"  worst: port {worst[0]:.2e}, jax permuted {worst[1]:.2e}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    metrics_noise()
    sgd_update_noise()
