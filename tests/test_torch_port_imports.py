"""The port never imports JAX: in a fresh interpreter whose import system
refuses ``jax``, ``jaxlib``, ``flax``, ``optax`` and ``orbax``, every module of
``pointcloududa_torch`` imports and one train step runs on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())

    import pointcloududa_torch
    names = [m.name for m in pkgutil.walk_packages(pointcloududa_torch.__path__, "pointcloududa_torch.")]
    for name in names:
        importlib.import_module(name)

    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step

    cfg = mscmrseg_default(d1=True, d2=True, d4=True, filters=4, crop_size=96, fc_inch=1, bs=2,
                           chamfer_impl="pallas", bn_stats_impl="pallas")
    state = create_train_state(cfg, seed=0)
    state, metrics = make_train_step(cfg, state.models, state.optimizers)(state, synthetic_batch(cfg, 2))
    assert all(bool(v.isfinite()) for v in metrics.values()), metrics
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("modules", len(names), "metrics", len(metrics))
    """
)


def test_port_imports_no_jax_and_steps_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},  # see one_torch_thread
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[1])
    assert n_modules >= 17, proc.stdout


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` reaches configuration and data through the port and
    names neither JAX nor the JAX package in an import."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "pointcloududa_torch.train.step" in names
    refused = {"jax", "jaxlib", "flax", "optax", "orbax", "pointcloududa_tpu"}
    assert not [m for m in names if m.split(".")[0] in refused]
