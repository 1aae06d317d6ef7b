"""The port never imports JAX nor the JAX package: in a fresh interpreter
whose import system refuses ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``
and ``pointcloududa_tpu``, every module of ``pointcloududa_torch`` imports and
one train step runs on the CPU; no source file of the port names one of them
in an import; the port's own copy of the configuration module agrees with the
JAX package's; and the port's entry points refuse to start without a card
unless they are told to use the CPU."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax", "pointcloududa_tpu"}

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
    state = create_train_state(cfg, seed=0, device="cpu")
    state, metrics = make_train_step(cfg, state.models, state.optimizers)(state, synthetic_batch(cfg, 2))
    assert all(bool(v.isfinite()) for v in metrics.values()), metrics

    # the MM-WHS path: raw batch -> device preprocess (light augmentation,
    # regenerated clouds) -> step
    import torch
    from pointcloududa_torch.config import mmwhs_default
    from pointcloududa_torch.data.synthetic import synthetic_raw_batch
    from pointcloududa_torch.train.loop import make_device_preprocess
    cfg = mmwhs_default(softmax=True, d2=True, d4=True, aug="light", filters=4, crop_size=96, fc_inch=1, bs=2)
    state = create_train_state(cfg, seed=0, device="cpu")
    batch = make_device_preprocess(cfg, True, True, device="cpu")(torch.Generator().manual_seed(0), synthetic_raw_batch(cfg, 2))
    state, metrics = make_train_step(cfg, state.models, state.optimizers)(state, batch)
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
    assert n_modules >= 23, proc.stdout


REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax", "pointcloududa_tpu"}


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return names


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` reaches configuration and data through the port and
    names neither JAX nor the JAX package in an import."""
    names = _imported_names(os.path.join(ROOT, "chip_smoke.py"))
    assert "pointcloududa_torch.train.step" in names and "pointcloududa_torch.train.loop" in names
    assert not [m for m in names if m.split(".")[0] in REFUSED]


def test_no_source_file_of_the_port_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "pointcloududa_torch", "**", "*.py"), recursive=True)
    assert len(files) >= 23
    bad = {os.path.relpath(p, ROOT): [m for m in _imported_names(p) if m.split(".")[0] in REFUSED] for p in files}
    assert not {p: m for p, m in bad.items() if m}


def _both_configs():
    import pointcloududa_torch.config as port
    import pointcloududa_tpu.config as ref

    return port, ref


def test_config_fields_and_defaults_equal_the_jax_package():
    port, ref = _both_configs()
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(port.UDAConfig) == fields(ref.UDAConfig)
    assert dataclasses.asdict(port.UDAConfig()) == dataclasses.asdict(ref.UDAConfig())
    with pytest.raises(ValueError):
        port.UDAConfig(vert_t_every=0)
    a = port.UDAConfig(d4aux=True, dmmt=0.9)
    b = ref.UDAConfig(d4aux=True, dmmt=0.9)
    assert a.point_head and b.point_head and not port.UDAConfig().point_head
    assert [a.disc_momentum(d) for d in ("d1", "d2", "d4")] == [b.disc_momentum(d) for d in ("d1", "d2", "d4")]
    # a config JSON moves between the packages, the kernel selectors included
    cfg = port.mmwhs_default(chamfer_impl="pallas", bn_stats_impl="pallas", aug="light", d4=True)
    assert dataclasses.asdict(ref.UDAConfig.from_json(cfg.to_json())) == dataclasses.asdict(cfg)
    assert port.UDAConfig.from_json(ref.UDAConfig.from_json(cfg.to_json()).to_json()) == cfg


@pytest.mark.parametrize(
    "preset,flags",
    [
        ("mscmrseg_default", {}),
        ("mscmrseg_default", dict(d1=True, d2=True, d4=True, aug="", offdecay=False, decay_e=30, wp=0.5)),
        ("mscmrseg_default", dict(d4=True, aug="aug2", lr_fix=2e-4, apdx="run7")),
        ("mmwhs_default", {}),
        ("mmwhs_default", dict(softmax=True, d2=True, d4=True, aug="light", sgd=True, mh=True, etpls=True)),
        ("mmwhs_default", dict(d1=True, d4aux=True, aug="heavy", filters=16, mmt=0.9, dmmt=0.9, w1=2.0, w4=0.5,
                               Tetpls=True, heinit=True, extd1=True, extpn=True, ft=True, dr=0.1)),
        ("mmwhs_default", dict(d2=True, d1mmt=0.9, d4mmt=0.8, cvinit=True, extd2=True, extd4=True, w2=3.0)),
    ],
)
def test_presets_and_appendix_equal_the_jax_package(preset, flags):
    port, ref = _both_configs()
    a, b = getattr(port, preset)(**flags), getattr(ref, preset)(**flags)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert port.appendix(a) == ref.appendix(b)


def test_synthetic_batches_equal_the_jax_package():
    import numpy as np

    import pointcloududa_torch.data.synthetic as port
    import pointcloududa_tpu.data.synthetic as ref
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default

    for cfg in (mscmrseg_default(d4=True, crop_size=16), mmwhs_default(d4=True, crop_size=16), mmwhs_default(crop_size=16)):
        for name in ("synthetic_batch", "synthetic_raw_batch", "synthetic_eval_batch"):
            got, want = getattr(port, name)(cfg, 3, seed=4), getattr(ref, name)(cfg, 3, seed=4)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")


def test_entry_points_need_a_card_unless_told():
    """``device=None`` means the card: without one ``create_train_state``
    raises and names the remedy; ``device="cpu"`` is the explicit request."""
    import torch

    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.utils.device import resolve_device

    cfg = mscmrseg_default(filters=4, crop_size=32, fc_inch=1)
    assert resolve_device("cpu") == torch.device("cpu")
    state = create_train_state(cfg, device="cpu")
    assert next(state.models[0].parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert create_train_state(cfg).generator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(cfg)
