"""The port never imports JAX nor the JAX package: in a fresh interpreter
whose import system refuses ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``,
``pointcloududa_tpu`` and the repository's ``tools``, every module of ``pointcloududa_torch`` imports and
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

    REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax", "pointcloududa_tpu", "tools"}

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

    cfg = mscmrseg_default(d1=True, d2=True, d4=True, filters=4, crop_size=96, fc_inch=1, bs=2)
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
    # the trainer around them: an epoch of prefetched synthetic batches, a
    # validation pass and a full snapshot
    import numpy as np, tempfile
    from pointcloududa_torch.data.sampler import RingSampler
    from pointcloududa_torch.train.loop import UDATrainer

    class Batches:
        steps_per_epoch = 2
        _src_sampler = RingSampler(5, 2, 4)
        _tgt_sampler = RingSampler(5, 2, 4)
        def epoch(self):
            return iter([synthetic_raw_batch(cfg, 2, seed=s) for s in (1, 2)])

    def evals():
        raw = synthetic_raw_batch(cfg, 2, seed=3)
        return iter([{"img": raw["img_s"], "mask": raw["mask_s"], "vert": raw["vert_s"]}])

    with tempfile.TemporaryDirectory() as tmp:
        trainer = UDATrainer(cfg, Batches(), {k: evals for k in ("val", "val_lge", "test_lge")},
                             workdir=tmp + "/w", logdir=tmp + "/r", device="cpu")
        scalars = {**trainer.train_epoch(), **trainer.validate()}
        trainer.save_full(tmp + "/snap", 1)
        assert trainer.restore_full(tmp + "/snap") == 2
        trainer.writer.close()
    assert all(np.isfinite(v) for v in scalars.values()), scalars
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
    assert n_modules >= 40, proc.stdout


REFUSED = {"jax", "jaxlib", "flax", "optax", "orbax", "pointcloududa_tpu", "tools"}


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
    assert "pointcloududa_torch.cli" in names  # the training run goes through the command-line entry point
    assert not [m for m in names if m.split(".")[0] in REFUSED]


def test_no_source_file_of_the_port_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "pointcloududa_torch", "**", "*.py"), recursive=True)
    assert len(files) >= 40
    for new in ("data/loader.py", "data/build.py", "train/checkpoint.py", "cli/train_mmwhs.py", "cli/train_mscmrseg.py",
                "cli/common.py", "__main__.py", "parallel/mesh.py", "utils/logging.py", "utils/timer.py", "utils/nifti.py",
                "ops/metrics.py", "ops/postprocess.py", "ops/clahe.py", "eval/volume.py", "eval/predictor.py",
                "cli/evaluate_mscmrseg.py", "cli/evaluate_mmwhs.py", "utils/host_native.py", "utils/tfrecord.py",
                "prep/prepare_mscmrseg.py", "prep/prepare_mmwhs.py", "prep/make_pointclouds.py", "prep/create_datalist.py",
                "prep/runbook.py", "prep/reproduce.py", "prep/reproduce_mmwhs.py", "smoke/smoke_train.py",
                "smoke/smoke_uda.py", "smoke/calibrate_d4.py", "smoke/quality_gates.py"):
        assert os.path.join(ROOT, "pointcloududa_torch", new) in files, new
    bad = {os.path.relpath(p, ROOT): [m for m in _imported_names(p) if m.split(".")[0] in REFUSED] for p in files}
    assert not {p: m for p, m in bad.items() if m}


def test_nothing_of_the_port_imports_opencv_pil_or_matplotlib():
    """The port depends on none of them: it decodes and writes PNGs
    with ``utils/png.py``, resizes and equalises in numpy."""
    files = glob.glob(os.path.join(ROOT, "pointcloududa_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = {os.path.relpath(p, ROOT): [m for m in _imported_names(p) if m.split(".")[0] in ("cv2", "PIL", "matplotlib")]
           for p in files}
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

    # the evaluation's entry points: the evaluate CLIs, the volume forward,
    # the predictor, its export and the loader of an artifact
    import numpy as np

    from pointcloududa_torch.cli import evaluate_mmwhs, evaluate_mscmrseg
    from pointcloududa_torch.eval import predictor, volume

    gen = state.models[0]
    x = np.zeros((1, 32, 32, 3), np.float32)
    assert predictor.Predictor(cfg, gen, batch_size=1, device="cpu")(x)[0].shape == (1, 32, 32, 4)
    assert volume.make_volume_forward(gen, "cpu", bs=1)(x).shape == (1, 32, 32, 4)
    blob = predictor.export_predictor(cfg, gen, batch_size=1, device="cpu")
    assert tuple(predictor.load_exported(blob, device="cpu")(x).shape) == (1, 32, 32, 4)
    if not torch.cuda.is_available():
        for call in (lambda: predictor.Predictor(cfg, gen), lambda: volume.make_volume_forward(gen),
                     lambda: predictor.export_predictor(cfg, gen), lambda: predictor.load_exported(blob),
                     lambda: evaluate_mscmrseg.main(["-model_dir", "no-such-file"]),
                     lambda: evaluate_mmwhs.main(["-weight_dir", "no-such-file"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()

    # the convergence smokes, the D4 calibration and the quality gates: each main asks for the card before it trains
    from pointcloududa_torch.smoke import calibrate_d4, quality_gates, smoke_train, smoke_uda

    if not torch.cuda.is_available():
        for main, argv in ((smoke_train.main, []), (smoke_uda.main, ["--d4"]), (calibrate_d4.main, []),
                           (quality_gates.main, [])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                main(argv)

    # the reproduction runbooks: their evaluate stage through main, their train stage (on a small dataset, which the
    # CLI reads before it asks for the device) through the stage runner that main drives
    import tempfile

    from pointcloududa_torch.prep import reproduce, reproduce_mmwhs
    from test_torch_port_data import make_mmwhs_dataset, make_mscmrseg_dataset

    if not torch.cuda.is_available():
        with tempfile.TemporaryDirectory() as tmp:
            open(os.path.join(tmp, "best_unet_model_checkpoint_x.Scr0.5"), "w").close()
            for runbook, train, make in ((reproduce, "train_mscmrseg", make_mscmrseg_dataset),
                                         (reproduce_mmwhs, "train_mmwhs", make_mmwhs_dataset)):
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    runbook.main(["--stage", "evaluate", "--data-root", tmp, "--workdir", tmp])
                root = make(os.path.join(tmp, train), n=3)
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    runbook.run_stage(runbook.CLI + train, ["-data_dir", root, "-workdir", tmp, "-logdir", tmp, "-workers", "0"],
                                      tmp)


# ---- the port's own copies of the JAX package's jax-free modules ------------


def _code(obj):
    """The AST of a definition's source without its docstrings: two copies
    with this dump equal run the same code."""
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize(
    "module,names",
    [
        ("data.sampler", ["RingSampler"]),
        ("data.manifest", ["load_ids", "write_ids"]),
        ("data.mmwhs", ["match_histograms_single", "MMWHSAdapter"]),
        ("data.mscmrseg", ["decode_mask_values"]),  # the adapter decodes PNGs without cv2: held by its records below
        ("parallel.mesh", ["pad_batch"]),
        ("train.checkpoint", ["EarlyStoppingCallback"]),
        ("utils.timer", ["timeit", "TimeChecker"]),
        ("data.loader", ["shard_index_batch", "PairedIterator", "BatchAssembler"]),
        ("utils.nifti", ["load_nii", "save_nii", "_open"]),
        ("ops.metrics", ["dice_binary", "_surface_distances", "hausdorff_distance", "average_surface_distance", "evaluate",
                         "metrics2", "compute_metrics_on_files", "metrics_mmwhs_volume"]),
        # resize_volume is numpy here (OpenCV's INTER_AREA there): held against OpenCV in test_torch_port_eval.py
        ("ops.postprocess", ["to_categorical", "soft_to_hard_pred", "keep_largest_connected_components", "crop_volume",
                             "reconstruct_volume"]),
        ("eval.volume", ["read_mmwhs_volume"]),
        # the twin's definitions that call no OpenCV; the rest call ops/host_image.py (held in test_torch_port_host_augment.py)
        ("ops.host_augment", ["_child_mats_np", "_kernel3", "someof_draw_np", "_directed_edge_kernel_np", "_perlin_mask_np"]),
        ("utils.tfrecord", ["_read_varint", "_walk_fields", "_parse_feature", "parse_example", "read_tfrecord", "read_examples",
                            "write_example", "write_tfrecord"]),
    ],
)
def test_copied_definitions_run_the_jax_packages_code(module, names):
    """What the port copied it copied whole: each definition's code is the
    original's, statement for statement (docstrings apart)."""
    import importlib

    port, ref = (importlib.import_module(f"{pkg}.{module}") for pkg in ("pointcloududa_torch", "pointcloududa_tpu"))
    for name in names:
        assert _code(getattr(port, name)) == _code(getattr(ref, name)), name


@pytest.mark.parametrize(
    "module,names",
    [
        ("runbook", ["find_best_checkpoint", "parse_train_args", "drive"]),
        ("prepare_mscmrseg", ["rescale_uint8", "crop", "load_volume_zyx"]),  # the OpenCV calls: tests/test_torch_port_prep.py
        ("prepare_mmwhs", ["decode_slice", "main"]),
        ("make_pointclouds", ["main"]),
        ("create_datalist", ["main"]),
    ],
)
def test_copied_definitions_run_the_tools_code(module, names):
    """The offline data layer's copies of the repository's ``tools/`` scripts
    (``prep/``): each definition that calls no OpenCV is the tool's code,
    statement for statement (docstrings apart)."""
    import importlib

    port, ref = (importlib.import_module(f"{pkg}.{module}") for pkg in ("pointcloududa_torch.prep", "tools"))
    for name in names:
        assert _code(getattr(port, name)) == _code(getattr(ref, name)), name


def test_manifest_and_adapters_give_the_originals_records(tmp_path):
    """``load_ids`` / ``write_ids`` and both dataset adapters on fabricated
    files: the same ids and, record by record, the same arrays and dtypes
    (histogram matching included)."""
    import numpy as np

    from pointcloududa_torch.data import manifest, mmwhs, mscmrseg
    from pointcloududa_tpu.data import manifest as ref_manifest
    from pointcloududa_tpu.data import mmwhs as ref_mmwhs
    from pointcloududa_tpu.data import mscmrseg as ref_mscmrseg
    from test_torch_port_data import make_mmwhs_dataset, make_mscmrseg_dataset

    manifest.write_ids(str(tmp_path / "lists" / "a.csv"), ["s1", "s2", "s3"])
    ref_manifest.write_ids(str(tmp_path / "lists" / "b.csv"), ["s1", "s2", "s3"])
    assert open(tmp_path / "lists" / "a.csv").read() == open(tmp_path / "lists" / "b.csv").read()
    assert manifest.load_ids(str(tmp_path / "lists" / "b.csv")) == ref_manifest.load_ids(str(tmp_path / "lists" / "a.csv")) == ["s1", "s2", "s3"]
    with pytest.raises(FileNotFoundError):
        manifest.load_ids(str(tmp_path / "none.csv"))

    def same(a, b):
        assert len(a) == len(b) == 3
        for i in range(3):
            for x, y in zip(a(i), b(i)):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)

    root = make_mmwhs_dataset(tmp_path / "mmwhs", n=3)
    for kw in (dict(source="target", phase="train", load_vertices=True), dict(source="source", phase="valid", match_hist=True),
               dict(source="source", phase="train")):
        split = ("mr" if kw["source"] == "source" else "ct") + ("_train" if kw["phase"] == "train" else "_val")
        ids = manifest.load_ids(os.path.join(root, f"{split}_list.csv"))
        same(mmwhs.MMWHSAdapter(data_dir=root, ids=ids, **kw), ref_mmwhs.MMWHSAdapter(data_dir=root, ids=ids, **kw))
    rng = np.random.default_rng(0)
    img, ref_img = np.round(rng.normal(size=(8, 8, 3)), 1), rng.normal(size=(8, 8, 3))
    np.testing.assert_array_equal(mmwhs.match_histograms_single(img, ref_img), ref_mmwhs.match_histograms_single(img, ref_img))

    root = make_mscmrseg_dataset(tmp_path / "mscmrseg", n=3)
    for kw, csv in ((dict(source="source", phase="train"), "aug_trainA.csv"), (dict(source="target", phase="valid"), "testB.csv"),
                    (dict(source="target", phase="train", load_vertices=False), "aug_trainB.csv")):
        ids = manifest.load_ids(os.path.join(root, csv))
        same(mscmrseg.MSCMRSegAdapter(data_dir=root, ids=ids, **kw), ref_mscmrseg.MSCMRSegAdapter(data_dir=root, ids=ids, **kw))
    with pytest.raises(FileNotFoundError):
        mscmrseg.MSCMRSegAdapter(data_dir=root, ids=["missing"])(0)


def test_metric_writer_writes_the_originals_jsonl(tmp_path):
    import json

    from pointcloududa_torch.utils.logging import MetricWriter
    from pointcloududa_tpu.utils.logging import MetricWriter as RefMetricWriter

    lines = []
    for cls, tag in ((MetricWriter, "a"), (RefMetricWriter, "b")):
        w = cls(str(tmp_path / tag), comment="run.lr0.001")
        w.scalars(1, {"seg_loss": 0.5, "seg_dice": 0.25}, prefix="train/")
        w.scalars(2, {"lr": 1e-3})
        w.close()
        path = os.path.join(w.logdir, "metrics.jsonl")
        assert w.logdir.endswith(os.path.join(tag, "run.lr0.001")) and os.path.isfile(path)
        lines.append([{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in open(path)])
    assert lines[0] == lines[1] == [{"step": 1, "train/seg_loss": 0.5, "train/seg_dice": 0.25}, {"step": 2, "lr": 1e-3}]


def test_timers_behave_as_the_originals(capsys):
    from pointcloududa_torch.utils import timer
    from pointcloududa_tpu.utils import timer as ref_timer

    for lib in (timer, ref_timer):
        assert lib.timeit(lambda x: x + 1)(2) == 3
        assert "time elapsed (s):" in capsys.readouterr().out
        with pytest.raises(ValueError):
            lib.TimeChecker()
        checker = lib.TimeChecker(max_seconds=1e-9)
        assert checker.check() is False and checker.check() is True  # the first call only starts the clock
        with lib.trace_annotation("uda_train_step"):
            pass
