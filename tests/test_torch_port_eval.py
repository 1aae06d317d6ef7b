"""The port's evaluation (``pointcloududa_torch/eval``, ``ops/postprocess.py``,
``ops/clahe.py``) against the JAX package's and against OpenCV.

- ``resize_volume`` (numpy) against ``cv2.resize(..., INTER_AREA)`` on float32
  planes from 256^2, through each of OpenCV's three routes: enlarging
  (bilinear with INTER_AREA's coefficients), shrinking by an integer factor
  (a box mean) and by another factor (area weights), square or not. Measured
  against the installed OpenCV (5.0): equal value for value (max |diff| 0),
  so it is held equal, and the argmax over a 4-plane stack with it.
- CLAHE against ``cv2.createCLAHE(4.0, (8, 8)).apply``: bit-equal on random,
  flat and ramp planes at 256^2 and at 250 x 230 (padded by OpenCV first).
- ``evaluate_mscmrseg`` (CLAHE off and on, KLC on) and ``evaluate_mmwhs``
  against the JAX functions on the fabricated data of ``tests/test_eval.py``
  (plus one MS-CMRSeg patient whose ground truth is larger than 256^2 and not
  square, so the resize enlarges), with the same weights through
  ``utils/weights.py:generator_state_dict``: the label volumes handed to the
  metrics are equal, then the metric dicts and the per-patient CSV rows are
  exactly equal.
- ``Predictor`` against the JAX ``Predictor`` (rtol 2e-5, atol 1e-5, the
  tolerances of ``tests/test_predictor.py``), its tail padding, the points of
  the point head, and a ``torch.export`` round trip.

Tiny configs as ``tests/test_eval.py`` uses (``filters=4, n_block=2``);
the weights are random, BatchNorm statistics included, so the eval-mode
normalisation is exercised.
"""

import csv
import os
import shutil
import types

import numpy as np
import pytest
import torch

import cv2
import jax

import pointcloududa_torch.config as port_config
import pointcloududa_tpu.config as ref_config
from pointcloududa_torch.eval import predictor as port_predictor
from pointcloududa_torch.eval import volume as port_volume
from pointcloududa_torch.ops import clahe as port_clahe
from pointcloududa_torch.ops import metrics as port_metrics
from pointcloududa_torch.ops.postprocess import resize_volume
from pointcloududa_torch.train.state import build_models
from pointcloududa_torch.utils import weights
from pointcloududa_torch.utils.nifti import save_nii
from pointcloududa_tpu.eval import predictor as ref_predictor
from pointcloududa_tpu.eval import volume as ref_volume
from pointcloududa_tpu.ops import metrics as ref_metrics
from pointcloududa_tpu.train.state import build_models as ref_build_models
from test_eval import mmwhs_fake_data, mscmrseg_fake_data  # noqa: F401
from test_torch_port_step import one_torch_thread  # noqa: F401

MS_TINY = dict(filters=4, n_block=2, crop_size=16, fc_inch=0)
MM_TINY = dict(filters=4, n_block=2, crop_size=32, fc_inch=0)
PRED_TINY = dict(filters=4, n_block=2, crop_size=32, fc_inch=9)  # 9 at 32^2 with n_block 2


# ---- resize and CLAHE against OpenCV -----------------------------------------


@pytest.mark.parametrize("w,h", [(480, 480), (512, 400), (128, 128), (200, 232), (256, 256), (300, 200)],
                         ids=["enlarge", "enlarge-nonsquare", "shrink-by-2", "shrink-nonint", "same", "mixed"])
def test_resize_volume_equals_opencv_inter_area(w, h):
    planes = (np.random.default_rng(w * h).normal(size=(4, 256, 256)) * 3).astype(np.float32)
    want = np.array([cv2.resize(p, dsize=(w, h), interpolation=cv2.INTER_AREA) for p in planes])
    got = resize_volume(planes, w=w, h=h)
    assert got.shape == want.shape == (4, h, w) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.argmax(got, axis=0), np.argmax(want, axis=0))


def _planes(shape):
    rng = np.random.default_rng(shape[0])
    h, w = shape
    return {
        "random": rng.integers(0, 256, shape).astype(np.uint8),
        "flat": np.full(shape, 77, np.uint8),
        "ramp": (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8),
        "narrow": np.clip(rng.normal(90, 12, shape), 0, 255).astype(np.uint8),
    }


@pytest.mark.parametrize("shape", [(256, 256), (250, 230), (256, 250)], ids=["256", "250x230", "256x250"])
def test_clahe_is_bit_equal_to_opencv(shape):
    ref = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
    for kind, plane in _planes(shape).items():
        np.testing.assert_array_equal(port_clahe.clahe(plane), ref.apply(plane), err_msg=kind)
    vol = np.stack([np.stack(list(_planes(shape).values())[:3], axis=-1)] * 2)  # (2, H, W, 3)
    np.testing.assert_array_equal(port_volume.apply_clahe(vol), ref_volume.apply_clahe(vol))


# ---- the evaluations against the JAX package's --------------------------------


def _random_variables(model, x, seed=0):
    """flax variables of ``model`` with seeded random values (BatchNorm
    scales and variances in [0.5, 1.5), means and biases ~0.1, kernels
    1/sqrt(fan_in)); ``eval_shape`` compiles nothing."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2:
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _both_generators(preset, tiny, seed=0):
    """(JAX module, JAX net state, port cfg, port generator on the CPU) with
    the same random weights."""
    ref_cfg, cfg = getattr(ref_config, preset)(**tiny), getattr(port_config, preset)(**tiny)
    ref_gen = ref_build_models(ref_cfg)[0]
    x = np.zeros((1, cfg.crop_size, cfg.crop_size, cfg.in_channels), np.float32)
    variables = _random_variables(ref_gen, x, seed)
    gen = build_models(cfg)[0]
    gen.load_state_dict(weights.generator_state_dict(variables))
    net = types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    return ref_cfg, ref_gen, net, cfg, gen


class _Labels:
    """Records the label volumes a metrics function is handed."""

    def __init__(self, monkeypatch, module, name):
        self.seen, real = [], getattr(module, name)

        def recording(gt, pred, **kw):
            self.seen.append((np.array(gt), np.array(pred)))
            return real(gt, pred, **kw)

        monkeypatch.setattr(module, name, recording)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def mscmrseg_data(mscmrseg_fake_data, tmp_path_factory):  # noqa: F811
    """``tests/test_eval.py``'s patient 6 (ground truth 40 x 40 x 3: the
    resize shrinks 256 -> 40) and a patient 7 of 300 x 288 x 2 (it enlarges,
    and is not square)."""
    root = tmp_path_factory.mktemp("mscmrseg_eval") / "data"
    shutil.copytree(mscmrseg_fake_data, root)
    rng = np.random.default_rng(7)
    gt = np.zeros((300, 288, 2), np.int16)
    gt[100:180, 90:170] = 200
    gt[120:160, 110:150] = 500
    gt[190:230, 60:120] = 600
    save_nii(str(root / "raw_data/labels/lge_test_gt/patient7_LGE_manual.nii.gz"), gt)
    for i in range(2):
        img = np.clip(rng.normal(90, 30, (256, 256, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"processed/trainB/pat_7_lge_{i}.png"), img)
    return str(root)


@pytest.mark.parametrize("clahe", [False, True], ids=["plain", "clahe"])
def test_evaluate_mscmrseg_equals_the_jax_package(mscmrseg_data, tmp_path, monkeypatch, clahe):
    ref_cfg, ref_gen, net, cfg, gen = _both_generators("mscmrseg_default", MS_TINY)
    ref_labels = _Labels(monkeypatch, ref_metrics, "compute_metrics_on_files")
    port_labels = _Labels(monkeypatch, port_metrics, "compute_metrics_on_files")
    kw = dict(data_dir=mscmrseg_data, bs=2, clahe=clahe, pat_id_range=(6, 8), crop_size=16, klc=True, toprint=False)
    want = ref_volume.evaluate_mscmrseg(ref_cfg, ref_gen, net, per_patient_csv=str(tmp_path / "ref.csv"), **kw)
    got = port_volume.evaluate_mscmrseg(cfg, gen, per_patient_csv=str(tmp_path / "port.csv"), device="cpu", **kw)
    assert len(port_labels.seen) == len(ref_labels.seen) == 2
    for (gt_a, pred_a), (gt_b, pred_b) in zip(port_labels.seen, ref_labels.seen):
        np.testing.assert_array_equal(gt_a, gt_b)
        assert pred_a.dtype == pred_b.dtype and pred_a.shape == pred_b.shape
        np.testing.assert_array_equal(pred_a, pred_b)
    assert len({int(v) for _, p in port_labels.seen for v in np.unique(p)}) > 1  # not all background
    assert got == want
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "ref.csv")


def test_evaluate_mmwhs_equals_the_jax_package(mmwhs_fake_data, tmp_path, monkeypatch):  # noqa: F811
    ref_cfg, ref_gen, net, cfg, gen = _both_generators("mmwhs_default", MM_TINY, seed=1)
    ref_labels = _Labels(monkeypatch, ref_metrics, "metrics_mmwhs_volume")
    port_labels = _Labels(monkeypatch, port_metrics, "metrics_mmwhs_volume")
    kw = dict(data_dir=mmwhs_fake_data, bs=3, pat_ids=(1003,), toprint=False, model_name="tiny")
    want = ref_volume.evaluate_mmwhs(ref_cfg, ref_gen, net, per_patient_csv=str(tmp_path / "ref.csv"), **kw)
    got = port_volume.evaluate_mmwhs(cfg, gen, per_patient_csv=str(tmp_path / "port.csv"), device="cpu", **kw)
    assert len(port_labels.seen) == len(ref_labels.seen) == 1
    (gt_a, pred_a), (gt_b, pred_b) = port_labels.seen[0], ref_labels.seen[0]
    np.testing.assert_array_equal(gt_a, gt_b)
    assert pred_a.dtype == pred_b.dtype
    np.testing.assert_array_equal(pred_a, pred_b)
    assert got == want
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "ref.csv")
    x, onehot = port_volume.read_mmwhs_volume(mmwhs_fake_data, 1003)
    ref_x, ref_onehot = ref_volume.read_mmwhs_volume(mmwhs_fake_data, 1003)
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_array_equal(onehot, ref_onehot)


def test_volume_forward_pads_the_tail_and_restores_the_mode():
    _, _, _, _, gen = _both_generators("mmwhs_default", MM_TINY, seed=2)
    gen.train()
    x = np.random.default_rng(0).normal(size=(5, 32, 32, 3)).astype(np.float32)
    out = port_volume.make_volume_forward(gen, "cpu", bs=2)(x)
    assert out.shape == (5, 32, 32, 5) and gen.training
    with torch.no_grad():
        gen.eval()
        want = gen(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=1e-5)


def test_triptychs_are_three_grey_panels(tmp_path):
    from pointcloududa_torch.utils.png import IMREAD_GRAYSCALE, read_png

    images = np.random.default_rng(0).integers(0, 255, (2, 16, 16, 3)).astype(np.uint8)
    pred = np.full((2, 20, 18), 200, np.uint16)
    gt = np.full((2, 20, 18), 600, np.uint16)
    port_volume.save_triptychs(images, pred, gt, str(tmp_path / "plots"), "pat6")
    assert sorted(os.listdir(tmp_path / "plots")) == ["pat6_0.png", "pat6_1.png"]
    img = read_png(str(tmp_path / "plots" / "pat6_1.png"), IMREAD_GRAYSCALE)
    assert img.shape == (20, 16 + 4 + 18 + 4 + 18)
    assert img[:16, :16].min() == 0 and img[:16, :16].max() == 255  # the input, min to max
    assert (img[:, 20:38] == 85).all() and (img[:, 42:] == 255).all()  # 200 / 600 and 600 / 600 of 255


# ---- the predictor and its export ----------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    ref_cfg, _, net, cfg, gen = _both_generators("mscmrseg_default", dict(PRED_TINY, d4=True), seed=3)
    return ref_predictor.Predictor(ref_cfg, net, batch_size=4), port_predictor.Predictor(cfg, gen, batch_size=4, device="cpu"), cfg, gen


def test_predictor_equals_the_jax_predictor(predictors):
    ref, port, _, _ = predictors
    x = np.random.default_rng(0).uniform(size=(6, 32, 32, 3)).astype(np.float32)
    logits, points = port(x)
    want_logits, want_points = ref(x)
    assert logits.shape == (6, 32, 32, 4) and points.shape == (6, 300, 3)
    np.testing.assert_allclose(logits, want_logits, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(points, want_points, rtol=2e-5, atol=1e-5)


def test_predictor_tail_padding_and_fixed_weights(predictors):
    _, port, _, gen = predictors
    x = np.random.default_rng(1).uniform(size=(6, 32, 32, 3)).astype(np.float32)
    logits, points = port(x)
    logits3, points3 = port(x[:3])  # a batch of 3 padded to 4: the padding does not change the outputs
    np.testing.assert_allclose(logits3, logits[:3], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(points3, points[:3], rtol=2e-5, atol=1e-5)
    with torch.no_grad():
        gen.classifier.bias.add_(1.0)  # the weights were copied at construction
    try:
        np.testing.assert_array_equal(port(x)[0], logits)
    finally:
        with torch.no_grad():
            gen.classifier.bias.sub_(1.0)
    cfg = port_config.mscmrseg_default(**PRED_TINY)  # no point head: no points
    assert port_predictor.Predictor(cfg, build_models(cfg)[0], batch_size=2, device="cpu")(x[:1])[1] is None


def test_export_round_trip(predictors):
    _, port, cfg, gen = predictors
    blob = port_predictor.export_predictor(cfg, gen, batch_size=2, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 1000
    run = port_predictor.load_exported(blob, device="cpu")
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    logits, points = run(x)
    want_logits, want_points = port(x)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(points.numpy(), want_points, rtol=2e-5, atol=1e-5)
