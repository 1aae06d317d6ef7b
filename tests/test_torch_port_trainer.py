"""The port's ``UDATrainer`` (``pointcloududa_torch/train/loop.py``) against
the JAX package's over two epochs on one fabricated mini MM-WHS dataset, each
through its own `build_mmwhs_pipelines`, and the port's own resume, stop and
snapshot behaviour.

Parity run: ``softmax``, D2, ``d4aux`` (the Chamfer loss without D4, which
cannot be held over several steps in f32 in either framework), no
augmentation (``jax.random`` and ``torch.Generator`` never agree),
``vert_t_every=2``, ``decay_e=1``, 6 samples in batches of 4, so every epoch
is a full step with the target cloud's diagnostic and a wrap-padded tail step
with a ``sample_mask`` and without it. The JAX trainer starts from the port's
initial weights and runs its Pallas kernels in interpret mode. Tolerances are
the step tests' (tests/test_torch_port_step.py): rtol 2e-3 / atol 2e-4 on
continuous scalars (f32 sums in another order in two frameworks, compounded
over the optimiser steps); Dice scores 4e-3 (hard argmax over logits that the
initial weights leave within noise of each other); the discriminator's
accuracies two flipped decisions of the smallest step (2 real samples x 16
patch logits) in an epoch's mean. The port's kill-and-resume is held bit for
bit, with the light and with the heavy augmentation.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from pointcloududa_tpu.config import mmwhs_default as ref_mmwhs_default
from pointcloududa_tpu.data import build as ref_build
from pointcloududa_tpu.train import loop as ref_loop
from pointcloududa_torch.config import mmwhs_default
from pointcloududa_torch.data import build
from pointcloududa_torch.parallel import Mesh
from pointcloududa_torch.train import loop
from pointcloududa_torch.train.state import get_generator_lr
from test_torch_port_data import make_mmwhs_dataset
from test_torch_port_step import _jax_state, one_torch_thread  # noqa: F401

RTOL, ATOL, DICE_ATOL = 2e-3, 2e-4, 4e-3
ACC_ATOL = 2.0 / (2 * 16) / 2  # two decisions of the tail step's 2 x 16, in a mean over 2 steps
SMALL = dict(filters=8, crop_size=96, fc_inch=1, bs=4, ns=6, num_devices=1)


@pytest.fixture(scope="module")
def mmwhs_root(tmp_path_factory):
    return make_mmwhs_dataset(tmp_path_factory.mktemp("mmwhs_trainer"), size=96)


def _scalars(logdir):
    recs = {}
    for folder, _, files in os.walk(logdir):
        if "metrics.jsonl" in files:
            with open(os.path.join(folder, "metrics.jsonl")) as f:
                for line in f:
                    r = json.loads(line)
                    # timing/: host milliseconds of the trainer's spans, which no two runs share
                    recs.setdefault(r["step"], {}).update(
                        {k: v for k, v in r.items() if k not in ("step", "time") and not k.startswith("timing/")})
    return recs


def _port_trainer(root, tmp_path, tag, **kw):
    cfg = mmwhs_default(**{**SMALL, "data_dir": root, **kw})
    train_iter, val_iters, device_augment = build.build_mmwhs_pipelines(cfg, workers=2)
    return loop.UDATrainer(cfg, train_iter, val_iters, workdir=str(tmp_path / f"w_{tag}"), logdir=str(tmp_path / f"r_{tag}"),
                           device_augment=device_augment, device="cpu")


@pytest.fixture(scope="module")
def two_epochs(mmwhs_root, tmp_path_factory):
    """Both packages' trainers after ``fit()`` over two epochs, and their logged scalars."""
    from jax.experimental.pallas import tpu as pltpu

    tmp_path = tmp_path_factory.mktemp("parity")
    kw = dict(softmax=True, d2=True, d4aux=True, aug="", vert_t_every=2, decay_e=1, epochs=2,
              chamfer_impl="pallas", bn_stats_impl="pallas")
    port = _port_trainer(mmwhs_root, tmp_path, "port", **kw)
    ref_cfg = ref_mmwhs_default(**{**SMALL, "data_dir": mmwhs_root, **kw})
    jst = _jax_state(ref_cfg, port.state.models, ref_cfg.seed)  # the port's initial weights, before it trains
    train_iter, val_iters, device_augment = ref_build.build_mmwhs_pipelines(ref_cfg, workers=2)
    patch = pytest.MonkeyPatch()
    patch.setattr(ref_loop, "create_train_state", lambda cfg, key: jst)  # no flax init to compile
    try:
        ref = ref_loop.UDATrainer(ref_cfg, train_iter, val_iters, workdir=str(tmp_path / "w_ref"),
                                  logdir=str(tmp_path / "r_ref"), device_augment=device_augment)
    finally:
        patch.undo()
    with pltpu.force_tpu_interpret_mode():
        ref.fit()
    port.fit()
    return port, ref, _scalars(tmp_path / "r_port"), _scalars(tmp_path / "r_ref")


def _tolerance(key):
    if "dice" in key:
        return dict(rtol=0.0, atol=DICE_ATOL)
    if "/dis" in key:
        return dict(rtol=0.0, atol=ACC_ATOL)
    return dict(rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("epoch", [1, 2])
@pytest.mark.parametrize("prefix", ["train/", "valid/", "opt/"])
def test_two_epochs_match_the_jax_trainer(two_epochs, epoch, prefix):
    """Per-epoch train means (the same keys; ``ver_t_loss`` from the cadence
    step only), the three validations and the lr in force, epoch by epoch."""
    _, _, got, want = two_epochs
    assert sorted(got) == sorted(want) == [1, 2]
    keys = [k for k in want[epoch] if k.startswith(prefix)]
    assert sorted(k for k in got[epoch] if k.startswith(prefix)) == sorted(keys) and keys
    for key in keys:
        np.testing.assert_allclose(got[epoch][key], want[epoch][key], **_tolerance(key), err_msg=f"epoch {epoch} {key}")
    if prefix == "train/":
        assert {"train/ver_s_loss", "train/ver_t_loss", "train/d2_loss", "train/seg_dice"} <= set(keys)
        assert "train/d4_loss" not in keys
    if prefix == "valid/":
        assert len(keys) == 8 and got[epoch]["valid/valid_vert_loss"] > 0
    if prefix == "opt/":
        assert got[epoch]["opt/lr"] == pytest.approx(1e-3 * 0.2 ** (epoch - 1), rel=1e-6)


def test_lr_best_and_checkpoints_after_two_epochs_match_the_jax_trainer(two_epochs):
    port, ref, got, want = two_epochs
    assert port._lr == pytest.approx(ref._lr, rel=1e-12) and port._lr == pytest.approx(1e-3 * 0.04)
    assert get_generator_lr(port.state) == pytest.approx(port._lr)
    assert port.state.step == int(ref.state.step) == 4
    # the best epoch is a comparison of two validations: held where the JAX run's own are clearly apart
    dices = [want[e]["valid/val_lge_dice"] for e in (1, 2)]
    if abs(dices[0] - dices[1]) > 2 * DICE_ATOL or dices[0] == dices[1]:
        assert port.best["epoch"] == ref.best["epoch"]
    np.testing.assert_allclose(port.best["val_lge_dice"], ref.best["val_lge_dice"], rtol=0, atol=DICE_ATOL)
    ours, theirs = (sorted(os.listdir(os.path.dirname(t.ckpt_gen.model_name))) for t in (port, ref))
    strip = lambda names: sorted(n.split(".Scr")[0] for n in names)  # noqa: E731  (the score's last digit may differ)
    assert strip(ours) == strip(theirs) and any(".Scr" in n for n in ours)
    assert os.path.isfile(port.ckpt_gen.final_best_path) and os.path.isfile(port.ckpt_d2.model_name)
    assert port.ckpt_d4 is None and port.ckpt_d1 is None


def _stub(cfg):
    return types.SimpleNamespace(cfg=cfg, validate=lambda: dict(
        val_loss=1.234567, val_lge_loss=2.5, test_lge_loss=0.125, val_dice=0.5, val_lge_dice=0.25, test_lge_dice=0.75))


@pytest.mark.parametrize("flags", [dict(d2=True, d4=True), dict(d1=True), dict(d4aux=True, d1=True, d2=True)])
def test_printed_lines_equal_the_jax_trainer(flags, capsys):
    """The reference's epoch lines and the warm restart's validation lines, character for character."""
    tr = dict(seg_loss=0.51234, seg_dice=0.25, ver_s_loss=1.5, dis1_acc1=0.5, dis1_acc2=0.75, dis2_acc1=0.1, dis2_acc2=0.9,
              dis4_acc1=1.0, dis4_acc2=0.0)
    if not flags.get("d4aux"):
        tr["ver_t_loss"] = 0.33
    vr = _stub(None).validate()
    lines = []
    for lib, default in ((loop, mmwhs_default), (ref_loop, ref_mmwhs_default)):
        stub = _stub(default(epochs=7, **flags))
        lib.UDATrainer.print_epoch_result(stub, tr, vr, 3)
        lib.UDATrainer.initial_validation(stub)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and lines[0].startswith("[3/7] train_loss: 0.51234 ")


def test_d4_with_light_augmentation_stays_finite(mmwhs_root, tmp_path):
    """D4 and the light augmentation with regenerated clouds, through the
    port's trainer alone: two steps, three validations, every scalar finite."""
    t = _port_trainer(mmwhs_root, tmp_path, "d4", softmax=True, d2=True, d4=True, aug="light", vert_t_every=2, epochs=1)
    best = t.fit()
    assert best["epoch"] == 1
    values = {**best["train"], **best["valid"]}
    assert len(values) == 22 and all(np.isfinite(v) for v in values.values()), values
    assert best["valid"]["valid_vert_loss"] > 0 and "d4_loss" in best["train"]


def test_kill_and_resume_reproduces_the_run_bit_for_bit(mmwhs_root, tmp_path):
    """A run stopped after epoch 2's snapshot and resumed in a new trainer
    logs the uninterrupted run's epoch 3 and 4 exactly: with the light
    augmentation, D4's and the decoder's dropout on, so both generators'
    states, the samplers' cursors, the decayed lr (``decay_e=2`` fires at the
    snapshot epoch) and the optimisers' moments all have to come back."""
    kw = dict(softmax=True, d2=True, d4=True, aug="light", drop=True, vert_t_every=2, decay_e=2, epochs=4)
    full = _port_trainer(mmwhs_root, tmp_path, "full", **kw)
    full.fit()
    snap = str(tmp_path / "snap")
    a = _port_trainer(mmwhs_root, tmp_path, "a", **kw)
    a.fit(epochs=2, save_full_every=2, save_full_path=snap)  # "killed" after epoch 2
    b = _port_trainer(mmwhs_root, tmp_path, "b", **kw)
    start = b.restore_full(snap)
    assert start == 3 and b._lr == a._lr == pytest.approx(2e-4)
    b.fit(start_epoch=start)
    want, got = _scalars(tmp_path / "r_full"), _scalars(tmp_path / "r_b")
    assert sorted(got) == [3, 4] and sorted(want) == [1, 2, 3, 4]
    for epoch in (3, 4):
        assert got[epoch] == want[epoch], {k: (v, want[epoch][k]) for k, v in got[epoch].items() if v != want[epoch][k]}
    assert (b.best["epoch"], b.best["val_lge_dice"]) == (full.best["epoch"], full.best["val_lge_dice"])
    for x, y in zip(full.gen.state_dict().values(), b.gen.state_dict().values()):
        assert torch.equal(x, y)


def test_heavy_kill_and_resume_reproduces_the_run_bit_for_bit(mmwhs_root, tmp_path):
    """The same with the heavy pipeline, whose orders and SomeOf members come
    from the host generator: a run stopped after epoch 1's snapshot and
    resumed logs the uninterrupted run's epoch 2 exactly, and the host
    generator's state is in the snapshot."""
    kw = dict(softmax=True, d2=True, d4=True, aug="heavy", vert_t_every=2, epochs=2)
    full = _port_trainer(mmwhs_root, tmp_path, "hfull", **kw)
    full.fit()
    snap = str(tmp_path / "hsnap")
    a = _port_trainer(mmwhs_root, tmp_path, "ha", **kw)
    a.fit(epochs=1, save_full_every=1, save_full_path=snap)
    assert torch.equal(loop.ckpt_lib.restore_pytree(snap)["aug_host_rng"], a._aug_host_gen.get_state())
    b = _port_trainer(mmwhs_root, tmp_path, "hb", **kw)
    assert b.restore_full(snap) == 2
    b.fit(start_epoch=2)
    want, got = _scalars(tmp_path / "r_hfull"), _scalars(tmp_path / "r_hb")
    assert sorted(got) == [2] and got[2] == want[2], {k: (v, want[2][k]) for k, v in got[2].items() if v != want[2][k]}
    for x, y in zip(full.gen.state_dict().values(), b.gen.state_dict().values()):
        assert torch.equal(x, y)


def _scripted(trainer, dices):
    """Replace the trainer's epoch and validation by a script of ``val_lge_dice`` values."""
    it = iter(dices)
    trainer.train_epoch = lambda: {"seg_loss": 1.0, "seg_dice": 0.5}
    trainer.validate = lambda: dict(val_dice=0.1, val_loss=1.0, valid_vert_loss=-1.0, val_lge_dice=next(it), val_lge_loss=1.0,
                                    val_lge_vert_loss=-1.0, test_lge_dice=0.2, test_lge_loss=1.0)
    return trainer


def test_fit_stops_on_patience_with_the_final_epochs_checkpoints(mmwhs_root, tmp_path, capsys):
    """No improvement for ``patience`` epochs ends the run at epoch 3 of 10
    with the last epoch's duties: the best checkpoint renamed with its
    score, the last-model files of every network; no decay after the stop."""
    t = _scripted(_port_trainer(mmwhs_root, tmp_path, "es", d2=True, epochs=10, patience=2, decay_e=3), [0.5, 0.4, 0.3, 0.9])
    best = t.fit(save_full_every=1, save_full_path=str(tmp_path / "snap"))
    out = capsys.readouterr().out
    assert "early stopping: no val_lge_dice improvement for 2 epochs" in out and "[3/10]" in out and "[4/10]" not in out
    assert best["epoch"] == 1 and t.ckpt_gen.final_best_path.endswith(".Scr0.5") and os.path.isfile(t.ckpt_gen.final_best_path)
    assert os.path.isfile(t.ckpt_gen.model_name) and os.path.isfile(t.ckpt_d2.model_name)
    assert t._lr == 1e-3  # the stop comes before epoch 3's decay
    assert loop.ckpt_lib.restore_pytree(str(tmp_path / "snap"))["epoch"] == 2  # and before its snapshot


def test_fit_stops_on_the_wall_clock_budget(mmwhs_root, tmp_path, capsys):
    t = _scripted(_port_trainer(mmwhs_root, tmp_path, "budget", d2=True, epochs=5, max_hours=1e-9), [0.1] * 5)
    t.fit()
    out = capsys.readouterr().out
    assert "wall-clock budget reached; stopping" in out and "[1/5]" in out and "[2/5]" not in out
    assert os.path.isfile(t.ckpt_gen.final_best_path) and os.path.isfile(t.ckpt_gen.model_name)


def test_decay_follows_decay_e_and_offdecay(mmwhs_root, tmp_path):
    t = _scripted(_port_trainer(mmwhs_root, tmp_path, "decay", d2=True, epochs=4, decay_e=2), [0.1] * 4)
    t.fit()
    assert t._lr == pytest.approx(1e-3 * 0.04) and get_generator_lr(t.state) == pytest.approx(t._lr)
    assert [_scalars(tmp_path / "r_decay")[e]["opt/lr"] for e in (1, 2, 3, 4)] == pytest.approx([1e-3, 1e-3, 2e-4, 2e-4])
    t = _scripted(_port_trainer(mmwhs_root, tmp_path, "off", d2=True, epochs=2, decay_e=1, offdecay=False), [0.1] * 2)
    t.fit()
    assert t._lr == 1e-3


def test_metrics_are_fetched_once_per_epoch(mmwhs_root, tmp_path, monkeypatch):
    """Inside an epoch no metric is read on the host: the step's metric
    tensors are stacked and moved in one transfer at the epoch's end."""
    t = _port_trainer(mmwhs_root, tmp_path, "fetch", softmax=True, d2=True, d4aux=True, vert_t_every=2)
    calls = []
    real = loop._fetch_means
    monkeypatch.setattr(loop, "_fetch_means", lambda history: calls.append(len(history)) or real(history))
    seen = []
    step = t.train_step
    t.train_step = lambda state, batch: seen.append(step(state, batch)[1]) or (state, seen[-1])
    tr = t.train_epoch()
    assert calls == [2] and len(seen) == 2
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for m in seen for v in m.values())
    assert "ver_t_loss" in seen[0] and "ver_t_loss" not in seen[1]  # the cadence gate
    assert tr["ver_t_loss"] == pytest.approx(float(seen[0]["ver_t_loss"]))  # averaged over the steps that have it
    assert tr["seg_loss"] == pytest.approx((float(seen[0]["seg_loss"]) + float(seen[1]["seg_loss"])) / 2, rel=1e-6)
    assert loop._fetch_means([]) == {}


def test_a_mesh_is_refused_and_debug_nans_switches_anomaly_detection_on(mmwhs_root, tmp_path):
    cfg = mmwhs_default(**{**SMALL, "data_dir": mmwhs_root, "d2": True})
    train_iter, val_iters, _ = build.build_mmwhs_pipelines(cfg, workers=0)
    # a multi-process mesh whose loaders decode whole global batches (no row_shard) would train on W of them
    two_ranks = Mesh(2, 0, torch.device("cpu"), group=object())
    with pytest.raises(ValueError, match="trainer_row_shard"):
        loop.UDATrainer(cfg, train_iter, val_iters, mesh=two_ranks, device="cpu")
    if not torch.cuda.is_available():  # device=None is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loop.UDATrainer(cfg, train_iter, val_iters, workdir=str(tmp_path / "w"), logdir=str(tmp_path / "r"))
    assert not torch.is_anomaly_enabled()
    try:
        _port_trainer(mmwhs_root, tmp_path, "nan", d2=True, debug_nans=True)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
