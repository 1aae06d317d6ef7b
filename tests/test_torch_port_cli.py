"""The port's training CLIs (``pointcloududa_torch/cli``) against the JAX
package's: every flag parses to the same ``UDAConfig`` (but for the packed
layouts, which the port does not have; ``-dtype`` defaults to bfloat16 in
both), ``-host_aug`` trains on the host augmentation route, the
data-parallel flags reach training, and ``main(argv, device="cpu")`` trains, resumes and
warm-restarts on fabricated mini datasets, in float32 and in bfloat16, and
trains on two gloo ranks as on one process.

The CLI runs use the presets' late binding (``config.mmwhs_default`` is looked
up when ``config_from_args`` runs) to train at 96^2 with ``fc_inch=1``; the
widths come from ``-nf 8``.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointcloududa_tpu.cli import train_mmwhs as ref_mmwhs
from pointcloududa_tpu.cli import train_mscmrseg as ref_mscmrseg
from pointcloududa_torch import config as port_config
from pointcloududa_torch.cli import common, train_mmwhs, train_mscmrseg
from pointcloududa_torch.train import checkpoint as ckpt
from test_torch_port_data import make_mmwhs_dataset, make_mscmrseg_dataset
from test_torch_port_step import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_IN_THE_PORT = {"packed_level0", "packed_level1", "packed_compute"}

MSCMRSEG_ARGV = [
    [],
    ["-d1", "-d2", "-d4", "-lr", "1e-3", "-d2lr", "2.5e-05", "-aug2", "-wp", "2.0"],
    ["-aug"],
    ["-no_vert_t_metric"],
    ["-aug", "-offdecay", "-decay_e", "30", "-bs", "8", "-ns", "40", "-e", "3", "-lr_fix", "2e-4", "-apdx", "run7", "-d1lr", "1e-4",
     "-d4lr", "3e-5", "-dr", "0.1", "-data_dir", "/data", "-vert_t_every", "10", "-max_hours", "2.5", "-patience", "4",
     "-load_weight", "-no_packed", "-ndev", "1", "-workers", "2", "-save_every", "2", "-resume", "snap", "-dtype", "float32"],
]
MMWHS_ARGV = [
    [],
    ["-softmax", "-d2", "-d4", "-ft", "-extd4", "-dr", "0.1", "-w2", "0.5", "-sgd"],
    ["-no_vert_t_metric"],
    ["-aug", "light", "-mh", "-he", "-cvinit", "-nf", "16", "-d4aux", "-drop", "-etpls", "-Tetpls", "-mmt", "0.9", "-d1", "-d1lr", "1e-4",
     "-d2lr", "2e-5", "-d4lr", "3e-5", "-dmmt", "0.9", "-d1mmt", "0.8", "-d2mmt", "0.7", "-d4mmt", "0.6", "-extpn", "-extd1", "-extd2",
     "-wp", "0.5", "-w1", "2.0", "-w4", "0.25", "-offdecay", "-bs", "8", "-ns", "40", "-e", "3", "-lr", "2e-3", "-lr_fix", "2e-4",
     "-apdx", "run7", "-data_dir", "/data", "-vert_t_every", "10", "-max_hours", "2.5", "-patience", "4", "-load_weight",
     "-no_packed", "-skip_final_eval", "-save_every", "2", "-resume", "snap", "-workdir", "w", "-logdir", "r", "-workers", "1"],
    ["-aug", "heavy", "-dtype", "float32"],
]


def _same_config(port_cfg, ref_cfg):
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
    assert set(a) == set(b)
    assert {k: v for k, v in a.items() if k not in NOT_IN_THE_PORT} == {k: v for k, v in b.items() if k not in NOT_IN_THE_PORT}
    assert not (port_cfg.packed_level0 or port_cfg.packed_level1 or port_cfg.packed_compute)
    assert port_config.appendix(port_cfg) == ref_mmwhs.appendix(ref_cfg)


@pytest.mark.parametrize("argv", MSCMRSEG_ARGV, ids=lambda a: " ".join(a[:3]) or "defaults")
def test_mscmrseg_flags_give_the_jax_packages_config(argv):
    port_args, ref_args = train_mscmrseg.build_parser().parse_args(argv), ref_mscmrseg.build_parser().parse_args(argv)
    assert set(vars(port_args)) == set(vars(ref_args))  # every flag of the original parses
    _same_config(train_mscmrseg.config_from_args(port_args), ref_mscmrseg.config_from_args(ref_args))


@pytest.mark.parametrize("argv", MMWHS_ARGV, ids=lambda a: " ".join(a[:3]) or "defaults")
def test_mmwhs_flags_give_the_jax_packages_config(argv):
    port_args, ref_args = train_mmwhs.build_parser().parse_args(argv), ref_mmwhs.build_parser().parse_args(argv)
    assert set(vars(port_args)) == set(vars(ref_args))
    _same_config(train_mmwhs.config_from_args(port_args), ref_mmwhs.config_from_args(ref_args))


def test_flag_defaults_differ_only_in_the_compute_type():
    """They no longer differ at all: ``-dtype`` defaults to bfloat16 in both
    packages."""
    for port, ref in ((train_mmwhs, ref_mmwhs), (train_mscmrseg, ref_mscmrseg)):
        a, b = vars(port.build_parser().parse_args([])), vars(ref.build_parser().parse_args([]))
        assert {k for k in a if a[k] != b[k]} == set() and a["dtype"] == "bfloat16"
    cfg = common.with_kernels(train_mmwhs.config_from_args(train_mmwhs.build_parser().parse_args([])))
    assert (cfg.chamfer_impl, cfg.bn_stats_impl) == ("pallas", "pallas")  # a command-line run goes through the kernels


class _Trained(Exception):
    pass


@pytest.fixture
def no_training(monkeypatch):
    """Building a pipeline or fitting raises ``_Trained``: a test sees how far
    a run got without training."""
    from pointcloududa_torch.data import build
    from pointcloududa_torch.train import loop

    def boom(*a, **k):
        raise _Trained("the run got as far as building its pipelines")

    monkeypatch.setattr(build, "build_mmwhs_pipelines", boom)
    monkeypatch.setattr(build, "build_mscmrseg_pipelines", boom)
    monkeypatch.setattr(loop.UDATrainer, "fit", boom)


@pytest.mark.parametrize("argv", [["-host_aug"]], ids=["mscmrseg-host-aug"])
def test_host_aug_trains_an_epoch_on_the_host_route(argv, tmp_path, capsys, monkeypatch):
    """``-host_aug`` builds the host route (``device_augment=False`` for the
    pipelines and the trainer, as in the JAX package) and the reference's
    command trains an epoch of two steps on it on the CPU (96^2, 8 filters):
    every printed score finite, the checkpoints under the reference's names."""
    from pointcloududa_torch.data import build
    from pointcloududa_torch.train import loop

    root = make_mscmrseg_dataset(tmp_path / "d", size=96, n=4)
    preset = port_config.mscmrseg_default
    monkeypatch.setattr(port_config, "mscmrseg_default", lambda **kw: preset(**{**kw, "crop_size": 96, "fc_inch": 1, "filters": 8}))
    seen = {}
    real_build, real_init = build.build_mscmrseg_pipelines, loop.UDATrainer.__init__

    def spy_build(cfg, **kw):
        seen["pipelines"] = kw["device_augment"]
        return real_build(cfg, **kw)

    def spy_init(self, *a, **kw):
        seen["trainer"] = kw["device_augment"]
        real_init(self, *a, **kw)

    monkeypatch.setattr(build, "build_mscmrseg_pipelines", spy_build)
    monkeypatch.setattr(loop.UDATrainer, "__init__", spy_init)
    train_mscmrseg.main(argv + ["-d1", "-d2", "-d4", "-bs", "2", "-ns", "4", "-e", "1", "-data_dir", root, "-workdir",
                                str(tmp_path / "w"), "-logdir", str(tmp_path / "r"), "-workers", "2", "-dtype", "float32"],
                        device="cpu")
    assert seen == {"pipelines": False, "trainer": False}
    out = capsys.readouterr().out
    apdx = out.splitlines()[0]
    assert "[1/1]" in out and "nan" not in out
    files = sorted(os.listdir(tmp_path / "w"))
    assert {f"unet_model_checkpoint_{apdx}", f"out_dis_{apdx}", f"entropy_dis_{apdx}", f"point_dis_{apdx}"} <= set(files)


@pytest.mark.parametrize(
    "module,argv",
    [
        (train_mmwhs, ["-skip_final_eval", "-ndev", "4"]),
        (train_mmwhs, ["-skip_final_eval", "-dist"]),
        (train_mscmrseg, ["-aug", "-ndev", "2"]),
        (train_mscmrseg, ["-aug", "-dist"]),
    ],
    ids=["mmwhs-ndev", "mmwhs-dist", "mscmrseg-ndev", "mscmrseg-dist"],
)
def test_data_parallel_flags_reach_training(no_training, monkeypatch, module, argv):
    """``-ndev N`` gets as far as starting its N ranks (``launch.spawn``, which
    ``no_training`` stops); ``-dist``, given a launcher's environment for a
    world of one, joins the group over gloo and gets as far as building its
    pipelines, and leaves the group when that fails."""
    from pointcloududa_torch.parallel import launch

    started = []

    def spawn(fn, devices, args=(), backend=None):
        started.append(len(devices))
        raise _Trained("the run got as far as starting its ranks")

    monkeypatch.setattr(launch, "spawn", spawn)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(launch.free_port()))
    for name, value in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    with pytest.raises(_Trained):
        module.main(argv, device="cpu")
    assert started == ([] if "-dist" in argv else [int(argv[-1])])
    assert not torch.distributed.is_initialized()


def test_the_gate_lets_a_ported_run_through(no_training):
    with pytest.raises(_Trained):
        train_mmwhs.main(["-skip_final_eval", "-ndev", "1"], device="cpu")


@pytest.mark.parametrize("argv", [["-dtype", "bfloat16", "-skip_final_eval"]])
def test_bfloat16_training_writes_float32_checkpoints_and_resumes_bit_equal(argv, tmp_path, monkeypatch):
    """``-dtype bfloat16`` (the default, given here explicitly) trains on the
    CPU (96^2, 8 filters, light augmentation, D2 + D4): its checkpoints hold
    float32 weights and optimiser state; 2 epochs with a snapshot, then the
    same command with ``-e 3`` resumed, give an epoch 3 whose every
    checkpointed tensor equals that of an uninterrupted 3-epoch run bit for
    bit."""
    root = make_mmwhs_dataset(tmp_path / "d", size=96)
    preset = port_config.mmwhs_default
    monkeypatch.setattr(port_config, "mmwhs_default", lambda **kw: preset(**{**kw, "crop_size": 96, "fc_inch": 1}))
    common_argv = argv + ["-bs", "4", "-ns", "4", "-nf", "8", "-aug", "light", "-softmax", "-d2", "-d4", "-data_dir", root,
                          "-workers", "1"]

    def run(tag, epochs):
        out = str(tmp_path / tag)
        train_mmwhs.main(common_argv + ["-e", str(epochs), "-workdir", f"{out}/w", "-logdir", f"{out}/r", "-resume",
                                        f"{out}/snap"], device="cpu")
        return f"{out}/w"

    run("a", 2)
    resumed, straight = run("a", 3), run("b", 3)
    names = sorted(f for f in os.listdir(straight) if not f.startswith("best_"))
    assert names == sorted(f for f in os.listdir(resumed) if not f.startswith("best_")) and len(names) == 3
    for name in names:
        a, b = ckpt.restore_pytree(os.path.join(resumed, name)), ckpt.restore_pytree(os.path.join(straight, name))
        assert a["epoch"] == b["epoch"] == 3
        tensors_a, tensors_b = list(_tensors(a["state"]["net"])), list(_tensors(b["state"]["net"]))
        assert len(tensors_a) == len(tensors_b) > 0
        assert all(t.dtype in (torch.float32, torch.int64) for t in tensors_a)
        assert all(torch.equal(x, y) for x, y in zip(tensors_a, tensors_b)), name


def _tensors(tree):
    """The tensors of a nested checkpoint payload, in a fixed order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@pytest.mark.parametrize("argv", [[], ["-aug2"]], ids=["heavy", "medium"])
def test_mscmrseg_without_aug_asks_for_a_pipeline_that_is_not_ported(argv, tmp_path, capsys, monkeypatch):
    """Without ``-aug`` the reference's command asks for the heavy pipeline
    (``-aug2``: the medium one), which is ported now: ``main`` with the
    reference's ``-d1 -d2 -d4`` trains an epoch of two steps on the CPU (at
    96^2 and 8 filters through the preset's late binding), every printed
    score finite, the checkpoints under the reference's names (the appendix
    marks ``-aug2`` and, as the reference's does, not the heavy default)."""
    root = make_mscmrseg_dataset(tmp_path / "d", size=96, n=4)
    preset = port_config.mscmrseg_default
    monkeypatch.setattr(port_config, "mscmrseg_default", lambda **kw: preset(**{**kw, "crop_size": 96, "fc_inch": 1, "filters": 8}))
    train_mscmrseg.main(argv + ["-d1", "-d2", "-d4", "-bs", "2", "-ns", "4", "-e", "1", "-data_dir", root, "-workdir",
                                str(tmp_path / "w"), "-logdir", str(tmp_path / "r"), "-workers", "2", "-dtype", "float32"],
                        device="cpu")
    out = capsys.readouterr().out
    apdx = out.splitlines()[0]
    assert apdx.endswith(".aug2" if argv else ".d4lr2.5e-05") and "[1/1]" in out and "nan" not in out
    files = sorted(os.listdir(tmp_path / "w"))
    assert {f"unet_model_checkpoint_{apdx}", f"out_dis_{apdx}", f"entropy_dis_{apdx}", f"point_dis_{apdx}"} <= set(files)


def test_mmwhs_cli_trains_resumes_and_warm_restarts(tmp_path, capsys, monkeypatch):
    """``main`` three times on the CPU: two epochs with a snapshot per epoch
    (light augmentation, D2 + D4, the diagnostic every 2nd step); the same
    command with ``-e 3`` continues at epoch 3 and does not run epoch 1
    again; ``-load_weight`` restores every network with its optimiser and
    validates before it trains."""
    root = make_mmwhs_dataset(tmp_path / "d", size=96)
    preset = port_config.mmwhs_default
    monkeypatch.setattr(port_config, "mmwhs_default", lambda **kw: preset(**{**kw, "crop_size": 96, "fc_inch": 1}))
    snap = str(tmp_path / "snap")
    common_argv = ["-bs", "4", "-ns", "6", "-nf", "8", "-aug", "light", "-softmax", "-d2", "-d4", "-vert_t_every", "2",
                   "-skip_final_eval", "-data_dir", root, "-workdir", str(tmp_path / "w"), "-logdir", str(tmp_path / "r"),
                   "-workers", "2", "-dtype", "float32"]
    train_mmwhs.main(common_argv + ["-e", "2", "-resume", snap], device="cpu")
    out = capsys.readouterr().out
    apdx = out.splitlines()[0]
    assert apdx.endswith(".litaug.softmax") and "[1/2]" in out and "[2/2]" in out and "vertex_t_loss" in out
    assert os.path.isfile(snap) and ckpt.restore_pytree(snap)["epoch"] == 2
    files = sorted(os.listdir(tmp_path / "w"))
    assert {f"unet_model_checkpoint_{apdx}", f"entropy_dis_{apdx}", f"point_dis_{apdx}"} <= set(files)
    assert any(f.startswith(f"best_unet_model_checkpoint_{apdx}.Scr") for f in files)

    train_mmwhs.main(common_argv + ["-e", "3", "-resume", snap], device="cpu")
    out = capsys.readouterr().out
    assert "continuing at epoch 3" in out and "[3/3]" in out and "[1/3]" not in out and "[2/3]" not in out

    train_mmwhs.main(common_argv + ["-e", "1", "-load_weight"], device="cpu")
    out = capsys.readouterr().out
    assert "warm restart: model+optimizer states restored" in out
    pre = out.split("[1/1]")[0]
    assert "valid_lge_dice:" in pre and "test_lge_dice:" in pre  # the validation before training, in the reference's format


def test_mmwhs_cli_evaluates_its_best_checkpoint_after_training(tmp_path, capsys, monkeypatch):
    """The reference's MM-WHS command without ``-skip_final_eval``: ``main``
    trains an epoch on the CPU (96^2, 8 filters, D2 + D4), then evaluates the
    renamed best checkpoint on the four CT test volumes (96^2 x 3 slices of
    noise around two labelled boxes, written by the port's ``save_nii``) in a
    fresh generator, and prints ``Ave Dice``; its metrics equal those of
    ``evaluate_mmwhs`` called on that file, and the generator it evaluated
    holds that file's weights, not the trainer's last ones."""
    import numpy as np

    from pointcloududa_torch.cli.common import restored_generator
    from pointcloududa_torch.eval import volume
    from pointcloududa_torch.utils.nifti import save_nii

    root = make_mmwhs_dataset(tmp_path / "d", size=96, n=4)
    base = os.path.join(root, "PnpAda_release_data", "test_ct_image_n_labels")
    os.makedirs(base)
    rng = np.random.default_rng(0)
    for pat_id in (1003, 1008, 1014, 1019):
        gt = np.zeros((96, 96, 3), np.int16)
        gt[20:60, 20:60], gt[50:80, 40:70] = 1, 3
        save_nii(os.path.join(base, f"image_ct_{pat_id}.nii.gz"), (rng.normal(size=gt.shape) + gt).astype(np.float32))
        save_nii(os.path.join(base, f"gth_ct_{pat_id}.nii.gz"), gt)
    preset = port_config.mmwhs_default
    monkeypatch.setattr(port_config, "mmwhs_default", lambda **kw: preset(**{**kw, "crop_size": 96, "fc_inch": 1}))
    runs, real = [], volume.evaluate_mmwhs

    def recording(cfg, gen, **kw):
        runs.append((cfg, gen, kw, real(cfg, gen, **kw)))
        return runs[-1][-1]

    monkeypatch.setattr(volume, "evaluate_mmwhs", recording)
    train_mmwhs.main(["-bs", "2", "-ns", "4", "-e", "2", "-nf", "8", "-softmax", "-d2", "-d4", "-data_dir", root, "-workdir",
                      str(tmp_path / "w"), "-logdir", str(tmp_path / "r"), "-workers", "1", "-dtype", "float32"], device="cpu")
    out = capsys.readouterr().out
    assert "[2/2]" in out and "Evaluate the best model:" in out and "Ave Dice:" in out
    best = out.split("Evaluate the best model: ")[1].splitlines()[0]
    assert os.path.basename(best).startswith("best_unet_model_checkpoint_") and ".Scr" in best and os.path.isfile(best)
    assert len(runs) == 1
    cfg, gen, kw, got = runs[0]
    assert kw == dict(data_dir=root, device=torch.device("cpu"))
    payload = ckpt.restore_pytree(best)
    for name, value in payload["state"]["net"]["model"].items():
        assert torch.equal(gen.state_dict()[name], value), name
    last = ckpt.restore_pytree(str(tmp_path / "w" / f"unet_model_checkpoint_{out.splitlines()[0]}"))["state"]["net"]["model"]
    if payload["epoch"] != 2:  # the best epoch was not the last: the trainer's weights are not the ones evaluated
        assert any(not torch.equal(last[k], v) for k, v in gen.state_dict().items())
    again = real(cfg, restored_generator(cfg, best, "cpu"), data_dir=root, device="cpu", toprint=False)
    assert got == again and set(got) == {"myo", "la", "lv", "aa"}
    assert all(np.isfinite(v) for m in got.values() for v in m.values())


def test_mscmrseg_cli_trains_resumes_and_warm_restarts(tmp_path, capsys):
    """The argv of tests/test_cli_pipeline.py (``-aug`` is store_false: no
    augmentation), through the PNG adapter."""
    root = make_mscmrseg_dataset(tmp_path / "d")
    snap = str(tmp_path / "snap")
    common_argv = ["-bs", "2", "-ns", "4", "-d2", "-aug", "-data_dir", root, "-workdir", str(tmp_path / "w"),
                   "-logdir", str(tmp_path / "r"), "-dtype", "float32"]
    train_mscmrseg.main(common_argv + ["-e", "1", "-resume", snap], device="cpu")
    assert os.path.isfile(snap)
    capsys.readouterr()
    train_mscmrseg.main(common_argv + ["-e", "2", "-resume", snap], device="cpu")
    out = capsys.readouterr().out
    assert "continuing at epoch 2" in out and "[2/2]" in out and "[1/2]" not in out
    train_mscmrseg.main(common_argv + ["-e", "1", "-load_weight"], device="cpu")
    out = capsys.readouterr().out
    assert "weights restored from" in out and "Training on 6 trainA, 6 trainB slices" in out
    pre = out.split("Training on")[0]
    assert "valid_lge_dice:" in pre and "test_lge_dice:" in pre


def _records(logdir) -> list:
    (path,) = glob.glob(os.path.join(str(logdir), "*", "metrics.jsonl"))
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def test_mscmrseg_cli_trains_on_two_ranks_as_one_process_does(tmp_path, monkeypatch):
    """``-ndev 2`` on the CPU (``device="cpu"``): two gloo ranks, each decoding
    its two rows of the global batch of 4, at filters 4, ``n_block`` 2, 32^2,
    D1 + D2 for 2 epochs of 2 steps, against the same command on one
    process: the same records logged (rtol 1e-4; the accuracies within two
    of their patch decisions), the same checkpoint files, rank 1's under
    ``.rank1``, holding the same weights (rtol 1e-4, atol 1e-5: Adam over
    four steps of sums in another order)."""
    preset = port_config.mscmrseg_default
    monkeypatch.setattr(port_config, "mscmrseg_default",
                        lambda **kw: preset(**{**kw, "filters": 4, "n_block": 2, "crop_size": 32}))
    # the logs are compared by their JSONL records: this process skips TensorBoard, whose import takes seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = make_mscmrseg_dataset(tmp_path / "d", size=32, n=4)
    argv = ["-bs", "4", "-ns", "8", "-e", "2", "-d1", "-d2", "-aug", "-dtype", "float32", "-data_dir", root, "-workers", "0"]
    for name, extra in (("one", []), ("two", ["-ndev", "2"])):
        train_mscmrseg.main(argv + ["-workdir", str(tmp_path / name / "w"), "-logdir", str(tmp_path / name / "r")] + extra,
                            device="cpu")
    want = _records(tmp_path / "one" / "r")
    assert len(want) == 3 * 2
    for logdir in (tmp_path / "two" / "r", tmp_path / "two" / "r" / ".rank1"):
        got = _records(logdir)
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        for g, w in zip(got, want):
            for key, value in w.items():
                atol = 2.0 / (4 * 2 * 2) if "_acc" in key else 0.0  # 4 patch logits a sample (32 -> 2 x 2)
                np.testing.assert_allclose(g[key], value, rtol=1e-4, atol=atol, err_msg=f"{logdir}: {key}")
    files = sorted(f for f in os.listdir(tmp_path / "one" / "w"))
    assert files and sorted(f for f in os.listdir(tmp_path / "two" / "w") if f != ".rank1") == files
    assert sorted(os.listdir(tmp_path / "two" / "w" / ".rank1")) == files
    for wdir in (tmp_path / "two" / "w", tmp_path / "two" / "w" / ".rank1"):
        for name in files:
            got, ref = (torch.load(os.path.join(d, name), weights_only=True) for d in (wdir, tmp_path / "one" / "w"))
            for key, value in ref["state"]["net"]["model"].items():
                torch.testing.assert_close(got["state"]["net"]["model"][key], value, rtol=1e-4, atol=1e-5, msg=f"{name}: {key}")


def test_main_needs_a_card_unless_told(tmp_path):
    """``main(argv)`` is ``device=None``: the card, and an error without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root = make_mmwhs_dataset(tmp_path / "d", size=32, n=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mmwhs.main(["-skip_final_eval", "-data_dir", root, "-workdir", str(tmp_path / "w"), "-logdir", str(tmp_path / "r")])


def test_dispatcher_lists_the_two_train_commands():
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "--help"], cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and "train-mscmrseg, train-mmwhs, evaluate-mscmrseg, evaluate-mmwhs" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "serve"], cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 2 and "commands:" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "evaluate-mmwhs", "-h"], cwd=ROOT, capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0 and "-weight_dir" in proc.stdout, proc.stderr
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "train-mscmrseg", "-host_aug", "-h"], cwd=ROOT,
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and "-host_aug" in proc.stdout and "not ported" not in proc.stdout, proc.stderr
