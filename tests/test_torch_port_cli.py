"""The port's training CLIs (``pointcloududa_torch/cli``) against the JAX
package's: every flag parses to the same ``UDAConfig`` (but for the compute
type and the packed layouts, which the port does not have), what is not
ported is refused before any training, and ``main(argv, device="cpu")`` trains,
resumes and warm-restarts on fabricated mini datasets.

The CLI runs use the presets' late binding (``config.mmwhs_default`` is looked
up when ``config_from_args`` runs) to train at 96^2 with ``fc_inch=1``; the
widths come from ``-nf 8``.
"""

import dataclasses
import os
import subprocess
import sys

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
NOT_IN_THE_PORT = {"compute_dtype", "packed_level0", "packed_level1", "packed_compute"}

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
    assert port_cfg.compute_dtype == "float32" and not (port_cfg.packed_level0 or port_cfg.packed_level1 or port_cfg.packed_compute)
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
    for port, ref in ((train_mmwhs, ref_mmwhs), (train_mscmrseg, ref_mscmrseg)):
        a, b = vars(port.build_parser().parse_args([])), vars(ref.build_parser().parse_args([]))
        assert {k for k in a if a[k] != b[k]} == {"dtype"} and a["dtype"] == "float32"
    cfg = common.with_kernels(train_mmwhs.config_from_args(train_mmwhs.build_parser().parse_args([])))
    assert (cfg.chamfer_impl, cfg.bn_stats_impl) == ("pallas", "pallas")  # a command-line run goes through the kernels


class _Trained(Exception):
    pass


@pytest.fixture
def no_training(monkeypatch):
    """Any attempt to build a pipeline or a trainer fails the test: what is
    not ported must be refused before that."""
    from pointcloududa_torch.data import build
    from pointcloududa_torch.train import loop

    def boom(*a, **k):
        raise _Trained("the run got as far as building its pipelines")

    monkeypatch.setattr(build, "build_mmwhs_pipelines", boom)
    monkeypatch.setattr(build, "build_mscmrseg_pipelines", boom)
    monkeypatch.setattr(loop.UDATrainer, "fit", boom)


@pytest.mark.parametrize(
    "module,argv,item",
    [
        (train_mmwhs, ["-skip_final_eval", "-ndev", "4"], "item 12"),
        (train_mmwhs, ["-skip_final_eval", "-dist"], "item 12"),
        (train_mmwhs, ["-softmax", "-d2"], "item 11"),  # no -skip_final_eval: refused before, not after, training
        (train_mscmrseg, ["-aug", "-ndev", "2"], "item 12"),
        (train_mscmrseg, ["-aug", "-dist"], "item 12"),
        (train_mscmrseg, ["-aug", "-host_aug"], "items 9 and 10"),
    ],
    ids=["mmwhs-ndev", "mmwhs-dist", "mmwhs-final-eval", "mscmrseg-ndev", "mscmrseg-dist", "mscmrseg-host-aug"],
)
def test_flags_that_are_not_ported_fail_before_training(no_training, module, argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        module.main(argv, device="cpu")


def test_the_gate_lets_a_ported_run_through(no_training):
    with pytest.raises(_Trained):
        train_mmwhs.main(["-skip_final_eval", "-ndev", "1"], device="cpu")


@pytest.mark.parametrize("argv", [["-dtype", "bfloat16", "-skip_final_eval"]])
def test_bfloat16_is_rejected_before_training(argv, tmp_path):
    """``check_config`` refuses the compute type when the trainer builds its
    state, before the first step (the data directory here is empty: the
    datalists are asked for first, so give it one)."""
    root = make_mmwhs_dataset(tmp_path / "d", size=32, n=2)
    with pytest.raises(ValueError, match="float32 only"):
        train_mmwhs.main(argv + ["-data_dir", root, "-workdir", str(tmp_path / "w"), "-logdir", str(tmp_path / "r")], device="cpu")


@pytest.mark.parametrize("argv", [[], ["-aug2"]], ids=["heavy", "medium"])
def test_mscmrseg_without_aug_asks_for_a_pipeline_that_is_not_ported(argv, tmp_path):
    root = make_mscmrseg_dataset(tmp_path / "d", n=2)
    with pytest.raises(NotImplementedError):
        train_mscmrseg.main(argv + ["-data_dir", root, "-workdir", str(tmp_path / "w"), "-logdir", str(tmp_path / "r")], device="cpu")
    assert not os.path.exists(tmp_path / "w")  # nothing was trained or saved


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
                   "-workers", "2"]
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
    assert proc.returncode == 0 and "train-mscmrseg, train-mmwhs" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "evaluate-mmwhs"], cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 2
    proc = subprocess.run([sys.executable, "-m", "pointcloududa_torch", "train-mmwhs", "-ndev", "2", "-skip_final_eval"], cwd=ROOT,
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and "ROADMAP Queue 1 item 12" in proc.stderr
