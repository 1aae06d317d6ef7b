"""The port's evaluate CLIs (``pointcloududa_torch/cli/evaluate_*.py``)
against the JAX package's: the same flags give the same ``UDAConfig`` (but
for the packed layouts, which the port does not have) and the same keyword
arguments to the evaluator, ``-from_name`` included; the checkpoint file is
restored in any of the three layouts; ``-dtype bfloat16`` builds the
generator in bfloat16 (its labels against the JAX CLI's:
``tests/test_torch_port_bf16.py``). The evaluators are stubbed, as ``tests/test_eval_cli.py`` does,
and both packages' presets made tiny (``filters=4, n_block=2,
crop_size=32, fc_inch=9``) through their late binding; on the JAX side the
state creation and restore are stubbed too (they need an Orbax directory and
are tested there).
"""

import dataclasses
import types

import pytest
import torch

import pointcloududa_torch.config as port_config
import pointcloududa_tpu.config as ref_config
from pointcloududa_torch.cli import evaluate_mmwhs, evaluate_mscmrseg
from pointcloududa_torch.eval import volume as port_volume
from pointcloududa_torch.train import checkpoint as ckpt
from pointcloududa_torch.train.state import build_models
from test_torch_port_step import one_torch_thread  # noqa: F401

TINY = dict(filters=4, n_block=2, crop_size=32, fc_inch=9)
NOT_IN_THE_PORT = {"packed_level0", "packed_level1", "packed_compute"}


@pytest.fixture
def tiny_presets(monkeypatch):
    for mod in (port_config, ref_config):
        for name in ("mscmrseg_default", "mmwhs_default"):
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda _real=real, **kw: _real(**{**kw, **TINY}))


def _stub(monkeypatch, module, name):
    calls = []

    def record(cfg, gen, *args, **kw):
        calls.append(types.SimpleNamespace(cfg=cfg, gen=gen, args=args, kw=kw))

    monkeypatch.setattr(module, name, record)
    return calls


def _jax_side(monkeypatch, evaluator):
    """Run the JAX CLI with state creation, restore and the evaluator stubbed."""
    import pointcloududa_tpu.eval.volume as ref_volume
    import pointcloududa_tpu.train.checkpoint as ref_ckpt
    import pointcloududa_tpu.train.state as ref_state

    monkeypatch.setattr(ref_state, "create_train_state", lambda cfg, key: types.SimpleNamespace(gen=None))
    monkeypatch.setattr(ref_state, "build_models", lambda cfg: (None,))
    monkeypatch.setattr(ref_ckpt, "restore_net_state", lambda path, template: template)
    return _stub(monkeypatch, ref_volume, evaluator)


def _write(path, cfg, layout, seed=0):
    """A generator checkpoint for ``cfg`` at ``path`` in ``layout``; returns
    its state_dict."""
    gen = build_models(cfg, torch.Generator().manual_seed(seed))[0]
    if layout == "trainer":
        ckpt.save_pytree(path, {"epoch": 4, "state": {"net": ckpt.net_state(gen, None), "config": None}})
    elif layout == "callback":  # the reference's callback layout, as torch 1.4 wrote it
        torch.save({"epoch": 4, "model_state_dict": gen.state_dict(), "optimizer_state_dict": None}, path,
                   _use_new_zipfile_serialization=False)
    else:
        torch.save(gen.state_dict(), path)
    return gen.state_dict()


def _same(port_call, ref_call, weights):
    a, b = dataclasses.asdict(port_call.cfg), dataclasses.asdict(ref_call.cfg)
    assert {k: v for k, v in a.items() if k not in NOT_IN_THE_PORT} == {k: v for k, v in b.items() if k not in NOT_IN_THE_PORT}
    assert port_call.cfg.compute_dtype == "float32" and not port_call.cfg.packed_level0
    assert {k: v for k, v in port_call.kw.items() if k != "device"} == ref_call.kw
    assert port_call.kw["device"] == torch.device("cpu") and port_call.args == ref_call.args[1:] == ()
    got = port_call.gen.state_dict()
    assert set(got) == set(weights) and all(torch.equal(got[k], weights[k]) for k in weights)
    assert next(port_call.gen.parameters()).device.type == "cpu"


MSCMRSEG_CASES = [
    ("best_unet_model_checkpoint_x.lr0.001.d1lr2.5e-05.d4lr2.5e-05.Scr0.8", ["-from_name", "-klc", "-bs", "4", "-pat_lo", "6",
                                                                            "-pat_hi", "8", "-ifasd", "0"], "trainer"),
    ("released.pt", ["-d4", "-clahe", "-csv", "per_patient.csv", "-toplot", "plots", "-no_packed", "-data_dir", "/data",
                     "-ifhd", "0", "-nf", "16", "-dtype", "float32"], "callback"),
    ("bare.pt", [], "bare"),
    ("unet.d4aux.pt", ["-from_name"], "bare"),
]


@pytest.mark.parametrize("name,argv,layout", MSCMRSEG_CASES, ids=["from-name", "callback-layout", "defaults", "d4aux-name"])
def test_evaluate_mscmrseg_cli_equals_the_jax_cli(tiny_presets, tmp_path, monkeypatch, capsys, name, argv, layout):
    from pointcloududa_tpu.cli import evaluate_mscmrseg as ref_cli

    path = str(tmp_path / name)
    d4 = "-d4" in argv or ("-from_name" in argv and ("d4lr" in name or "d4aux" in name))
    weights = _write(path, port_config.mscmrseg_default(d4=d4), layout)
    ref_calls = _jax_side(monkeypatch, "evaluate_mscmrseg")
    port_calls = _stub(monkeypatch, port_volume, "evaluate_mscmrseg")
    ref_cli.main(["-model_dir", path] + argv)
    evaluate_mscmrseg.main(["-model_dir", path] + argv, device="cpu")
    out = capsys.readouterr().out
    assert out.count(f"model loaded from {path}") == 2
    _same(port_calls[0], ref_calls[0], weights)
    assert port_calls[0].cfg.d4 is d4


MMWHS_CASES = [
    ("best_unet_model_checkpoint_y.lr0.001.mh.softmax.d2lr2.5e-05", ["-from_name", "-ifhd", "0"], "trainer"),
    ("released.d4lr.extpn.pt", ["-from_name", "-save", "-model_name", "m1", "-csv", "eval.csv", "-pat_ids", "1003", "1014",
                                "-toplot", "plots", "-bs", "2", "-no_packed"], "callback"),
    ("bare.pt", ["-d4", "-extpn", "-ifasd", "0", "-data_dir", "/data"], "bare"),
]


@pytest.mark.parametrize("name,argv,layout", MMWHS_CASES, ids=["from-name", "callback-layout", "flags"])
def test_evaluate_mmwhs_cli_equals_the_jax_cli(tiny_presets, tmp_path, monkeypatch, capsys, name, argv, layout):
    from pointcloududa_tpu.cli import evaluate_mmwhs as ref_cli

    path = str(tmp_path / name)
    named = "-from_name" in argv
    d4, extpn = "-d4" in argv or (named and "d4lr" in name), "-extpn" in argv or (named and "extpn" in name)
    weights = _write(path, port_config.mmwhs_default(d4=d4, extpn=extpn), layout)
    ref_calls = _jax_side(monkeypatch, "evaluate_mmwhs")
    port_calls = _stub(monkeypatch, port_volume, "evaluate_mmwhs")
    ref_cli.main(["-weight_dir", path] + argv)
    ref_out = capsys.readouterr().out
    evaluate_mmwhs.main(["-weight_dir", path] + argv, device="cpu")
    assert capsys.readouterr().out == ref_out  # the tag listing of -from_name and the restore line
    _same(port_calls[0], ref_calls[0], weights)
    assert (port_calls[0].cfg.d4, port_calls[0].cfg.extpn) == (d4, extpn)


@pytest.mark.parametrize("cli,flag,preset,evaluator", [
    (evaluate_mscmrseg, "-model_dir", "mscmrseg_default", "evaluate_mscmrseg"),
    (evaluate_mmwhs, "-weight_dir", "mmwhs_default", "evaluate_mmwhs"),
], ids=["mscmrseg", "mmwhs"])
def test_bfloat16_builds_the_generator_in_bfloat16(tiny_presets, tmp_path, monkeypatch, cli, flag, preset, evaluator):
    """``-dtype bfloat16`` reaches the config and the generator: its layers
    compute in bf16 and it holds the file's f32 weights (a checkpoint
    written by a float32 run)."""
    from pointcloududa_torch.models.unet import Conv2d

    path = str(tmp_path / "gen.pt")
    weights = _write(path, dataclasses.replace(getattr(port_config, preset)(), compute_dtype="float32"), "bare")
    calls = _stub(monkeypatch, port_volume, evaluator)
    cli.main([flag, path, "-dtype", "bfloat16"], device="cpu")
    gen = calls[0].gen
    assert calls[0].cfg.compute_dtype == "bfloat16" and gen.compute_dtype == torch.bfloat16
    assert all(m.compute_dtype == torch.bfloat16 for m in gen.modules() if isinstance(m, Conv2d))
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    assert all(torch.equal(gen.state_dict()[k], v) for k, v in weights.items())


def test_a_file_of_another_network_does_not_load(tiny_presets, tmp_path):
    path = str(tmp_path / "other.pt")
    _write(path, port_config.mmwhs_default(d4=True), "callback")
    with pytest.raises(RuntimeError, match="pointNet"):  # the file has the point head, the flags do not
        evaluate_mmwhs.main(["-weight_dir", path], device="cpu")
