"""The port's checkpointing (``pointcloududa_torch/train/checkpoint.py``)
against the JAX package's: for one monitor sequence both packages' callbacks
save, rename and stop at the same epochs and under the same names (Orbax
directories there, ``torch.save`` files here); the file layout, the lenient
restore, the atomic write, and a full snapshot's round trip through a
trainer. Decisions and names are compared exactly; restored tensors bit for
bit.
"""

import os

import numpy as np
import pytest
import torch

from pointcloududa_tpu.train import checkpoint as ref_ckpt
from pointcloududa_torch.config import mscmrseg_default
from pointcloududa_torch.data.sampler import RingSampler
from pointcloududa_torch.train import checkpoint as ckpt
from pointcloududa_torch.train.loop import UDATrainer
from test_torch_port_step import one_torch_thread  # noqa: F401


def _net(seed=0):
    torch.manual_seed(seed)
    module = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4), torch.nn.Linear(4, 2))
    opt = torch.optim.Adam(module.parameters(), lr=1e-3, betas=(0.9, 0.99))
    module(torch.randn(5, 3)).sum().backward()
    opt.step()  # the optimiser has moments and a step count to store
    return module, opt


# (monitor, epoch given to the callbacks): the second sequence ends early, the
# trainer passing n_epochs at a terminal epoch; the third never improves on epoch 1
SEQUENCES = {
    "improves-twice": [(0.3, 1), (0.2, 2), (0.5, 3), (0.5, 4), (0.4, 5)],
    "terminal-at-3": [(0.1, 1), (0.4, 2), (0.3, 5)],
    "first-is-best": [(0.9, 1), (0.2, 2), (0.1, 3), (0.3, 4), (0.5, 5)],
    "better-at-last": [(0.1, 1), (0.1, 2), (0.1, 3), (0.1, 4), (0.7, 5)],
}


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("save_best", [True, False], ids=["best", "last-only"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_checkpoint_callback_decisions_equal_the_jax_package(tmp_path, name, save_best, mode):
    """After every epoch both work directories hold entries of the same
    names, and the callbacks the same monitor, epoch and final path."""
    module, opt = _net()
    tree = {"net": ckpt.net_state(module, opt), "config": None}
    ref_tree = {"net": {"w": np.arange(3.0)}, "config": None}
    mk = lambda lib, d: lib.ModelCheckpointCallback(  # noqa: E731
        mode=mode, best_model_name=f"{d}/best_unet", model_name=f"{d}/unet", save_best=save_best,
        save_last_model=True, n_epochs=5,
    )
    ours, theirs = mk(ckpt, tmp_path / "ours"), mk(ref_ckpt, tmp_path / "theirs")
    os.makedirs(tmp_path / "ours")
    os.makedirs(tmp_path / "theirs")
    for monitor, epoch in SEQUENCES[name]:
        ours.step(monitor, tree, epoch)
        theirs.step(monitor, ref_tree, epoch)
        assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "theirs")), (monitor, epoch)
        assert (ours.best_result, ours.epoch) == (theirs.best_result, theirs.epoch)
        assert all(os.path.isfile(tmp_path / "ours" / f) for f in os.listdir(tmp_path / "ours"))
    assert (ours.final_best_path is None) == (theirs.final_best_path is None)
    if save_best:
        assert os.path.basename(ours.final_best_path) == os.path.basename(theirs.final_best_path)
        assert ".Scr" in ours.final_best_path and os.path.exists(ours.final_best_path)
        assert ckpt.restore_pytree(ours.final_best_path)["epoch"] == ours.epoch
    assert ckpt.restore_pytree(f"{tmp_path}/ours/unet")["epoch"] == 5


@pytest.mark.parametrize("mode,patience", [("max", 2), ("min", 1), ("max", 1)])
def test_early_stopping_equals_the_jax_package(mode, patience):
    ours, theirs = ckpt.EarlyStoppingCallback(patience, mode), ref_ckpt.EarlyStoppingCallback(patience, mode)
    for monitor in (0.3, 0.5, 0.5, 0.4, 0.6, 0.1, 0.1):
        ours.step(monitor)
        theirs.step(monitor)
        assert (ours.counter, ours.best_result, ours.should_stop()) == (theirs.counter, theirs.best_result, theirs.should_stop())


def test_checkpoint_file_layout_and_restore(tmp_path):
    """The reference's ``{epoch, model_state, optimizer_state}`` as ``{"epoch",
    "state": {"net": {"model", "optimizer"}, "config": None}}``; weights and
    optimiser state come back bit for bit through ``weights_only`` loading."""
    module, opt = _net(1)
    cb = ckpt.ModelCheckpointCallback(mode="max", model_name=f"{tmp_path}/w/unet", save_last_model=True, n_epochs=1)
    cb.step(0.5, {"net": ckpt.net_state(module, opt), "config": None}, 1)
    payload = torch.load(f"{tmp_path}/w/unet", weights_only=True)
    assert set(payload) == {"epoch", "state"} and payload["epoch"] == 1
    assert set(payload["state"]) == {"net", "config"} and payload["state"]["config"] is None
    assert set(payload["state"]["net"]) == {"model", "optimizer"}

    other, other_opt = _net(2)
    assert not torch.equal(other[0].weight, module[0].weight)
    assert ckpt.restore_net_state(f"{tmp_path}/w/unet", other, other_opt) is other
    for (k, a), b in zip(module.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = opt.state_dict(), other_opt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    # without an optimiser only the weights are taken
    third, third_opt = _net(3)
    before = third_opt.state_dict()["state"][0]["exp_avg"].clone()
    ckpt.restore_net_state(f"{tmp_path}/w/unet", third)
    assert torch.equal(third[2].bias, module[2].bias) and torch.equal(third_opt.state_dict()["state"][0]["exp_avg"], before)


def test_bare_state_dict_restores(tmp_path):
    """The reference's released weight files are bare ``state_dict``s."""
    module, _ = _net(4)
    path = str(tmp_path / "released.pt")
    torch.save(module.state_dict(), path)
    other, other_opt = _net(5)
    ckpt.restore_net_state(path, other, other_opt)  # an optimiser is given, the file has none: weights only
    assert all(torch.equal(a, b) for a, b in zip(module.state_dict().values(), other.state_dict().values()))
    with pytest.raises(RuntimeError):  # another network's file does not load silently
        ckpt.restore_net_state(path, torch.nn.Linear(3, 4))


def _as_torch_1_4(opt_state: dict) -> dict:
    """An optimiser state as torch 1.4 wrote it: ``step`` a Python int."""
    state = {i: {k: (int(v) if k == "step" else v) for k, v in st.items()} for i, st in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def _trained_discriminator(seed):
    from pointcloududa_torch.models import UncertaintyDiscriminator

    torch.manual_seed(seed)
    module = UncertaintyDiscriminator(4)
    opt = torch.optim.Adam(module.parameters(), lr=1e-3, betas=(0.9, 0.99))
    module(torch.randn(2, 32, 32, 4)).sum().backward()
    opt.step()
    return module, opt


def _write_layout(path, layout, module, opt):
    if layout == "trainer":
        ckpt.save_pytree(path, {"epoch": 3, "state": {"net": ckpt.net_state(module, opt), "config": None}})
    elif layout == "callback":  # the reference's ModelCheckPointCallback (callbacks.py:75-80) under torch 1.4
        torch.save({"epoch": 3, "model_state_dict": module.state_dict(), "optimizer_state_dict": _as_torch_1_4(opt.state_dict())},
                   path, _use_new_zipfile_serialization=False)
    else:
        torch.save(module.state_dict(), path)


@pytest.mark.parametrize("layout", ["trainer", "callback", "bare"])
def test_restore_net_state_reads_three_layouts(tmp_path, layout):
    """The port's trainer layout, the reference's callback layout (written as
    torch 1.4 wrote it, with the legacy serialisation) and a bare
    ``state_dict``: the weights come back bit for bit, and the optimiser's
    moments too wherever the file has them."""
    module, opt = _trained_discriminator(0)
    path = str(tmp_path / "d1.pt")
    _write_layout(path, layout, module, opt)
    other, other_opt = _trained_discriminator(1)
    ckpt.restore_net_state(path, other, other_opt)
    for (k, a), b in zip(module.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = opt.state_dict()["state"], other_opt.state_dict()["state"]
    if layout == "bare":
        assert not torch.equal(got[0]["exp_avg"], want[0]["exp_avg"])  # nothing to restore: left as it was
    else:
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(got[i][k]), torch.as_tensor(v)), (i, k)
        other.zero_grad()
        other(torch.randn(2, 32, 32, 4)).sum().backward()
        other_opt.step()  # the restored state steps (a torch 1.4 int step included)


def test_reference_optimizer_state_is_placed_by_parameter_name(tmp_path):
    """The reference's optimiser lists its module's parameters in the order
    of its ``model_state_dict``. A file whose modules registered in another
    order than the port's (here reversed) has its moments moved to the
    parameters of the same names."""
    module, opt = _trained_discriminator(2)
    names = [n for n, _ in module.named_parameters()]
    order = names[::-1]  # the writer's registration order
    sd = module.state_dict()
    by_name = dict(zip(names, opt.state_dict()["state"].values()))
    state = {i: by_name[n] for i, n in enumerate(order)}
    groups = [dict(g, params=list(range(len(order)))) for g in opt.state_dict()["param_groups"]]
    path = str(tmp_path / "reordered.pt")
    torch.save({"epoch": 1, "model_state_dict": {n: sd[n] for n in order},
                "optimizer_state_dict": _as_torch_1_4({"state": state, "param_groups": groups})},
               path, _use_new_zipfile_serialization=False)
    other, other_opt = _trained_discriminator(3)
    ckpt.restore_net_state(path, other, other_opt)
    got = other_opt.state_dict()["state"]
    for i, name in enumerate(names):
        assert torch.equal(got[i]["exp_avg"], by_name[name]["exp_avg"]), name
    ckpt.restore_net_state(path, other)  # weights only: no optimiser, nothing to place
    assert all(torch.equal(a, b) for a, b in zip(module.state_dict().values(), other.state_dict().values()))


def test_load_weight_reads_the_reference_callback_layout(tmp_path):
    """``-load_weight`` (``cli/common.py:warm_restart``) from files in the
    reference's callback layout, written with torch 1.4's serialisation under
    the trainer's names: every network and its optimiser come back."""
    from pointcloududa_torch.cli import common

    source, target = _trainer(tmp_path, "src"), _trainer(tmp_path, "dst")
    source.train_epoch()
    callbacks = (target.ckpt_gen, target.ckpt_d1, target.ckpt_d2, target.ckpt_d4)
    for cb, module, opt in zip(callbacks, source.state.models, source.state.optimizers):
        if cb is not None:
            os.makedirs(os.path.dirname(cb.model_name), exist_ok=True)
            _write_layout(cb.model_name, "callback", module, opt)
    common.warm_restart(target)
    for m1, m2, o1, o2 in zip(source.state.models, target.state.models, source.state.optimizers, target.state.optimizers):
        if m1 is None:
            continue
        for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
            assert torch.equal(a, b), k
        for i, st in o1.state_dict()["state"].items():
            assert torch.equal(o2.state_dict()["state"][i]["exp_avg_sq" if "exp_avg_sq" in st else "momentum_buffer"],
                               st["exp_avg_sq" if "exp_avg_sq" in st else "momentum_buffer"]), i


def test_save_is_atomic_and_takes_tensors_and_python_scalars_only(tmp_path):
    path = str(tmp_path / "deep" / "snap")
    ckpt.save_pytree(path, {"epoch": 1, "x": torch.arange(3)})
    ckpt.save_pytree(path, {"epoch": 2, "x": torch.arange(4), "t": (0.9, 0.99), "none": None, "s": "name", "inf": float("-inf")})
    assert os.listdir(tmp_path / "deep") == ["snap"]  # the temporary file was moved into place
    back = ckpt.restore_pytree(path)
    assert back["epoch"] == 2 and back["x"].tolist() == [0, 1, 2, 3] and back["t"] == (0.9, 0.99) and back["inf"] == float("-inf")
    for bad in ({"lr": np.float64(0.1)}, {"a": {"order": np.arange(3)}}, {"l": [np.int64(1)]}):
        with pytest.raises(TypeError, match="numpy"):
            ckpt.save_pytree(path, bad)
    assert ckpt.restore_pytree(path)["epoch"] == 2  # a refused save leaves the file as it was

    class Boom:
        def __reduce__(self):
            raise RuntimeError("killed while writing")

    with pytest.raises(RuntimeError, match="killed"):
        ckpt.save_pytree(path, {"epoch": 3, "x": Boom()})
    assert ckpt.restore_pytree(path)["epoch"] == 2  # a save that dies half way too


TINY = dict(filters=4, crop_size=32, fc_inch=9, bs=4, ns=8, epochs=2, aug="", n_block=2, d2=True, d4=True, drop=True, patience=3)


class _SynthIter:
    """Synthetic raw MS-CMRSeg batches behind two real samplers, as
    tests/test_resume.py has them for the JAX trainer."""

    def __init__(self, cfg, steps=2):
        self.cfg, self.steps, self.steps_per_epoch = cfg, steps, steps
        self._src_sampler = RingSampler(10, cfg.bs, cfg.ns, shuffle_seed=0)
        self._tgt_sampler = RingSampler(10, cfg.bs, cfg.ns, shuffle_seed=1)

    def epoch(self):
        rng = np.random.default_rng(0)
        list(self._src_sampler.epoch())  # advance the cursors
        list(self._tgt_sampler.epoch())
        hw, bs = self.cfg.crop_size, self.cfg.bs
        for _ in range(self.steps):
            yield {
                "img_s": rng.integers(0, 255, size=(bs, hw, hw, 3)).astype(np.uint8),
                "mask_s": rng.integers(0, 4, size=(bs, hw, hw)).astype(np.uint8),
                "img_t": rng.integers(0, 255, size=(bs, hw, hw, 3)).astype(np.uint8),
                "vert_s": rng.integers(0, hw, size=(bs, 300, 3)).astype(np.float32),
                "vert_t": rng.integers(0, hw, size=(bs, 300, 3)).astype(np.float32),
            }


def _val(cfg):
    def make():
        rng = np.random.default_rng(1)
        hw = cfg.crop_size
        yield {
            "img": rng.integers(0, 255, size=(cfg.bs, hw, hw, 3)).astype(np.uint8),
            "mask": rng.integers(0, 4, size=(cfg.bs, hw, hw)).astype(np.uint8),
            "vert": rng.integers(0, hw, size=(cfg.bs, 300, 3)).astype(np.float32),
        }

    return make


def _trainer(tmp_path, tag):
    cfg = mscmrseg_default(**TINY)
    vals = {"val": _val(cfg), "val_lge": _val(cfg), "test_lge": _val(cfg)}
    return UDATrainer(cfg, _SynthIter(cfg), vals, workdir=str(tmp_path / f"w{tag}"), logdir=str(tmp_path / f"r{tag}"), device="cpu")


def test_full_snapshot_round_trips_every_field(tmp_path):
    """Networks, optimisers, step count, both generators' states, lr, best,
    the callback's and the early stop's monitors, both samplers' cursors and
    orders; and the two trainers then take the same next epoch, bit for bit
    (dropout and D4 on, so both generators are drawn from)."""
    t1 = _trainer(tmp_path, 1)
    t1.train_epoch()
    t1._aug_gen.manual_seed(99)
    torch.rand(3, generator=t1._aug_gen)
    t1._lr = 123.0
    t1.best.update(val_lge_dice=0.42, epoch=1)
    t1.ckpt_gen.best_result, t1.ckpt_gen.epoch = 0.37, 1
    t1.early_stop.counter, t1.early_stop.best_result = 2, 0.41
    snap = str(tmp_path / "full")
    t1.save_full(snap, epoch=1)
    assert os.path.isfile(snap)
    payload = ckpt.restore_pytree(snap)
    assert set(payload["nets"]) == {"gen", "d2", "d4"} and payload["src_sampler"]["order"].dtype == torch.int64

    t2 = _trainer(tmp_path, 2)
    t2.train_iter._src_sampler = RingSampler(10, 4, 8, shuffle_seed=50)  # another order until restored
    assert t2.restore_full(snap) == 2
    assert (t2._lr, t2.best["val_lge_dice"], t2.best["epoch"]) == (123.0, 0.42, 1)
    assert (t2.ckpt_gen.best_result, t2.ckpt_gen.epoch) == (0.37, 1)
    assert (t2.early_stop.counter, t2.early_stop.best_result) == (2, 0.41)
    assert t2.state.step == t1.state.step == 2
    assert torch.equal(t2._aug_gen.get_state(), t1._aug_gen.get_state())
    assert torch.equal(t2.state.generator.get_state(), t1.state.generator.get_state())
    for m1, m2, o1, o2 in zip(t1.state.models, t2.state.models, t1.state.optimizers, t2.state.optimizers):
        assert (m1 is None) == (m2 is None)
        if m1 is None:
            continue
        for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
            assert torch.equal(a, b), k
        s1, s2 = o1.state_dict(), o2.state_dict()
        assert s1["param_groups"] == s2["param_groups"] and set(s1["state"]) == set(s2["state"])
        for i, st in s1["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(s2["state"][i][k])), (i, k)
    for name in ("_src_sampler", "_tgt_sampler"):
        a, b = getattr(t1.train_iter, name).state(), getattr(t2.train_iter, name).state()
        assert a["cursor"] == b["cursor"] and a["cursor"] != 0
        np.testing.assert_array_equal(a["order"], b["order"])
    m1, m2 = t1.train_epoch(), t2.train_epoch()
    assert m1 == m2 and set(m1) >= {"seg_loss", "d4_loss", "ver_t_loss"}
