"""The port's convergence smokes (``pointcloududa_torch/smoke/smoke_train.py``,
``smoke_uda.py``) against the JAX package's tools (``tools/smoke_train.py``,
``tools/smoke_uda.py``).

- The task code is the tools' own, statement for statement.
- The UDA smoke's pool (batches, target evaluation batches and D4 clouds) is
  the JAX tool's bit for bit: the JAX tool's ``main`` runs with its train
  state, step and evaluation step replaced by recorders, so nothing of JAX
  is compiled for it.
- From the JAX package's initial weights, carried into the port
  (``utils/weights.py:load_jax_variables``), three supervised steps on the
  smoke's batches give the JAX step's metrics at the step tolerance of
  tests/test_torch_port_step.py (float32; 32^2, ``filters=8``,
  ``n_block=2``).
- Both ``main``s run on the CPU at a tiny size with their bars: the exit
  code follows the bar, the printed metrics are finite.
"""

import contextlib
import io
import re
import types

import numpy as np
import pytest

import jax

from pointcloududa_tpu.config import mscmrseg_default as jax_mscmrseg_default
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.train import step as jstep
from pointcloududa_torch.cli.common import with_kernels
from pointcloududa_torch.config import mscmrseg_default
from pointcloududa_torch.smoke import smoke_train, smoke_uda
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.train.step import make_train_step
from pointcloududa_torch.utils import weights
from test_torch_port_imports import _code
from test_torch_port_step import ATOL, RTOL, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("module,names", [("smoke_train", ["make_batch"]), ("smoke_uda", ["style_target"])])
def test_task_code_is_the_tools_code(module, names):
    import importlib

    port, ref = importlib.import_module(f"pointcloududa_torch.smoke.{module}"), importlib.import_module(f"tools.{module}")
    for name in names:
        assert _code(getattr(port, name)) == _code(getattr(ref, name)), name


def jax_tool_pool(monkeypatch, run, metric_keys):
    """``run()`` a JAX tool with recorders in place of its train state,
    train step and evaluation step; returns the batches it stepped on and
    the evaluation batches it probed, in order."""
    seen = {"batches": [], "evals": []}

    def make_step(cfg, models, optimizers):
        def step(state, batch):
            seen["batches"].append(batch)
            return state, {k: 1.0 for k in metric_keys}
        return step

    def make_eval(cfg, gen):
        def ev(gen_state, batch):
            seen["evals"].append(batch)
            return {"dice": 0.5}
        return ev

    monkeypatch.setattr(jstate, "create_train_state", lambda cfg, key: types.SimpleNamespace(gen=None))
    monkeypatch.setattr(jstep, "make_train_step", make_step)
    monkeypatch.setattr(jstep, "make_eval_step", make_eval)
    with contextlib.redirect_stdout(io.StringIO()):
        run()
    return seen


def assert_same_arrays(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, (where, key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")


def test_uda_pool_is_the_jax_tools_pool(monkeypatch):
    """size 32, bs 2, a pool of 2 with D4 clouds: two steps and the two
    probes (step 0 and the last) see the pool's batches in order."""
    from tools import smoke_uda as tool

    keys = ("seg_loss", "adv_loss", "seg_dice", "dis1_acc1", "dis1_acc2", "dis2_acc1", "dis2_acc2", "dis4_acc1", "dis4_acc2")
    seen = jax_tool_pool(monkeypatch, lambda: tool.main(["--steps", "2", "--bs", "2", "--size", "32", "--pool", "2", "--d4"]),
                         keys)
    pool = smoke_uda.make_pool(np.random.default_rng(0), 2, 2, 32, True)
    assert len(seen["batches"]) == len(seen["evals"]) == len(pool) == 2
    for i, (batch, tgt_eval) in enumerate(pool):
        assert_same_arrays(batch, seen["batches"][i], f"batch {i}")
        assert_same_arrays(tgt_eval, seen["evals"][i], f"target evaluation batch {i}")
        assert batch["vert_s"].shape == (2, 300, 3) and batch["vert_s"].any() and batch["vert_t"].any()


SIZE, BS = 32, 4


@pytest.fixture(scope="module")
def jax_supervised_steps():
    """The JAX supervised step (the smoke's configuration at 32^2, filters
    8, n_block 2, float32) over three of the smoke's batches from its own
    initial weights: those weights and the metrics of each step. Two JAX
    compiles: the init and the step."""
    cfg = jax_mscmrseg_default(crop_size=SIZE, fc_inch=1, n_block=2, filters=8, bs=BS, lr=1e-3)
    # jitted: one compile, where the eager init dispatches hundreds of primitives (~16 s on the CPU)
    state = jax.jit(lambda key: jstate.create_train_state(cfg, key))(jax.random.PRNGKey(0))
    init = {"params": jax.tree_util.tree_map(np.array, state.gen.params),
            "batch_stats": jax.tree_util.tree_map(np.array, state.gen.batch_stats)}
    step = jstep.make_train_step(cfg, jstate.build_models(cfg), jstate.build_optimizers(cfg))
    rng = np.random.default_rng(0)
    history = []
    for _ in range(3):
        imgs, masks = smoke_train.make_batch(rng, BS, SIZE)
        state, m = step(state, {"img_s": imgs, "mask_s": masks, "img_t": imgs.copy()})
        history.append({k: float(v) for k, v in m.items()})
    return init, history


def test_three_supervised_steps_match_jax_from_its_weights(jax_supervised_steps):
    init, history = jax_supervised_steps
    cfg = with_kernels(mscmrseg_default(crop_size=SIZE, fc_inch=1, n_block=2, filters=8, bs=BS, lr=1e-3,
                                        compute_dtype="float32"))
    st = create_train_state(cfg, seed=0, device="cpu")
    weights.load_jax_variables(st.models, {"gen": init})
    step = make_train_step(cfg, st.models, st.optimizers)
    rng = np.random.default_rng(0)
    for i, want in enumerate(history):
        imgs, masks = smoke_train.make_batch(rng, BS, SIZE)
        st, got = step(st, {"img_s": imgs, "mask_s": masks, "img_t": imgs.copy()})
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), want[key], rtol=RTOL, atol=ATOL, err_msg=f"step {i} {key}")
    assert history[-1]["seg_dice"] > history[0]["seg_dice"]  # it learns from the first steps


@pytest.mark.parametrize("bar,code", [(0.0, 0), (1.01, 1)])
def test_smoke_train_main_exits_by_its_bar(bar, code, capsys):
    argv = ["--steps", "3", "--bs", "2", "--size", "32", "--bar", str(bar)]
    if code:
        with pytest.raises(SystemExit) as e:
            smoke_train.main(argv, device="cpu")
        assert e.value.code == code
    else:
        dices = smoke_train.main(argv, device="cpu")
        assert [s for s, _ in dices] == [0, 2] and all(0.0 <= d <= 1.0 for _, d in dices)
    out = capsys.readouterr().out
    lines = re.findall(r"step +(\d+) seg_loss (\S+) seg_dice (\S+)", out)
    assert [int(s) for s, _, _ in lines] == [0, 2]
    assert all(np.isfinite(float(a)) and np.isfinite(float(b)) for _, a, b in lines)
    assert ("PASS" if code == 0 else "FAIL: final dice") in out and " on cpu" in out


def test_smoke_uda_main_with_d4_prints_finite_probes(capsys):
    """96^2 (the smallest input with a point head at n_block 4), bs 2, a pool
    of 2, two steps: both probes are printed with every metric finite, and
    the source Dice of two steps is below the bar, so it exits 1 for that
    reason and no other."""
    with pytest.raises(SystemExit) as e:
        smoke_uda.main(["--steps", "2", "--bs", "2", "--size", "96", "--pool", "2", "--d4", "--dtype", "float32"],
                       device="cpu")
    assert e.value.code == 1
    out = capsys.readouterr().out
    probes = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in probes] == [0, 1]
    for ln in probes:
        values = [float(v) for v in re.findall(r"-?\d+\.\d+", ln)]
        assert len(values) == 10 and all(np.isfinite(values)), ln  # losses, Dice, D1/D2/D4 accuracies
        assert " d4 " in ln
    assert "FAIL: source dice" in out and "non-finite" not in out
