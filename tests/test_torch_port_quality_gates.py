"""The port's quality gates (``pointcloududa_torch/smoke/quality_gates.py``)
and D4 calibration arms (``smoke/calibrate_d4.py``) against the JAX
package's: ``tests/test_uda_quality_gate.py`` and ``tests/test_d4_quality_gate.py``
over ``tools/calibrate_d4.py:run_arm``.

- The task code is the originals', statement for statement.
- Each pool (the gate's batches, target evaluation batches and, for the
  point-head arms, the clouds) is the JAX gate's or tool's bit for bit: the
  JAX function runs with recorders in place of its train state, step and
  evaluation step, so nothing of JAX is compiled for it.
- From the same weights (the port's initial ones, carried into the JAX
  package by its importer of reference checkpoints on an ``eval_shape``
  template, as tests/test_torch_port_step.py does), three steps of the UDA
  gate's D1+D2 arm and of the D4 gate's D2+D4 arm on the gate's pool, with
  D4's dropout off in both, give the JAX step's metrics at the tolerances
  of tests/test_torch_port_step.py, and the probe Dice over the pool after
  them is JAX's; once D4 has taken an update, within twice what JAX moves
  against itself (the test says why). Each arm compiles JAX's train step
  and its evaluation step.
- The gates run end to end at 4 steps on the CPU and return finite tables;
  their conditions pass the JAX gates' calibration tables and refuse
  tables that break them.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax

import test_uda_quality_gate as jax_uda_gate
from pointcloududa_tpu.config import UDAConfig as JaxUDAConfig
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.train import step as jstep
from pointcloududa_torch.smoke import calibrate_d4, quality_gates
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.train.step import make_eval_step, make_train_step
from test_torch_port_imports import _code
from test_torch_port_smokes import assert_same_arrays, jax_tool_pool
from test_torch_port_step import ATOL, RTOL, _jax_state, one_torch_thread  # noqa: F401
from tools import calibrate_d4 as tool

KEYS = ("seg_loss", "seg_dice", "dis4_acc1", "dis4_acc2")


@pytest.mark.parametrize("port,ref", [
    (calibrate_d4.make_shift_batch, tool.make_shift_batch),
    (calibrate_d4.style_target, tool.style_target),
    (quality_gates._style_target, jax_uda_gate._style_target),
], ids=["make_shift_batch", "calibrate_d4.style_target", "uda_gate._style_target"])
def test_task_code_is_the_originals(port, ref):
    assert _code(port) == _code(ref)


@pytest.mark.parametrize("arm,seed", [("d2", 0), ("d2d4", 1)])
def test_d4_pool_is_the_jax_tools(monkeypatch, arm, seed):
    """``make_pool`` against ``tools/calibrate_d4.py:run_arm``'s pool: six
    steps and the probe after the last see the six pairs in order."""
    seen = jax_tool_pool(monkeypatch, lambda: tool.run_arm(arm, seed, 6, probes=()), KEYS)
    pool = calibrate_d4.make_pool(seed, calibrate_d4.arm_config(arm).point_head)
    assert len(seen["batches"]) == len(seen["evals"]) == len(pool) == 6
    for i, (batch, tgt_eval) in enumerate(pool):
        assert_same_arrays(batch, seen["batches"][i], f"batch {i}")
        assert_same_arrays(tgt_eval, seen["evals"][i], f"target evaluation batch {i}")
    assert ("vert_s" in pool[0][0]) == (arm == "d2d4")


def test_uda_gate_pool_is_the_jax_gates(monkeypatch):
    """``uda_pool`` against the pool of ``tests/test_uda_quality_gate.py:_run``:
    its 400 steps cycle six batches and its first probe (step 100) sees the
    six evaluation batches."""
    seen = {"batches": [], "evals": []}

    def step(state, batch):
        seen["batches"].append(batch)
        return state, {"seg_loss": 1.0}

    def ev(gen_state, batch):
        seen["evals"].append(batch)
        return {"dice": 0.5}

    monkeypatch.setattr(jax_uda_gate, "create_train_state", lambda cfg, key: types.SimpleNamespace(gen=None))
    jax_uda_gate._run((None, step, ev), 2)
    pool = quality_gates.uda_pool(2)
    assert len(seen["batches"]) == 400 and len(seen["evals"]) == 7 * 6
    for i, (batch, tgt_eval) in enumerate(pool):
        for j in range(i, 400, 6):
            assert seen["batches"][j] is seen["batches"][i]
        assert_same_arrays(batch, seen["batches"][i], f"batch {i}")
        assert_same_arrays(tgt_eval, seen["evals"][i], f"target evaluation batch {i}")


def _arm(name):
    """(port config, pool) of an arm: the UDA gate's D1+D2, or the D4 gate's D2+D4."""
    if name == "uda":
        return quality_gates.uda_config(True), quality_gates.uda_pool(0)
    cfg = calibrate_d4.arm_config("d2d4")
    return cfg, calibrate_d4.make_pool(0, cfg.point_head)


def _decisions(cfg, key):
    """Decisions behind a threshold metric: D1/D2 patch logits, D4 samples."""
    if key.startswith("dis4"):
        return cfg.bs
    side = cfg.crop_size
    for _ in range(5):  # k4 s2 pad2 convs: 32 -> 17 -> 9 -> 5 -> 3 -> 2
        side = side // 2 + 1
    return cfg.bs * side * side


def _permuted(pool, seed):
    """The pool with each batch's samples reordered (source and target rows
    by their own permutations, a cloud with its image): the same function of
    the batch, its sums in another order."""
    rng = np.random.default_rng(seed)
    out = []
    for batch, tgt_eval in pool:
        p, q = rng.permutation(len(batch["img_s"])), rng.permutation(len(batch["img_t"]))
        out.append(({k: v[q] if k in ("img_t", "vert_t") else v[p] for k, v in batch.items()}, tgt_eval))
    return out


@pytest.fixture(scope="module")
def jax_arm_runs():
    """Per arm: JAX's metrics of three steps on the pool from the port's
    initial weights (seed 0) and its probe Dice after them, and the same on
    the pool with each batch's samples permuted (JAX against itself). Two
    compiles an arm, its train step (~6-9 s on the CPU) and its evaluation
    step (~1 s): one program of the three steps and the probe (a scan and a
    map) took twice as long to compile."""
    runs = {}
    for name in ("uda", "d2d4"):
        cfg, pool = _arm(name)
        st = create_train_state(cfg, seed=0, device="cpu")
        # the JAX package's XLA routes; the port's kernel selectors name its Pallas kernels there
        jcfg = dataclasses.replace(JaxUDAConfig.from_json(cfg.to_json()), chamfer_impl="auto", bn_stats_impl="xla")
        models = list(jstate.build_models(jcfg))
        if jcfg.d4:
            models[3] = models[3].clone(drop=0.0)
        step = jstep.make_train_step(jcfg, tuple(models), jstate.build_optimizers(jcfg))
        ev = jstep.make_eval_step(jcfg, models[0])

        init = _jax_state(jcfg, st.models, 0)
        for key, p in (("jax", pool), ("permuted", _permuted(pool, 1))):
            # a copy through the host: the step donates its state
            jst, history = jax.tree_util.tree_map(lambda x: jax.numpy.asarray(np.asarray(x)), init), []
            for batch, _ in p[:3]:
                jst, m = step(jst, batch)
                history.append({k: float(v) for k, v in m.items()})
            runs[name, key] = (history, float(np.mean([float(ev(jst.gen, te)["dice"]) for _, te in pool])))
    return runs


# how far the port may lie from JAX after D4's first update, in units of how
# far JAX lies from itself on the same batches with their samples permuted
WITNESS_FACTOR = 2.0


@pytest.mark.parametrize("name", ["uda", "d2d4"])
def test_three_arm_steps_and_the_probe_match_jax(name, jax_arm_runs):
    """Every metric of the first step at the step tolerance (a threshold
    metric within two flipped decisions). The D1+D2 arm holds it for all
    three steps. D4 is ill-conditioned at the gates' default init (ROADMAP
    Queue 3: the generator's clouds nearly collapse, and D4's fast-variance
    BatchNorms normalise f32 noise), so once D4 has taken an update its
    losses, and through ``dr`` the generator's, move with the order of f32
    sums: in the D2+D4 arm, steps 2 and 3 and the probe are held to the step
    tolerance or to WITNESS_FACTOR times JAX's largest gap against itself on
    the permuted pool over the three steps, whichever is larger."""
    history, jax_dice = jax_arm_runs[name, "jax"]
    witness, witness_dice = jax_arm_runs[name, "permuted"]
    cfg, pool = _arm(name)
    st = create_train_state(cfg, seed=0, device="cpu")
    if cfg.d4:
        st.models[3].dropout.p = 0.0
    step = make_train_step(cfg, st.models, st.optimizers)
    spread = {k: max(abs(w[k] - j[k]) for w, j in zip(witness, history)) for k in history[0]}
    for i, want in enumerate(history):
        st, got = step(st, pool[i][0])
        assert set(got) == set(want)
        for key in want:
            tol = dict(rtol=0.0, atol=2.0 / _decisions(cfg, key)) if key.startswith("dis") else dict(rtol=RTOL, atol=ATOL)
            if cfg.d4 and i > 0:
                tol["atol"] = max(tol["atol"], WITNESS_FACTOR * spread[key])
            np.testing.assert_allclose(float(got[key]), want[key], **tol, err_msg=f"step {i} {key}")
    assert ("dis1_acc1" in history[0]) == (name == "uda") and ("dis4_acc1" in history[0]) == (name == "d2d4")
    dice = calibrate_d4.probe_dice(make_eval_step(cfg, st.models[0]), pool)
    atol = max(ATOL, WITNESS_FACTOR * abs(witness_dice - jax_dice)) if cfg.d4 else ATOL
    np.testing.assert_allclose(dice, jax_dice, rtol=0.0, atol=atol)


@pytest.mark.parametrize("gate", ["uda", "d4"])
def test_gates_run_and_return_finite_tables(gate):
    """Four steps a run, seed 0: no threshold is asserted (the probes start
    at step 100 in the UDA gate, so its bests stay 0.0; the D4 gate probes
    after its last step)."""
    rows = getattr(quality_gates, f"gate_{gate}")(seeds=(0,), steps=4, device="cpu")
    arms = ("no_uda", "uda") if gate == "uda" else ("d2", "d2d4")
    assert len(rows) == 1 and rows[0]["seed"] == 0
    values = [rows[0][a] for a in arms] + [rows[0]["margin"], *rows[0]["seconds"]]
    assert all(np.isfinite(values)) and all(0.0 <= rows[0][a] <= 1.0 for a in arms)
    if gate == "uda":
        assert rows[0]["no_uda"] == rows[0]["uda"] == 0.0
    lines = quality_gates.table_lines(rows, arms, quality_gates.UDA_JAX if gate == "uda" else quality_gates.D4_JAX)
    assert len(lines) == 3 and "JAX calibration" in lines[0]


def _uda_rows(table):
    return [dict(seed=s, no_uda=a, uda=b, margin=b - a, seconds=(0.0, 0.0)) for s, (a, b) in table.items()]


def _d4_rows(table):
    return [dict(seed=s, d2=a, d2d4=b, margin=b - a, seconds=(0.0, 0.0)) for s, (a, b) in table.items()]


@pytest.mark.parametrize("check,rows,error", [
    ("uda", _uda_rows(quality_gates.UDA_JAX["CPU"]), None),
    ("uda", _uda_rows({0: (0.386, 0.423), 1: (0.72, 0.80), 2: (0.313, 0.395)}), "task drifted: seed 1"),
    ("uda", _uda_rows({0: (0.40, 0.45), 1: (0.40, 0.39), 2: (0.40, 0.39)}), "1/3 seeds positive"),
    ("uda", _uda_rows({0: (0.40, 0.405), 1: (0.40, 0.405), 2: (0.40, 0.39)}), "mean margin +0.000"),
    ("d4", _d4_rows(quality_gates.D4_JAX["CPU"]), None),
    ("d4", _d4_rows(quality_gates.D4_JAX["TPU"]), None),
    ("d4", _d4_rows({0: (0.10, 0.60), 1: (0.441, 0.730)}), "task drifted: seed 0"),
    ("d4", _d4_rows({0: (0.413, 0.45), 1: (0.441, 0.48)}), "calibrated mean margin 0.05"),
])
def test_gate_conditions_are_the_jax_gates(check, rows, error):
    fn = getattr(quality_gates, f"check_{check}")
    if error is None:
        fn(rows)
    else:
        with pytest.raises(AssertionError, match=error.replace("+", r"\+")):
            fn(rows)
