"""The check's two witnesses, at a small size on the CPU: the control (the
reference one precision lower in the program's place) and the faults a
training cell can have, planted under a whole run of the harness (a state
left unchanged, half of the batch left out, a kernel's answer altered where
it is produced), each come out as not correct; a sound run comes out
correct."""

import pytest

from perfbench import correctness, harness
from perfbench.tests.conftest import SHRINK, small_cell
from perfbench.weights import make_weights

CELLS = ["mscmrseg-d124.aug2", "mmwhs-d124.light-fps"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(name, seed):
    """The reference one precision lower in the program's place: TF32
    operands in the whole step (the configuration's float32, TF32 off), and
    the plain kernels one precision lower on the arguments the program's
    first step gave its kernels."""
    cell, raw_size = small_cell(name)
    built = harness.first_steps(cell, seed, "cpu", shrink=SHRINK, raw_size=raw_size)
    built["trainer"].writer.close()
    built["tmp"].cleanup()
    ref_cfg, raws, calls = built["ref_cfg"], built["pool"][:3], built["stage"]["calls"]
    w = make_weights(ref_cfg, seed, "cpu")
    ref, ref_stage = correctness.reference_readings(ref_cfg, w, raws, "cpu")
    step_round, kernel_round = correctness.control_rounding(ref_cfg.compute_dtype)
    control, c_stage = correctness.reference_readings(ref_cfg, w, raws, "cpu", operand_round=step_round)
    numbers = correctness.check_numbers(control, c_stage, ref, ref_stage, "cpu", calls=calls, lower=kernel_round)
    assert not correctness.judge(numbers, cell.limits), numbers


def _unchanged(trainer):
    for opt in trainer.state.optimizers:
        if opt is not None:
            opt.step = lambda *a, **k: None


def _half_batch(trainer):
    step = trainer.train_step
    trainer.train_step = lambda state, batch: step(state, correctness.half_batch(batch))


ALTERED = {  # a kernel wrapper's answer altered where it is produced
    "fps_cloud_altered": ("fps_kernel", "fps", lambda clouds: clouds + 1.0),
    "chamfer_parts_altered": ("chamfer_kernel", "forward_fused", lambda out: (out[0] * 1.001, *out[1:])),
    "chamfer_grad_altered": ("chamfer_kernel", "side_grad", lambda da: da * 1.001),
    "bn_mean_altered": ("bn_kernel", "stats_forward", lambda out: (out[0] + 1e-3, out[1])),
    "bn_grad_altered": ("bn_kernel", "stats_backward", lambda dx: dx * 1.01),
}
FAULTS = {"sound": None, "state_unchanged": _unchanged, "half_batch": _half_batch, **dict.fromkeys(ALTERED)}
CASES = [(c, f) for c in CELLS for f in FAULTS if f != "fps_cloud_altered" or "fps" in c]


def _alter(monkeypatch, module: str, name: str, alter) -> None:
    from pointcloududa_torch.ops import bn_kernel, chamfer_kernel, fps_kernel

    mod = {"bn_kernel": bn_kernel, "chamfer_kernel": chamfer_kernel, "fps_kernel": fps_kernel}[module]
    fn = getattr(mod, name)

    def wrong(*args):
        return alter(fn(*args))

    for counter in ("launches", "bf16_launches"):
        setattr(wrong, counter, getattr(fn, counter, 0))
    monkeypatch.setattr(mod, name, wrong)


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell, raw_size = small_cell(name)
    plant = FAULTS[fault]
    if fault in ALTERED:
        plant = lambda trainer: _alter(monkeypatch, *ALTERED[fault])  # noqa: E731
    out = harness.measure(cell, 5, 0.5, trace=False, device="cpu", shrink=SHRINK, raw_size=raw_size, fault=plant)
    assert out["result"]["correct"] is (fault == "sound"), out["result"]["checks"]
    assert list(out["result"])[-1] == "checks"
