"""The readers of the program's spans (``step.host_ms``,
``step.backward.host_ms``, ``step.update.host_ms``, ``preprocess.host_ms``,
``trainer.queue_wait_ms``) under one small traced run of the harness on the
CPU: each gives a number, from the window's iterations that began before the
profiler started, and the parts fit inside the step."""

import pytest

from perfbench import harness
from perfbench.tests.conftest import SHRINK, small_cell

READERS = ("step.host_ms", "step.backward.host_ms", "step.update.host_ms", "preprocess.host_ms", "trainer.queue_wait_ms")


@pytest.fixture(scope="module")
def traced_run():
    from pointcloududa_torch.utils import timer

    cell, raw_size = small_cell("mmwhs-d124.light-fps")
    out = harness.measure(cell, 11, 2.0, trace=True, device="cpu", shrink=SHRINK, raw_size=raw_size)
    return out["result"], timer.span_totals(), timer.span_totals(profiled=True)


def test_a_traced_run_reads_every_span_metric(traced_run):
    result, unprofiled, profiled = traced_run
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(metrics), sorted(metrics)
    assert all(result["metrics"][k]["unit"] == "ms" and metrics[k] >= 0 for k in READERS)
    assert 0 < metrics["step.backward.host_ms"] + metrics["step.update.host_ms"] <= metrics["step.host_ms"]
    # the profiler covered the window's second half: the readings come from the iterations before it
    n = unprofiled["uda.iteration"][1]
    assert n >= 1 and profiled["uda.iteration"][1] >= 2
    assert metrics["step.host_ms"] == pytest.approx(unprofiled["uda.step"][0] / n / 1e6)
    assert metrics["trainer.queue_wait_ms"] == pytest.approx(unprofiled["uda.queue_wait"][0] / n / 1e6)
