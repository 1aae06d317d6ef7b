"""On the card (marker ``cuda``: skips without one; on the card: ``python -m
pytest perfbench/tests/test_card.py``): one short run of a cell, as its
command line runs it, and the trace's reduction of BN-statistics calls
replayed from a CUDA graph against the same calls launched eagerly."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(card, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mmwhs-d124.light-fps", "--seed",
                          str(3_000_000_000 + trace), "--seconds", "5", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def _profiled(body, iterations: int):
    """``body()`` run ``iterations`` times under the profiler, each inside a
    ``bench.step`` range after an empty ``bench.preprocess`` one, as a
    traced slice of the harness has them; the slice's reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import tracing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iterations):
            with record_function(tracing.PRE):
                pass
            with record_function(tracing.STEP):
                body()
        torch.cuda.synchronize()
    return tracing.reduce_trace(prof, iterations)


@pytest.mark.cuda
def test_a_graph_replay_reads_as_the_same_bn_calls_launched_eagerly(card):
    """The full-resolution forward and backward BN-statistics calls of the
    MS-CMRSeg configuration, captured into one CUDA graph and replayed: the
    replay's device time is credited to the range around it, its launch
    counts once, and ``kernels.roofline.bn_stats`` reads what it reads of
    the same calls launched one at a time (within 5%)."""
    from types import SimpleNamespace

    import torch

    from perfbench import harness, spec, tracing
    from pointcloududa_torch.ops import bn_kernel

    cfg = harness.configs(spec.resolve("mscmrseg-d124.aug2"), 1)[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((cfg.bs, cfg.filters, cfg.crop_size, cfg.crop_size), device="cuda", generator=g)
    x = x.to(getattr(torch, cfg.compute_dtype))  # the configuration's precision
    g_mean, g_meansq = torch.randn((2, cfg.filters), device="cuda", generator=g)

    def body():
        bn_kernel.stats_forward(x)
        bn_kernel.stats_backward(x, g_mean, g_meansq)

    bn = spec.reader_module("kernels.roofline.bn_stats")
    calls = tracing.Calls(bn.RECORD)
    body()  # eager, recorded: the sequence a set-up step gives the reader
    calls.restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()
    n = 20
    eager, replayed = _profiled(body, n), _profiled(graph.replay, n)
    shares = [bn.read(SimpleNamespace(trace=red, recorded=calls.calls, cfg=cfg)) for red in (eager, replayed)]
    assert None not in shares and abs(shares[1] / shares[0] - 1) < 0.05, shares
    assert 0 < shares[1] <= 105
    assert eager["launches_per_iter"] == 2 and replayed["launches_per_iter"] == 1
    bn_ms = sum(ns for it in replayed["iter_kernels"] for name, ns in it if bn.kernel_kind(name)) / 1e6 / n
    assert replayed["step_device_ms"] == pytest.approx(bn_ms, rel=1e-6) and bn_ms > 0
    assert abs(replayed["step_device_ms"] / eager["step_device_ms"] - 1) < 0.05
