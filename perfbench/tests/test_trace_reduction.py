"""``tracing.reduce_events`` and the device-trace readers on fabricated
profiler events: work replayed from a CUDA graph is credited to the range
around the graph's launch, the benchmark's and the innermost of the
program's, and read as the same work launched one kernel at a time, a
graph's launch counts once, and the BN-statistics kernels of the level with
the largest input are found by their order, with no range around them."""

from types import SimpleNamespace

import pytest

from perfbench import counting, spec, tracing

PRE, STEP = tracing.PRE, tracing.STEP
FWD, BWD = "void stats_forward_kernel<__nv_bfloat16, 8>(...)", "void stats_backward_kernel<__nv_bfloat16, 8>(...)"
CFG = SimpleNamespace(bs=2, filters=4, crop_size=8)
FULL, HALF = (2, 4, 8, 8), (2, 8, 4, 4)
CALLS = [("bn_fwd", FULL, "bfloat16"), ("bn_fwd", HALF, "bfloat16"), ("bn_bwd", HALF, "bfloat16"),
         ("bn_bwd", FULL, "bfloat16")]
BN = spec.reader_module("kernels.roofline.bn_stats")
FUNCTION = dict(zip(("bn_fwd", "bn_bwd"), BN.RECORD))
# what the BN-specific path of the parent tree read on these events (the same for eager and graphed)
PARENT_BN_READING = 0.780099502487562
# one iteration's device work in the step: (kernel, ns); the BN kernels in the order of CALLS
STEP_WORK = [("conv", 300), (FWD, 40), (FWD, 10), ("elementwise", 20), (BWD, 20), (BWD, 80)]


def host(name, start, end, corr=0, annotation=False):
    return (name, False, start, end, corr, 1, annotation)


def device(name, start, end, corr):
    return (name, True, start, end, corr, 7, False)


def iteration(t, corr, graphed, graph_outside=False):
    """Events of one iteration from ``t``: a preprocess range with one
    eager kernel, then a step range whose work (STEP_WORK) is launched
    eagerly or replayed from one graph (``graph_outside``: the graph's launch
    lies between the two ranges)."""
    ev = [host(PRE, t, t + 100, annotation=True), host("cudaLaunchKernel", t + 10, t + 12, corr),
          device("aug_kernel", t + 20, t + 50, corr), host(STEP, t + 200, t + 1000, annotation=True)]
    at, s = t + 210, t + 300
    if graphed:
        launch_at = t + 150 if graph_outside else at
        ev.append(host("cudaGraphLaunch", launch_at, launch_at + 5, corr + 1))
    for j, (name, ns) in enumerate(STEP_WORK):
        c = corr + 1 if graphed else corr + 1 + j
        if not graphed:
            ev.append(host("cudaLaunchKernel", at + 10 * j, at + 10 * j + 2, c))
        ev.append(device(name, s, s + ns, c))
        s += ns + 5
    return ev


def trace(graphed, iterations=2, **kw):
    ev = []
    for i in range(iterations):
        ev += iteration(2000 * i, 100 * i + 1, graphed, **kw)
    return tracing.reduce_events(ev, iterations)


def recorded(calls):
    """``tracing.Calls.calls`` of the BN wrappers' calls ``(direction, shape, dtype)``."""
    out = []
    for kind, shape, dtype in calls:
        channels = ((shape[1],), "float32")
        out.append((FUNCTION[kind], ((shape, dtype),) + ((channels, channels) if kind == "bn_bwd" else ())))
    return out


def bn_read(red, calls=CALLS):
    return BN.read(SimpleNamespace(trace=red, recorded=recorded(calls), cfg=CFG))


def bn_expected():
    bound = sum(counting.bound_s(*counting.bn_stats_work(FULL, 2, bwd))[0] for bwd in (False, True))
    return 100.0 * bound / ((40 + 80) / 1e9)


def test_the_eager_route_reads_as_before():
    red = trace(graphed=False)
    step_ns = sum(ns for _, ns in STEP_WORK)
    assert red["step_device_ms"] == pytest.approx(step_ns / 1e6)
    assert red["preprocess_device_ms"] == pytest.approx(30 / 1e6)
    assert red["launches_per_iter"] == 1 + len(STEP_WORK)
    # the slice: from the first preprocess to the end of the last device operation
    end = 2000 + 300 + step_ns + 5 * (len(STEP_WORK) - 1)
    assert red["window_s"] == pytest.approx(end / 1e9)
    assert red["busy_s"] == pytest.approx(2 * (30 + step_ns) / 1e9)
    assert red["iter_kernels"] == [[("aug_kernel", 30)] + STEP_WORK] * 2
    assert bn_read(red) == pytest.approx(bn_expected())


def test_a_graph_launch_inside_the_step_is_credited_to_the_step_and_counted_once():
    eager, graphed = trace(graphed=False), trace(graphed=True)
    assert graphed["step_device_ms"] == pytest.approx(eager["step_device_ms"])
    assert graphed["preprocess_device_ms"] == pytest.approx(eager["preprocess_device_ms"])
    assert graphed["busy_s"] == pytest.approx(eager["busy_s"])
    assert graphed["launches_per_iter"] == 2  # the preprocess's kernel and the graph
    assert graphed["iter_kernels"] == eager["iter_kernels"]
    assert bn_read(graphed) == pytest.approx(bn_read(eager))


def test_a_graph_launched_outside_every_range_is_no_layers():
    red = trace(graphed=True, graph_outside=True)
    assert red["step_device_ms"] == 0.0
    assert red["preprocess_device_ms"] == pytest.approx(30 / 1e6)
    assert red["launches_per_iter"] == 2
    assert red["busy_s"] == pytest.approx(trace(graphed=True)["busy_s"])


def test_the_bn_kernels_are_found_without_ranges_and_other_levels_left_out():
    red = trace(graphed=True)
    assert not red["kernel_times"]  # no bench.kernel.* range anywhere
    # only the full-resolution kernels count: at the other level the same
    # calls would read another share
    assert bn_read(red) == pytest.approx(bn_expected())
    swapped = [(k, HALF if s == FULL else FULL, d) for k, s, d in CALLS]
    assert bn_read(red, swapped) != pytest.approx(bn_expected())


@pytest.mark.parametrize("calls", [CALLS[:-1], CALLS + [CALLS[0]], CALLS[::-1],
                                   [(k, s, "float32") for k, s, _ in CALLS]],
                         ids=["fewer", "more", "directions", "dtype"])
def test_a_mismatched_bn_sequence_reads_nothing(calls, capsys):
    assert bn_read(trace(graphed=True), calls) is None
    assert "not read" in capsys.readouterr().err


def test_match_bn_pairs_shapes_in_device_order():
    seq = BN.calls(recorded(CALLS))
    assert seq == [((k, d), s) for k, s, d in CALLS]
    matched = tracing.match_calls(STEP_WORK, seq, BN.kernel_kind)
    bn_ns = [ns for n, ns in STEP_WORK if BN.kernel_kind(n)]
    assert matched == [(kind, s, ns) for (kind, s), ns in zip(seq, bn_ns)]
    assert isinstance(tracing.match_calls(STEP_WORK[::-1], seq, BN.kernel_kind), str)
    assert BN.kernel_kind("fps_kernel") is None and BN.kernel_kind(FWD) == ("bn_fwd", "bfloat16")


def test_the_generic_record_path_reads_what_the_bn_path_read():
    for graphed in (False, True):
        assert bn_read(trace(graphed=graphed)) == pytest.approx(PARENT_BN_READING, rel=1e-12)


def test_the_level_is_the_largest_recorded_input():
    seq = BN.calls(recorded(CALLS))
    assert BN.level(seq) == {FULL}
    bigger = (2, 4, 16, 16)  # a level with more elements than FULL takes its place
    calls = [(k, bigger if s == HALF else s, d) for k, s, d in CALLS]
    assert BN.level(BN.calls(recorded(calls))) == {bigger}
    assert bn_read(trace(graphed=True), calls) != pytest.approx(bn_expected())


@pytest.mark.parametrize("name,launch", [("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True),
                                         ("cuLaunchKernel", True), ("cudaGraphLaunch", True),
                                         ("cuGraphLaunch", True), ("cudaMemcpyAsync", False),
                                         ("cudaStreamSynchronize", False), ("cudaGraphInstantiate", False)])
def test_which_calls_launch(name, launch):
    assert tracing.is_launch(name) is launch


def test_no_device_operation_reads_nothing():
    ev = [host(PRE, 0, 10, annotation=True), host(STEP, 20, 30, annotation=True)]
    assert tracing.reduce_events(ev, 1) is None
    assert tracing.reduce_events(iteration(0, 1, False), 2) is None  # fewer iterations than asked


def program_spans(t, replay=False):
    """The program's ``uda.*`` ranges of the iteration from ``t``."""
    ev = [host("uda.iteration", t, t + 1100, annotation=True), host("uda.preprocess", t + 5, t + 60, annotation=True),
          host("uda.step", t + 205, t + 990, annotation=True),
          host("uda.step.gen_forward", t + 205, t + 235, annotation=True),
          host("uda.step.gen_backward", t + 236, t + 265, annotation=True)]
    if replay:
        ev.append(host("uda.step.disc_replay", t + 208, t + 214, annotation=True))
    return ev


def on_autograds_thread(ev, t):
    """The step's last two launches (+250, +260) made by another thread, as
    autograd's engine launches a backward's kernels."""
    return [(n, d, s, e, c, 9 if n == "cudaLaunchKernel" and s - t in (250, 260) else th, a)
            for n, d, s, e, c, th, a in ev]


@pytest.mark.parametrize("graphed,replay", [(False, False), (True, False), (True, True)],
                         ids=["eager", "graph-in-gen_forward", "graph-in-disc_replay"])
def test_device_time_goes_to_the_innermost_program_span(graphed, replay):
    ev = []
    for i in range(2):
        ev += on_autograds_thread(iteration(2000 * i, 100 * i + 1, graphed) + program_spans(2000 * i, replay), 2000 * i)
    red = tracing.reduce_events(ev, 2)
    step_ns = sum(ns for _, ns in STEP_WORK)
    if not graphed:  # launches at +210, +220, +230 lie in gen_forward, those at +240, +250, +260 in gen_backward
        want = {"uda.preprocess": 30, "uda.step.gen_forward": 350, "uda.step.gen_backward": step_ns - 350}
    else:  # the graph's launch at +210: every replayed kernel goes where it lies
        want = {"uda.preprocess": 30, "uda.step.disc_replay" if replay else "uda.step.gen_forward": step_ns}
    assert red["span_device_ms"] == pytest.approx({k: v / 1e6 for k, v in want.items()})
    # the benchmark's own readings do not move with the program's ranges
    plain = trace(graphed=graphed)
    for k in ("step_device_ms", "preprocess_device_ms", "launches_per_iter", "busy_s", "iter_kernels"):
        assert red[k] == plain[k]
    assert plain["span_device_ms"] == {}


def test_calls_record_in_order_and_a_missing_function_records_nothing():
    import torch

    from pointcloududa_torch.ops import bn_kernel

    before = bn_kernel.stats_forward
    calls = tracing.Calls(BN.RECORD + ("pointcloududa_torch.ops.bn_kernel.no_such_function",
                                      "pointcloududa_torch.no_such_module.f"))
    x = torch.ones(2, 3, 4, 4)
    try:
        mean, meansq = bn_kernel.stats_forward(x)
        bn_kernel.stats_backward(x, mean, meansq)
    finally:
        calls.restore()
    assert bn_kernel.stats_forward is before
    assert calls.calls == [(BN.RECORD[0], (((2, 3, 4, 4), "float32"),)),
                           (BN.RECORD[1], (((2, 3, 4, 4), "float32"), ((3,), "float32"), ((3,), "float32")))]
    assert BN.calls(calls.calls) == [(("bn_fwd", "float32"), (2, 3, 4, 4)), (("bn_bwd", "float32"), (2, 3, 4, 4))]
