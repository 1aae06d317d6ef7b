"""``tracing.reduce_events`` and the device-trace readers on fabricated
profiler events: work replayed from a CUDA graph is credited to the range
around the graph's launch and read as the same work launched one kernel at
a time, a graph's launch counts once, and the BN-statistics kernels of the
full-resolution level are found by their order, with no range around them."""

from types import SimpleNamespace

import pytest

from perfbench import counting, spec, tracing

PRE, STEP = tracing.PRE, tracing.STEP
FWD, BWD = "void stats_forward_kernel<__nv_bfloat16, 8>(...)", "void stats_backward_kernel<__nv_bfloat16, 8>(...)"
CFG = SimpleNamespace(bs=2, filters=4, crop_size=8)
FULL, HALF = (2, 4, 8, 8), (2, 8, 4, 4)
CALLS = [("bn_fwd", FULL, "bfloat16"), ("bn_fwd", HALF, "bfloat16"), ("bn_bwd", HALF, "bfloat16"),
         ("bn_bwd", FULL, "bfloat16")]
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


def bn_read(red, calls=CALLS):
    return spec.reader("kernels.roofline.bn_stats")(SimpleNamespace(trace=red, bn_calls=calls, cfg=CFG))


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
    assert red["bn_kernels"] == [[(n, ns) for n, ns in STEP_WORK if tracing.bn_kind(n)]] * 2
    assert bn_read(red) == pytest.approx(bn_expected())


def test_a_graph_launch_inside_the_step_is_credited_to_the_step_and_counted_once():
    eager, graphed = trace(graphed=False), trace(graphed=True)
    assert graphed["step_device_ms"] == pytest.approx(eager["step_device_ms"])
    assert graphed["preprocess_device_ms"] == pytest.approx(eager["preprocess_device_ms"])
    assert graphed["busy_s"] == pytest.approx(eager["busy_s"])
    assert graphed["launches_per_iter"] == 2  # the preprocess's kernel and the graph
    assert graphed["bn_kernels"] == eager["bn_kernels"]
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
    kernels = [(n, ns) for n, ns in STEP_WORK if tracing.bn_kind(n)]
    assert tracing.match_bn(kernels, CALLS) == [(k, s, d, ns) for (k, s, d), (_, ns) in zip(CALLS, kernels)]
    assert isinstance(tracing.match_bn(kernels[::-1], CALLS), str)
    assert tracing.bn_kind("fps_kernel") is None and tracing.bn_kind(FWD) == "bn_fwd"


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
