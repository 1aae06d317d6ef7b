"""The benchmark's own spans and the reduction of a profiler trace.

``Probe`` wraps the trainer's ``pre_train`` and ``train_step`` attributes: a
host-clock span around each call, a CUDA event recorded on the trainer's
stream right after each step (read after the window), the step's metrics,
and, in a traced run, ``record_function`` ranges ``bench.preprocess`` and
``bench.step``. ``KernelSpans`` adds, in a traced run only, a range around
each call of the FPS wrapper, so its roofline knows the call's valid
candidates. ``BnCalls`` records, in set-up's first step (eager), the shape of
every BN-statistics call in order; a traced iteration's BN-statistics kernels
are matched to that sequence by their order on the device (``match_bn``), so
their work is known however they were launched.

``reduce_trace`` turns the raw profiler events of a slice of iterations into
the per-layer readings (``reduce_events``, a pure function of the event
list): device time by the span that launched it, the union of device
intervals (busy time), the launches, each iteration's BN-statistics kernels,
the largest device operations and the longest idle gaps with the host span
that was running meanwhile. A device operation replayed from a CUDA graph
carries the correlation id of the ``cudaGraphLaunch`` that ran the graph: it
is credited, like a kernel launched eagerly, to the range around that call,
and the graph's launch counts as one launch.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

from perfbench.correctness import COUNTERS

PRE, STEP = "bench.preprocess", "bench.step"
KERNEL_SPAN = "bench.kernel."
BN_KERNELS = {"stats_forward_kernel": "bn_fwd", "stats_backward_kernel": "bn_bwd"}  # the program's kernel names


def _swap(mod, name: str, make):
    """Put ``make(f)`` in place of ``mod.<name>`` (``f``), with its launch
    counters; returns what puts ``f`` back with the launches counted
    meanwhile (a wrapper's counter is the one the kernel's launch adds to)."""
    orig = getattr(mod, name)
    new = make(orig)
    for counter in COUNTERS:
        if hasattr(orig, counter):
            setattr(new, counter, getattr(orig, counter))
    setattr(mod, name, new)

    def put_back() -> None:
        for counter in COUNTERS:
            if hasattr(orig, counter):
                setattr(orig, counter, getattr(getattr(mod, name), counter))
        setattr(mod, name, orig)

    return put_back


class Probe:
    def __init__(self, trainer, annotate: bool, cuda: bool):
        self._pre, self._step = trainer.pre_train, trainer.train_step
        trainer.pre_train, trainer.train_step = self.pre, self.step
        self.annotate = annotate
        self.cuda = cuda
        self.pre_t: list = []
        self.step_t: list = []
        self.events: list = []
        self.metrics: list = []
        self.after_step = None  # callback(number of steps so far)

    def _span(self, name):
        return torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()

    def pre(self, *args, **kwargs):
        t0 = time.perf_counter()
        with self._span(PRE):
            out = self._pre(*args, **kwargs)
        self.pre_t.append((t0, time.perf_counter()))
        return out

    def step(self, state, batch):
        t0 = time.perf_counter()
        with self._span(STEP):
            state, metrics = self._step(state, batch)
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.step_t.append((t0, time.perf_counter()))
        self.metrics.append(metrics)
        if self.after_step is not None:
            self.after_step(len(self.step_t))
        return state, metrics


class KernelSpans:
    """A range around each call of the port's FPS wrapper
    (``bench.kernel.fps.<i>``), and each call's count of valid candidates (a
    device tensor, read after the window) and shape. ``restore`` puts the
    wrapper back."""

    def __init__(self):
        from pointcloududa_torch.ops import fps_kernel

        self.fps_valid: list = []
        self.fps_shapes: list = []

        def make(orig):
            def fps(valid, coords, starts, k):
                i = len(self.fps_valid)
                self.fps_valid.append(valid.sum())
                self.fps_shapes.append((valid.shape[0], valid.shape[1], k))
                with torch.profiler.record_function(f"{KERNEL_SPAN}fps.{i}"):
                    return orig(valid, coords, starts, k)
            return fps

        self.restore = _swap(fps_kernel, "fps", make)


class BnCalls:
    """While installed, ``calls`` gets ``(kind, shape, dtype)`` of each call
    of the port's BN-statistics wrappers, in order (kind ``bn_fwd`` or
    ``bn_bwd``, dtype ``bfloat16`` or ``float32``). ``restore`` puts the
    wrappers back."""

    def __init__(self):
        from pointcloududa_torch.ops import bn_kernel

        self.calls: list = []

        def recorded(kind):
            def make(orig):
                def call(x, *args):
                    self.calls.append((kind, tuple(x.shape), str(x.dtype).split(".")[-1]))
                    return orig(x, *args)
                return call
            return make

        self._put_back = [_swap(bn_kernel, "stats_forward", recorded("bn_fwd")),
                          _swap(bn_kernel, "stats_backward", recorded("bn_bwd"))]

    def restore(self) -> None:
        for put_back in reversed(self._put_back):
            put_back()


def bn_kind(kernel: str) -> str | None:
    """``bn_fwd`` / ``bn_bwd`` for a BN-statistics kernel's name, else ``None``."""
    for name, kind in BN_KERNELS.items():
        if name in kernel:
            return kind
    return None


def match_bn(kernels: list, calls: list):
    """Each of one iteration's BN-statistics kernels, ``[(name, ns)]`` in
    their order on the device, paired with set-up's call in the same place
    (``BnCalls.calls``): ``[(kind, shape, dtype, ns)]``; or, where the two
    sequences differ in length, direction or dtype, a string saying where."""
    if len(kernels) != len(calls):
        return f"{len(kernels)} BN-statistics kernels where set-up's step made {len(calls)} calls"
    out = []
    for j, ((name, ns), (kind, shape, dtype)) in enumerate(zip(kernels, calls)):
        seen = (bn_kind(name), "bfloat16" if "bfloat16" in name else "float32")
        if seen != (kind, dtype):
            return f"kernel {j} is {seen[0]} {seen[1]} where set-up's call {j} was {kind} {dtype}"
        out.append((kind, shape, dtype, ns))
    return out


def _events(prof) -> list:
    """(name, on_device, start_ns, end_ns, correlation, thread, annotation)
    of every raw event of a stopped ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dur = e.duration_ns()
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        annotation = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
        thread = e.start_thread_id() if hasattr(e, "start_thread_id") else 0
        out.append((e.name(), on_device, start, start + dur, e.correlation_id(), thread, annotation))
    return out


def _union(intervals) -> tuple:
    """(total covered ns, [gaps (start, end)]) of sorted (start, end) pairs."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _containing(spans, t):
    """The innermost (name, start, end) of ``spans`` containing ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best


def is_launch(name: str) -> bool:
    """A runtime or driver call that launches device work: a kernel
    (``cudaLaunchKernel*``, ``cuLaunchKernel*``) or a CUDA graph
    (``cudaGraphLaunch``, ``cuGraphLaunch``)."""
    return "LaunchKernel" in name or "cuLaunch" in name or "GraphLaunch" in name


def reduce_trace(prof, iterations: int) -> dict | None:
    """``reduce_events`` of a stopped ``torch.profiler.profile``."""
    return reduce_events(_events(prof), iterations)


def reduce_events(ev: list, iterations: int) -> dict | None:
    """Readings of the first ``iterations`` traced iterations of the events
    ``ev`` (as ``_events`` gives them): a slice from the start of the first
    ``bench.preprocess`` to the end of the last device operation launched by
    the last of those iterations' steps. Device time goes to the innermost
    ``bench.*`` range around the call that launched it, a kernel's or a
    graph's; ``bn_kernels`` holds each iteration's BN-statistics kernels in
    their order on the device. ``None`` where the trace holds no device
    operation."""
    spans = sorted((n, s, e) for n, dev, s, e, _, _, ann in ev if not dev and n in (PRE, STEP))
    pre = [sp for sp in spans if sp[0] == PRE]
    steps = [sp for sp in spans if sp[0] == STEP]
    if len(pre) < iterations or len(steps) < iterations:
        return None
    t0, last_step_end = pre[0][1], steps[iterations - 1][2]
    annotations = {n for n, dev, s, e, _, _, ann in ev if not dev and ann} | {PRE, STEP}
    launches = {c: (n, s) for n, dev, s, e, c, _, ann in ev if not dev and n.startswith("cu")}
    kernel_spans = [(n, s, e) for n, dev, s, e, _, _, _ in ev if not dev and n.startswith(KERNEL_SPAN)]
    ops, slice_end = [], t0
    for n, dev, s, e, c, _, _ in ev:
        if not dev or n in annotations or n.startswith("ProfilerStep"):
            continue
        launch = launches.get(c)
        if launch is None or not (t0 <= launch[1] <= last_step_end):
            continue
        ops.append((n, s, e, launch[1], is_launch(launch[0])))
        slice_end = max(slice_end, e)
    if not ops:
        return None
    busy, gaps = _union([(max(s, t0), min(e, slice_end)) for _, s, e, _, _ in ops if e > t0])
    by_span = {PRE: 0, STEP: 0}
    by_name: dict = {}
    kernel_times = []
    starts = [sp[1] for sp in pre[:iterations]]
    bn = [[] for _ in range(iterations)]
    for n, s, e, at, launched in ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if not launched:  # the feeder thread's copies are no layer's
            continue
        span = _containing(pre + steps, at)
        if span is not None:
            by_span[span[0]] += e - s
        span = _containing(kernel_spans, at)
        if span is not None:
            kernel_times.append((span[0], n, e - s))
        if bn_kind(n) is not None:
            bn[bisect.bisect_right(starts, at) - 1].append((s, n, e - s))
    n_launch = sum(1 for n, dev, s, e, _, _, _ in ev if not dev and is_launch(n) and t0 <= s <= last_step_end)
    labelled = []
    for gs, ge in gaps:
        span = _containing(pre + steps, (gs + ge) // 2)
        labelled.append((f"host in {span[0]}" if span else "host in the trainer's loop", ge - gs))
    window = slice_end - t0
    return {
        "iterations": iterations,
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "idle_share": 1.0 - busy / window,
        "preprocess_device_ms": by_span[PRE] / 1e6 / iterations,
        "step_device_ms": by_span[STEP] / 1e6 / iterations,
        "launches_per_iter": n_launch / iterations,
        "device_ops": [[n[:120], t / 1e9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, t / 1e9] for n, t in sorted(labelled, key=lambda kv: -kv[1])[:10]],
        "kernel_times": kernel_times,
        "bn_kernels": [[(n, ns) for _, n, ns in sorted(it)] for it in bn],
        "n_events": len(ev),
    }
