"""The benchmark's own spans and the reduction of a profiler trace.

``Probe`` wraps the trainer's ``pre_train`` and ``train_step`` attributes: a
host-clock span around each call, a CUDA event recorded on the trainer's
stream right after each step (read after the window), the step's metrics,
and, in a traced run, ``record_function`` ranges ``bench.preprocess`` and
``bench.step``. ``KernelSpans`` adds, in a traced run only, a range around
each call of the FPS wrapper, so its roofline knows the call's valid
candidates. ``Calls`` records, in set-up's first step (eager), the argument
shapes of every call of the program's functions that the cell's readers name
(their ``RECORD``), in order; a reader pairs a traced iteration's kernels of
one kind with that sequence by their order on the device (``match_calls``),
so their work is known however they were launched.

``reduce_trace`` turns the raw profiler events of a slice of iterations into
the per-layer readings (``reduce_events``, a pure function of the event
list): device time by the benchmark's span that launched it and by the
innermost of the program's ``uda.*`` spans, the union of device intervals
(busy time), the launches, each iteration's kernels in device order, the
largest device operations and the longest idle gaps with the host span that
was running meanwhile. A device operation replayed from a CUDA graph
carries the correlation id of the ``cudaGraphLaunch`` that ran the graph: it
is credited, like a kernel launched eagerly, to the range around that call,
and the graph's launch counts as one launch.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time

import torch

from perfbench.correctness import COUNTERS

PRE, STEP = "bench.preprocess", "bench.step"
KERNEL_SPAN = "bench.kernel."
PROGRAM_SPAN = "uda."  # the program's own ranges (pointcloududa_torch/utils/timer.py)


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


class Calls:
    """While installed, ``calls`` gets ``(name, args)`` of each call of the
    program's functions ``names`` (dotted: ``package.module.function``), in
    order: ``args`` holds, for each positional argument, ``(shape, dtype)``
    of a tensor (``dtype`` as ``float32``, ``bfloat16``) or the value
    itself. A name the program lacks records nothing, so a reader whose
    kernel a later program drops reads nothing. ``restore`` puts the
    functions back."""

    def __init__(self, names):
        self.calls: list = []
        self._put_back = []
        for name in names:
            module, function = name.rsplit(".", 1)
            try:
                mod = importlib.import_module(module)
            except ImportError:
                continue
            if hasattr(mod, function):
                self._put_back.append(_swap(mod, function, self._recorded(name)))

    def _recorded(self, name):
        def make(orig):
            def call(*args, **kwargs):
                self.calls.append((name, tuple(_described(a) for a in args)))
                return orig(*args, **kwargs)
            return call
        return make

    def restore(self) -> None:
        for put_back in reversed(self._put_back):
            put_back()


def _described(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).split(".")[-1]
    return a


def match_calls(kernels: list, calls: list, kind_of):
    """One iteration's kernels of one kind, ``[(name, ns)]`` in their order on
    the device, each paired with set-up's call in the same place: ``calls``
    is ``[(kind, record)]`` in call order, ``kind_of(kernel name)`` the kind
    of a kernel (``None``: not one of these). ``[(kind, record, ns)]``; or,
    where the two sequences differ in length or kind, a string saying where."""
    seen = [(kind_of(name), ns) for name, ns in kernels]
    seen = [(kind, ns) for kind, ns in seen if kind is not None]
    if len(seen) != len(calls):
        return f"{len(seen)} kernels where set-up's step made {len(calls)} calls"
    out = []
    for j, ((got, ns), (want, record)) in enumerate(zip(seen, calls)):
        if got != want:
            return f"kernel {j} is {got} where set-up's call {j} was {want}"
        out.append((want, record, ns))
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


def _innermost(spans):
    """A function of ``t`` giving the name of the innermost of ``spans``
    (``(name, start, end)``, nested: the program opens its spans on one
    thread) that contains ``t``, or ``None``."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    starts = [s for _, s, _ in spans]

    def find(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:  # the latest-starting span that still contains t is the innermost
            name, _, e = spans[i]
            if e >= t:
                return name
            i -= 1
        return None

    return find


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
    graph's, and to the innermost ``uda.*`` range around it, whichever thread
    launched it (``span_device_ms``: ms an iteration by span, the time of an
    operation in a nested span counted in that span alone); ``iter_kernels``
    holds each iteration's launched device operations, ``(name, ns)`` in
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
    program_span = _innermost([(n, s, e) for n, dev, s, e, _, _, _ in ev if not dev and n.startswith(PROGRAM_SPAN)])
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
    by_program_span: dict = {}
    by_name: dict = {}
    kernel_times = []
    starts = [sp[1] for sp in pre[:iterations]]
    per_iter = [[] for _ in range(iterations)]
    for n, s, e, at, launched in ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if not launched:  # the feeder thread's copies are no layer's
            continue
        span = _containing(pre + steps, at)
        if span is not None:
            by_span[span[0]] += e - s
        span = program_span(at)
        if span is not None:
            by_program_span[span] = by_program_span.get(span, 0) + (e - s)
        span = _containing(kernel_spans, at)
        if span is not None:
            kernel_times.append((span[0], n, e - s))
        per_iter[bisect.bisect_right(starts, at) - 1].append((s, n, e - s))
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
        "span_device_ms": {n: t / 1e6 / iterations for n, t in sorted(by_program_span.items())},
        "kernel_times": kernel_times,
        "iter_kernels": [[(n, ns) for _, n, ns in sorted(it)] for it in per_iter],
        "n_events": len(ev),
    }
