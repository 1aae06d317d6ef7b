"""The benchmark's own spans and the reduction of a profiler trace.

``Probe`` wraps the trainer's ``pre_train`` and ``train_step`` attributes: a
host-clock span around each call, a CUDA event recorded on the trainer's
stream right after each step (read after the window), the step's metrics,
and, in a traced run, ``record_function`` ranges ``bench.preprocess`` and
``bench.step``. ``kernel_spans`` adds, in a traced run only, a range around
each call of the BN-statistics and FPS wrappers that names the launch's
shape, so a roofline knows its work without reading the kernel's grid.

``reduce_trace`` turns the raw profiler events of a slice of iterations into
the per-layer readings: device time by the span that launched it, the union
of device intervals (busy time), the launches, the largest device operations
and the longest idle gaps with the host span that was running meanwhile.
"""

from __future__ import annotations

import contextlib
import time

import torch

PRE, STEP = "bench.preprocess", "bench.step"
KERNEL_SPAN = "bench.kernel."


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
    """Ranges around the port's BN-statistics and FPS wrappers, named by
    shape (``bench.kernel.bn_fwd.<N>x<C>x<H>x<W>.<dtype>``,
    ``bench.kernel.fps.<i>``), and each FPS call's count of valid
    candidates (a device tensor, read after the window). ``restore`` puts the
    wrappers back."""

    def __init__(self):
        from pointcloududa_torch.ops import bn_kernel, fps_kernel

        self._mods = (bn_kernel, fps_kernel)
        self._orig = {"stats_forward": bn_kernel.stats_forward, "stats_backward": bn_kernel.stats_backward,
                      "fps": fps_kernel.fps}
        self.fps_valid: list = []
        self.fps_shapes: list = []

        def named(kind, fn):
            def call(x, *args):
                shape = "x".join(str(d) for d in x.shape)
                with torch.profiler.record_function(f"{KERNEL_SPAN}{kind}.{shape}.{str(x.dtype).split('.')[-1]}"):
                    return fn(x, *args)
            call.launches = fn.launches
            call.bf16_launches = getattr(fn, "bf16_launches", 0)
            return call

        def fps(valid, coords, starts, k):
            i = len(self.fps_valid)
            self.fps_valid.append(valid.sum())
            self.fps_shapes.append((valid.shape[0], valid.shape[1], k))
            with torch.profiler.record_function(f"{KERNEL_SPAN}fps.{i}"):
                return self._orig["fps"](valid, coords, starts, k)

        fps.launches = self._orig["fps"].launches
        bn_kernel.stats_forward = named("bn_fwd", self._orig["stats_forward"])
        bn_kernel.stats_backward = named("bn_bwd", self._orig["stats_backward"])
        fps_kernel.fps = fps

    def restore(self) -> None:
        """Put the wrappers back, with the launches counted meanwhile."""
        bn_kernel, fps_kernel = self._mods
        for mod, name in ((bn_kernel, "stats_forward"), (bn_kernel, "stats_backward"), (fps_kernel, "fps")):
            orig = self._orig[name]
            for counter in ("launches", "bf16_launches"):
                if hasattr(orig, counter):
                    setattr(orig, counter, getattr(getattr(mod, name), counter))
            setattr(mod, name, orig)


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


def reduce_trace(prof, iterations: int) -> dict | None:
    """Readings of the first ``iterations`` traced iterations: a slice from
    the start of the first ``bench.preprocess`` to the end of the last
    device operation launched by the last of those iterations' steps.
    ``None`` where the trace holds no device operation."""
    ev = _events(prof)
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
        ops.append((n, s, e, launch[1], "LaunchKernel" in launch[0] or "cuLaunch" in launch[0]))
        slice_end = max(slice_end, e)
    if not ops:
        return None
    busy, gaps = _union([(max(s, t0), min(e, slice_end)) for _, s, e, _, _ in ops if e > t0])
    by_span = {PRE: 0, STEP: 0}
    by_name: dict = {}
    for n, s, e, at, is_kernel in ops:
        span = _containing(pre + steps, at) if is_kernel else None  # the feeder thread's copies are no layer's
        if span is not None:
            by_span[span[0]] += e - s
        by_name[n] = by_name.get(n, 0) + (e - s)
    kernel_times = []
    for n, s, e, at, is_kernel in ops:
        if is_kernel and ("stats_" in n or "fps" in n):  # the kernels that kernel_spans names
            span = _containing(kernel_spans, at)
            if span is not None:
                kernel_times.append((span[0], n, e - s))
    n_launch = sum(1 for n, dev, s, e, _, _, _ in ev
                   if not dev and ("LaunchKernel" in n or n.startswith("cuLaunch")) and t0 <= s <= last_step_end)
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
        "n_events": len(ev),
    }
