"""Wall-clock instrumentation (counterpart of the JAX package's
``utils/timer.py``).

Equivalents of reference ``src/utils/timer.py``: a ``timeit`` decorator
(``timer.py:4-11``) and a projected-overrun guard (``TimeChecker``,
``timer.py:23-55``) used to stop before a cluster wall-clock limit, the
reference's only failure-detection mechanism (SURVEY.md §5).

Adds the trainer's spans (the reference has no profiler hooks at all):
``trace_annotation(name)`` times a block on the host clock, always, and
names it in ``torch.profiler`` traces while a profiler records. The totals
of the spans of the last ``train_epoch`` are read by ``per_iteration_ms``
(the trainer's ``timing/`` scalars, the benchmark's host-ms readers).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def timeit(func):
    """Print wall time per call (reference ``timer.py:4-11``)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        print(f"{func.__name__} time elapsed (s): {time.perf_counter() - start:.3f}")
        return result

    return wrapper


class TimeChecker:
    """Stop-before-deadline guard: remembers the slowest epoch and signals a
    stop when ``elapsed + slowest_epoch`` would exceed the budget,
    the adaptive variant the MM-WHS trainer inlines
    (``train_mmwhs.py:673-675``)."""

    def __init__(self, max_hours: float = 0, max_minutes: float = 0, max_seconds: float = 0):
        self.budget = 3600 * max_hours + 60 * max_minutes + max_seconds
        if self.budget <= 0:
            raise ValueError("max time duration should be greater than 0")
        self._start = time.perf_counter()
        self._last_check = None
        self._slowest = 0.0

    def start(self):
        self._start = time.perf_counter()
        self._last_check = None

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def check(self, toprint: bool = False) -> bool:
        now = time.perf_counter()
        if self._last_check is None:
            self._last_check = now
            return False
        self._slowest = max(now - self._last_check, self._slowest)
        self._last_check = now
        tobreak = (now - self._start) + self._slowest > self.budget
        if toprint or tobreak:
            print(f"time elapsed from start: {now - self._start:.1f}s")
        return tobreak


# the spans of one training iteration, nested as listed (a child's time is part of its parent's)
ITERATION = "uda.iteration"  # one turn of UDATrainer.train_epoch's loop
QUEUE_WAIT = "uda.queue_wait"  # DevicePrefetcher's consumer: the queue's get, the stream wait; its calls count batches
PREPROCESS = "uda.preprocess"  # make_device_preprocess's train transform
PREPROCESS_PARTS = ("uda.preprocess.augment", "uda.preprocess.clouds", "uda.preprocess.finish")
STEP = "uda.step"  # make_train_step's step
DISC_REPLAY = "uda.step.disc_replay"  # phases 3-5 from their CUDA graph: copies in, replay, copy out; calls = replays
DISC_CAPTURE = "uda.step.disc_capture"  # a capture of that graph; calls = captures
DISC_GRAPH = (DISC_REPLAY, DISC_CAPTURE)  # neither fires where phases 3-5 run eagerly (the CPU, a mesh)
GEN_REPLAY = "uda.step.gen_replay"  # phases 1-2 from their CUDA graph: copies in, replay, copy out; calls = replays
GEN_CAPTURE = "uda.step.gen_capture"  # a capture of that graph; calls = captures
GEN_GRAPH = (GEN_REPLAY, GEN_CAPTURE)  # neither fires where phases 1-2 run eagerly (the CPU, a mesh)
STEP_PARTS = ("uda.step.gen_forward", "uda.step.gen_backward", "uda.step.gen_update", "uda.step.metrics") + tuple(
    f"uda.step.d{k}.{part}" for k in (1, 2, 4) for part in ("forward", "backward", "update")) + DISC_GRAPH + GEN_GRAPH
SPAN_NAMES = (ITERATION, QUEUE_WAIT, PREPROCESS) + PREPROCESS_PARTS + (STEP,) + STEP_PARTS

# {profiler recording when the iteration began: {span name: [host ns, calls]}}; held by the module, as the
# profiler's own state is, so that fit and the benchmark's readers find it without a handle on the trainer
_totals: Dict[bool, Dict[str, list]] = {False: {}, True: {}}
_iteration_bucket: Optional[Dict[str, list]] = None  # the open iteration's totals


class trace_annotation:
    """A span: ``with trace_annotation(name):`` adds the block's host time
    (``time.perf_counter_ns``) to the totals under ``name``, and, only while
    a profiler records, opens a ``record_function`` range of the same name,
    which the trace puts beside the device operations launched inside it.
    Nothing is read from the device and nothing is synchronised.

    Totals are kept apart for iterations that began with a profiler
    recording and for those that did not: a span inside an iteration
    (``iteration=True``, the loop's turn) adds to that iteration's side, any
    other to the side of its own start. One object may be entered again
    after it exits (the port builds its spans once), not while it is open,
    and from one thread. ``discard()`` inside the block drops its time (a
    loop turn that found the stream's end)."""

    __slots__ = ("name", "iteration", "_t0", "_bucket", "_range", "_keep")

    def __init__(self, name: str, iteration: bool = False):
        self.name = name
        self.iteration = iteration
        self._range = None

    def __enter__(self):
        global _iteration_bucket
        # set by torch.profiler.profile.start() (and the legacy autograd profiler), cleared by stop()
        recording = _autograd_profiler._is_profiler_enabled
        if recording:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.iteration:
            _iteration_bucket = _totals[recording]
        self._bucket = _iteration_bucket if _iteration_bucket is not None else _totals[recording]
        self._keep = True
        self._t0 = time.perf_counter_ns()
        return self

    def discard(self) -> None:
        self._keep = False

    def __exit__(self, *exc):
        global _iteration_bucket
        ns = time.perf_counter_ns() - self._t0
        if self._keep:
            total = self._bucket.get(self.name)
            if total is None:
                self._bucket[self.name] = [ns, 1]
            else:
                total[0] += ns
                total[1] += 1
        if self.iteration:
            _iteration_bucket = None
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False


def reset_spans() -> None:
    """Start the totals afresh (``UDATrainer.train_epoch`` does, as it starts)."""
    for side in _totals.values():
        side.clear()


def span_totals(profiled: bool = False) -> Dict[str, tuple]:
    """``{name: (host ns, calls)}`` since ``reset_spans``, of the iterations
    that began with (``profiled``) or without a profiler recording."""
    return {name: tuple(total) for name, total in _totals[profiled].items()}


def per_iteration_ms(profiled: bool = False) -> Dict[str, float]:
    """Host milliseconds an iteration of each span since ``reset_spans``,
    over the iterations that began with (``profiled``) or without a
    profiler recording; ``{}`` where no such iteration ran."""
    side = _totals[profiled]
    n = side.get(ITERATION, (0, 0))[1]
    if not n:
        return {}
    return {name: ns / n / 1e6 for name, (ns, _) in side.items()}
