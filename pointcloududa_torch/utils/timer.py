"""Wall-clock instrumentation (counterpart of the JAX package's
``utils/timer.py``).

Equivalents of reference ``src/utils/timer.py``: a ``timeit`` decorator
(``timer.py:4-11``) and a projected-overrun guard (``TimeChecker``,
``timer.py:23-55``) used to stop before a cluster wall-clock limit, the
reference's only failure-detection mechanism (SURVEY.md §5). Adds
``trace_annotation``: a ``torch.profiler`` scope so steps show up named in
profiler traces (the reference has no profiler hooks at all).
"""

from __future__ import annotations

import functools
import time

import torch


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


def trace_annotation(name: str):
    """Named scope in ``torch.profiler`` traces (next to free when no
    profiler is recording)."""
    return torch.profiler.record_function(name)
