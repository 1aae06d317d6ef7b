"""The trainer's spans (``pointcloududa_torch/utils/timer.py``): host time
always, a ``record_function`` range only while a profiler records, the
totals kept apart for profiled and unprofiled iterations, the span tree
inside ``train_epoch`` (loop turn, prefetcher wait, preprocess stages, step
phases), and the per-epoch ``timing/`` scalars of ``fit``. Imports no JAX."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from pointcloududa_torch.config import mmwhs_default
from pointcloududa_torch.data.loader import DevicePrefetcher
from pointcloududa_torch.data.synthetic import synthetic_raw_batch
from pointcloududa_torch.train.loop import UDATrainer
from pointcloududa_torch.utils import timer

STEPS = 3
# every span of the eager step: the generator and three discriminators, MM-WHS light augmentation, clouds regenerated
CFG = dict(filters=4, crop_size=32, n_block=2, fc_inch=9, bs=2, ns=2 * STEPS, epochs=2, aug="light", softmax=True,
           d1=True, d2=True, d4=True, vert_t_every=1)
PARENT = {timer.QUEUE_WAIT: timer.ITERATION, timer.PREPROCESS: timer.ITERATION, timer.STEP: timer.ITERATION,
          **{name: timer.PREPROCESS for name in timer.PREPROCESS_PARTS},
          **{name: timer.STEP for name in timer.STEP_PARTS}}
# on the CPU both blocks of the step run eagerly: every span fires but those of their CUDA graphs
EAGER = set(timer.SPAN_NAMES) - set(timer.DISC_GRAPH) - set(timer.GEN_GRAPH)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (as ``test_torch_port_step.py``'s
    fixture of the name: the test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Batches:
    steps_per_epoch = STEPS

    def __init__(self, cfg):
        self.batches = [synthetic_raw_batch(cfg, cfg.bs, seed=s) for s in range(STEPS)]

    def epoch(self):
        return iter(self.batches)


def _trainer(tmp_path, val: bool = False):
    cfg = mmwhs_default(**CFG)
    vals = {}
    if val:
        raw = synthetic_raw_batch(cfg, cfg.bs, seed=7)
        one = lambda: iter([{"img": raw["img_s"], "mask": raw["mask_s"], "vert": raw["vert_s"]}])  # noqa: E731
        vals = {k: one for k in ("val", "val_lge", "test_lge")}
    return UDATrainer(cfg, Batches(cfg), vals, workdir=str(tmp_path / "w"), logdir=str(tmp_path / "r"), device="cpu")


@pytest.fixture(scope="module")
def profiled_epoch(tmp_path_factory):
    """The spans' ranges of one epoch under a CPU profiler, and the totals of
    an unprofiled epoch before it."""
    trainer = _trainer(tmp_path_factory.mktemp("spans"))
    trainer.train_epoch()
    unprofiled = (timer.span_totals(), timer.span_totals(profiled=True))
    with profile() as prof:
        trainer.train_epoch()
    profiled = (timer.span_totals(), timer.span_totals(profiled=True))
    trainer.writer.close()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("uda.")]
    return ranges, unprofiled, profiled


class _Opened:
    """Counts every ``record_function`` range opened (``torch.profiler``'s and
    ``torch.autograd.profiler``'s are one class)."""

    def __init__(self, monkeypatch):
        self.names = []
        enter = torch.autograd.profiler.record_function.__enter__

        def counted(rf):
            self.names.append(rf.name)
            return enter(rf)

        monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)


def test_the_flag_spans_read_is_the_one_profile_start_sets():
    """``torch.profiler.profile.start()`` sets
    ``torch.autograd.profiler._is_profiler_enabled``, and ``stop()`` clears it:
    the one check a span makes."""
    assert torch.profiler.record_function is torch.autograd.profiler.record_function
    assert torch.autograd.profiler._is_profiler_enabled is False
    prof = profile()
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled is True
    finally:
        prof.stop()
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("recording", [False, True])
def test_a_span_times_the_host_and_opens_a_range_only_while_a_profiler_records(recording, monkeypatch):
    opened = _Opened(monkeypatch)
    timer.reset_spans()
    span = timer.trace_annotation("probe.sleep")
    prof = profile()
    if recording:
        prof.start()
    try:
        for _ in range(2):  # one span object, entered again after it exits
            with span:
                time.sleep(0.01)
    finally:
        if recording:
            prof.stop()
    ns, calls = timer.span_totals(profiled=recording)["probe.sleep"]
    assert calls == 2 and 0.02 <= ns / 1e9 < 2.0
    assert "probe.sleep" not in timer.span_totals(profiled=not recording)
    assert opened.names == (["probe.sleep"] * 2 if recording else [])
    if recording:
        assert [e.name for e in prof.events() if e.name == "probe.sleep"] == ["probe.sleep"] * 2


def test_totals_follow_the_profiler_at_the_start_of_each_iteration():
    """A span inside an iteration adds to the side of the iteration's start,
    even where the profiler started or stopped meanwhile; a discarded span
    adds nothing; ``per_iteration_ms`` divides by that side's iterations."""
    timer.reset_spans()
    turn = timer.trace_annotation(timer.ITERATION, iteration=True)
    child = timer.trace_annotation(timer.STEP)
    prof = profile()
    with turn:  # unprofiled throughout
        with child:
            time.sleep(0.002)
    with turn:  # began unprofiled: the profiler starts inside it
        prof.start()
        with child:
            time.sleep(0.002)
    with turn:  # began profiled: the profiler stops inside it
        with child:
            pass
        prof.stop()
    with turn as dropped:
        dropped.discard()
    with child:  # outside an iteration: the side of its own start
        pass
    off, on = timer.span_totals(), timer.span_totals(profiled=True)
    assert off[timer.ITERATION][1] == 2 and off[timer.STEP][1] == 3
    assert on[timer.ITERATION][1] == 1 and on[timer.STEP][1] == 1
    ms = timer.per_iteration_ms()
    assert ms[timer.STEP] == pytest.approx(off[timer.STEP][0] / 2 / 1e6) and ms[timer.STEP] >= 2.0
    timer.reset_spans()
    assert timer.per_iteration_ms() == {} and timer.per_iteration_ms(profiled=True) == {}


@pytest.mark.parametrize("name", timer.SPAN_NAMES)
def test_a_span_name_is_no_launch_and_no_benchmark_range(name):
    """The benchmark's trace reduction takes names starting ``bench.``, ``cu``
    or ``ProfilerStep``, or holding ``LaunchKernel``, for its own ranges,
    launches and steps; every span is named under ``uda.``, its parent's name
    a prefix of its own."""
    assert name.startswith("uda.") and "LaunchKernel" not in name
    assert not name.startswith(("bench.", "cu", "ProfilerStep"))
    if name != timer.ITERATION:
        assert name.startswith(PARENT[name]) or PARENT[name] == timer.ITERATION


def test_an_unprofiled_epoch_opens_no_range(tmp_path, monkeypatch):
    """With no profiler recording, nothing of the trainer, the prefetcher, the
    preprocess or the step opens a ``record_function`` range, and every span
    is timed. (``torch.optim`` opens ranges of its own around each
    ``zero_grad`` and ``step``, always.)"""
    trainer = _trainer(tmp_path)
    opened = _Opened(monkeypatch)
    trainer.train_epoch()
    trainer.writer.close()
    assert opened.names and all(name.startswith("Optimizer.") for name in opened.names), opened.names
    assert set(timer.span_totals()) == EAGER and timer.span_totals(profiled=True) == {}


def test_the_profiler_sees_the_span_tree_nested(profiled_epoch):
    ranges, _, _ = profiled_epoch
    assert {name for name, _, _ in ranges} == EAGER
    by_name = {}
    for name, start, end in ranges:
        by_name.setdefault(name, []).append((start, end))
    # and the turn that found the stream's end, a range in the trace but no iteration in the totals
    assert len(by_name[timer.ITERATION]) == len(by_name[timer.QUEUE_WAIT]) == STEPS + 1
    assert len(by_name[timer.STEP]) == len(by_name[timer.PREPROCESS]) == STEPS
    for name, parent in PARENT.items():
        for start, end in by_name.get(name, ()):
            assert any(ps <= start and end <= pe for ps, pe in by_name[parent]), (name, parent)


def test_a_profiled_epoch_adds_to_the_profiled_side_only(profiled_epoch):
    _, (off_before, on_before), (off_after, on_after) = profiled_epoch
    assert on_before == {} and off_after == {}  # each train_epoch starts the totals afresh
    assert set(off_before) == set(on_after) == EAGER
    for totals in (off_before, on_after):
        assert totals[timer.ITERATION][1] == totals[timer.QUEUE_WAIT][1] == totals[timer.STEP][1] == STEPS
        assert totals["uda.step.gen_update"][1] == 2 * STEPS  # zero_grad before the backward, the update after it
        ns = {name: total[0] for name, total in totals.items()}
        for parent in (timer.ITERATION, timer.PREPROCESS, timer.STEP):
            assert sum(t for name, t in ns.items() if PARENT.get(name) == parent) <= ns[parent]


def test_the_queue_wait_counts_a_slow_feeder(monkeypatch):
    """A feeder that takes 20 ms a batch: the consumer waits about that long
    for each, and the wait's calls count the batches handed out (the end of
    the stream is none)."""
    timer.reset_spans()

    def place(item):
        time.sleep(0.02)
        return item

    out = list(DevicePrefetcher(place, depth=2, device="cpu")(iter(range(5))))
    assert out == list(range(5))
    ns, calls = timer.span_totals()[timer.QUEUE_WAIT]
    assert calls == 5 and 0.08 <= ns / 1e9 < 2.0


def test_fit_writes_the_spans_once_an_epoch_under_timing(tmp_path):
    """``fit`` logs each epoch's host ms an iteration of every span, from
    the iterations no profiler recorded, as ``timing/<span>`` beside
    ``train/`` and ``valid/``."""
    trainer = _trainer(tmp_path, val=True)
    trainer.fit()
    (path,) = [os.path.join(d, "metrics.jsonl") for d, _, files in os.walk(tmp_path / "r") if "metrics.jsonl" in files]
    with open(path) as f:
        records = [json.loads(line) for line in f]
    timing = [r for r in records if any(k.startswith("timing/") for k in r)]
    assert [r["step"] for r in timing] == [1, 2]
    for r in timing:
        ms = {k[len("timing/"):]: v for k, v in r.items() if k.startswith("timing/")}
        assert set(ms) == EAGER and set(r) == {"step", "time"} | {f"timing/{k}" for k in ms}
        assert all(np.isfinite(v) and v >= 0 for v in ms.values())
        backward = sum(v for k, v in ms.items() if k.endswith("backward"))
        update = sum(v for k, v in ms.items() if k.endswith("update"))
        assert 0 < backward + update <= ms[timer.STEP] <= ms[timer.ITERATION]
