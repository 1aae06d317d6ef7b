"""One run of one cell: set-up, the measured window through
``UDATrainer.train_epoch``, the readings, and the check against the plain
reference.

Set-up (counted in ``setup_s``, from the process's start), in the stages
that ``Stages`` times and the run prints on standard error: imports and CUDA
start-up (``imports_cuda``), the kernels' library (``library``: built in the
checkout's ``build/`` on a first run, loaded on later ones), the raw batches
made from the seed (``batches``), the trainer built from the cell's
configuration through ``cli/common.py:with_kernels`` and the weights made
from the seed (``trainer_weights``), the first three steps, which the check
reads (``checked_steps``), and a warm-up epoch (``warmup``). The window
starts when ``train_epoch`` is called and ends when it returns
(``_fetch_means`` reads the metrics back, which synchronises). With
``--trace 1`` the profiler covers a slice of the window and the run reports
the per-layer metrics.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import correctness, counting, spec, tracing
from perfbench.feed import Feed, make_pool
from perfbench.weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloududa_tpu")
TRACE_START = 0.5  # of --seconds: the traced slice starts once this share of the window has passed


def _overrides(cell: spec.Cell, seed: int, shrink: dict | None) -> dict:
    return {**cell.config["uda_config"], **cell.traffic.get("uda_config", {}), "seed": int(seed), **(shrink or {})}


def reference_config(cell: spec.Cell, seed: int, shrink: dict | None = None):
    """The reference's UDAConfig from the cell's configuration and traffic
    files (an ``arch`` with no file under ``reference/arch/`` raises here)."""
    from perfbench.reference import config as ref_config

    return getattr(ref_config, cell.config["defaults"])(**_overrides(cell, seed, shrink))


def configs(cell: spec.Cell, seed: int, shrink: dict | None = None):
    """(the port's UDAConfig with the kernels selected, the reference's
    UDAConfig) from the cell's configuration and traffic files."""
    from pointcloududa_torch import config as port_config
    from pointcloududa_torch.cli.common import with_kernels

    ref_cfg = reference_config(cell, seed, shrink)
    return with_kernels(getattr(port_config, cell.config["defaults"])(**_overrides(cell, seed, shrink))), ref_cfg


class Stages:
    """Seconds of each stage of set-up: ``mark(name)`` closes the stage
    running since the last mark (or ``t0``), the clock read after the
    device has finished what it was given."""

    def __init__(self, t0: float, device):
        self.device = torch.device(device)
        self.last = t0
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _load(models, weights: dict) -> None:
    for net, module in zip(correctness.NETS, models):
        if module is not None:
            module.load_state_dict(weights[net])


def _iteration_ms(anchor, events) -> list:
    out, prev = [], anchor
    for ev in events:
        out.append(prev.elapsed_time(ev))
        prev = ev
    return out


def first_steps(cell: spec.Cell, seed: int, device, shrink: dict | None = None,
                raw_size: int | None = None, fault=None, tf32: bool = False, stages: Stages | None = None) -> dict:
    """Build the trainer from the cell's files, load the weights made from
    the seed, and run its first three steps through ``train_epoch`` and the
    feed, reading what the check compares (``prog``, and ``stage``: what
    ``correctness.Recorder`` kept of the first step) and the first step's
    calls of the program's functions that the cell's readers name, in order
    (``recorded``: ``tracing.Calls``; eager: no graph replays a first step).

    Float32 work runs in float32, as the configuration states (PyTorch's
    default would run cuDNN's float32 convolutions, the classifier's among
    them, in TF32); ``tf32`` switches TF32 on for convolutions and matmuls
    (``calibrate.py``'s control: the program's own path one precision lower)."""
    from pointcloududa_torch.train.loop import UDATrainer

    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    device = torch.device(device)
    cfg, ref_cfg = configs(cell, seed, shrink)
    shape = dict(workload=cfg.workload, bs=cfg.bs, raw_size=raw_size or cell.config["raw_size"],
                 channels=cfg.in_channels, n_class=cfg.n_class, points=300)
    mark = stages.mark if stages is not None else (lambda name: None)
    pool = make_pool(shape, cell.traffic, seed)
    feed = Feed(pool)
    mark("batches")
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
    trainer = UDATrainer(cfg, feed, {}, workdir=os.path.join(tmp.name, "w"), logdir=os.path.join(tmp.name, "r"),
                         device=device)
    weights = make_weights(ref_cfg, seed, device)
    _load(trainer.state.models, weights)
    mark("trainer_weights")
    if fault is not None:
        fault(trainer)
    probe = tracing.Probe(trainer, annotate=False, cuda=device.type == "cuda")
    recorder = correctness.Recorder(trainer)
    recorded = tracing.Calls(spec.recorded_functions(cell))
    feed.limit = 1
    trainer.train_epoch()
    recorded.restore()
    stage = recorder.take()
    grads = correctness.grad_norms(trainer.state.models, trainer.state.optimizers)
    feed.limit = correctness.STEPS - 1
    trainer.train_epoch()
    prog = correctness.to_host({"losses": correctness.losses_of(probe.metrics[:correctness.STEPS]), "grads": grads,
                                "changes": correctness.change_norms(trainer.state.models, weights)})
    mark("checked_steps")
    return dict(cfg=cfg, ref_cfg=ref_cfg, pool=pool, feed=feed, trainer=trainer, probe=probe, tmp=tmp, prog=prog,
                stage=stage, recorded=recorded.calls)


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: float | None = None,
            shrink: dict | None = None, raw_size: int | None = None, fault=None) -> dict:
    """Run the cell once; returns ``{"result": <the last line's object>,
    "program", "reference": <the readings compared>, "iter_ms", "trace",
    "power_limit", "setup_stages", "span_calls": <the calls of each of the
    program's spans in the window's untraced iterations>}``.
    ``shrink``/``raw_size``: a smaller configuration (the CPU tests);
    ``fault(trainer)``: breaks the timed path under the harness (the tests
    of the check)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic = cell.traffic
    stages = Stages(t0, device)
    from pointcloududa_torch.train import loop  # noqa: F401  (the program's imports belong to this stage)
    from pointcloududa_torch.utils import timer

    torch.empty(1, device=device)  # the CUDA context
    stages.mark("imports_cuda")
    if on_card:
        from pointcloududa_torch.utils import native

        native.load()
    stages.mark("library")
    built = first_steps(cell, seed, device, shrink, raw_size, fault, stages=stages)
    cfg, ref_cfg, pool, feed, trainer, probe, tmp, prog, stage = (
        built[k] for k in ("cfg", "ref_cfg", "pool", "feed", "trainer", "probe", "tmp", "prog", "stage"))
    feed.limit = int(traffic["warmup_iters"])
    trainer.train_epoch()
    spans, prof = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
    stages.mark("warmup")
    setup_s = time.perf_counter() - t0

    # ---- the window ------------------------------------------------------
    n0 = len(probe.step_t)
    anchor = probe.events[-1] if on_card else None
    traced = {"from": None, "iters": int(traffic["trace_iters"])}
    feed.limit = None
    w0 = time.perf_counter()
    feed.deadline = w0 + seconds

    def after_step(n: int) -> None:
        nonlocal spans
        if traced["from"] is None and time.perf_counter() - w0 >= TRACE_START * seconds:
            # the window runs as an untraced one up to here: no spans, no profiler
            traced["from"] = n - n0
            spans = tracing.KernelSpans()
            probe.annotate = True
            prof.start()
        elif traced["from"] is not None and n - n0 - traced["from"] >= traced["iters"]:
            feed.stop = True

    if trace:
        probe.after_step = after_step
    trainer.train_epoch()
    w1 = time.perf_counter()
    probe.after_step = None
    window_s = w1 - w0
    iters = len(probe.step_t) - n0
    span_calls = {name: calls for name, (_, calls) in timer.span_totals().items()}
    iter_ms = _iteration_ms(anchor, probe.events[n0:]) if on_card else \
        [1e3 * (b[1] - a[1]) for a, b in zip(probe.step_t[n0 - 1:], probe.step_t[n0:])]
    totals = torch.stack([m["gen_total_loss"].float() for m in probe.metrics[n0:]]).cpu()
    failed = int((~torch.isfinite(totals)).sum())
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    host_gaps = [b[0] - a[1] for a, b in zip(probe.step_t[n0:], probe.pre_t[n0 + 1:])]

    red, fps_valid = None, []
    if trace:
        if traced["from"] is not None:
            prof.stop()
            red = tracing.reduce_trace(prof, traced["iters"]) if on_card else None
        if spans is not None:
            fps_valid = [float(v) for v in torch.stack(spans.fps_valid).cpu()] if spans.fps_valid else []
            spans.restore()
    untraced = traced["from"] if traced["from"] is not None else iters
    run = SimpleNamespace(
        cfg=cfg, bs=cfg.bs, iterations=iters, window_s=window_s, setup_s=setup_s, iter_ms=iter_ms,
        untraced_iter_ms=iter_ms[1:untraced] if untraced > 2 else [], host_gap_s=host_gaps[:max(untraced - 1, 0)],
        trace=red, recorded=built["recorded"],
        fps_valid=fps_valid, fps_shapes=spans.fps_shapes if spans else [], step_flops=counting.step_flops(ref_cfg),
        on_card=on_card,
    )
    readings = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            readings[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the program's state goes; the reference follows the first steps --
    trainer.writer.close()
    del trainer, probe, prof, spans, run, totals, built
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref, ref_stage = correctness.reference_readings(ref_cfg, make_weights(ref_cfg, seed, device),
                                                    pool[:correctness.STEPS], device)
    numbers = correctness.check_numbers(prog, stage, ref, ref_stage, device, calls=stage["calls"])
    del ref_stage, stage
    numbers["failed_iters"] = float(failed)
    limits = {**{k: cell.limits[k] for k in correctness.CHECKS}, "failed_iters": 0.0}
    correct = correctness.judge(numbers, cell.limits) and failed == 0
    tmp.cleanup()

    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": 1, "memory_peak_bytes": memory_peak}
    if trace and red is not None:
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
    result = {"correct": bool(correct), "attempted": iters, "failed": failed, "metrics": readings, "device": device_info}
    if red is not None:
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return {"result": result, "program": prog, "reference": ref, "iter_ms": iter_ms, "trace": red,
            "power_limit": power_limit(device) if on_card else None, "setup_stages": stages.seconds,
            "span_calls": span_calls}


def iteration_summary(ms: list) -> dict:
    """The window's iteration times in brief: how many, the median and
    quartiles, the mean of each tenth of the window in order, and the five
    slowest with their place (whether a run's spread is a few slow
    iterations or a whole-run offset)."""
    if not ms:
        return {"n": 0}
    arr = np.asarray(ms)
    slowest = np.argsort(arr)[::-1][:5]
    return {"n": len(ms), "median": float(np.median(arr)),
            "quartiles": [float(q) for q in np.percentile(arr, [25, 75])],
            "tenths": [float(np.mean(part)) for part in np.array_split(arr, 10)] if len(ms) >= 10 else [],
            "slowest": [[int(i), float(arr[i])] for i in slowest]}


def power_limit(device) -> str:
    from pointcloududa_torch.utils.device import describe

    return describe(device)


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.resolve(args.workload)
    except spec.UnknownName as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), {n} visible; no result", file=sys.stderr)
        return 3
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=t0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}; no result", file=sys.stderr)
        return 4
    res = out["result"]
    ms = out["iter_ms"]
    print(json.dumps({"iter_ms": iteration_summary(ms), "setup_stages": out["setup_stages"],
                      "span_calls": out["span_calls"],
                      "card": out["power_limit"], "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                      "trace": {k: v for k, v in (out["trace"] or {}).items()
                                if k not in ("device_ops", "idle_gaps", "kernel_times", "iter_kernels")}
                      if out["trace"] else None}, default=str))
    print(json.dumps({"program": out["program"], "reference": out["reference"]}), file=sys.stderr)
    print("setup stages (s): " + ", ".join(f"{k} {v!r}" for k, v in out["setup_stages"].items()), file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
