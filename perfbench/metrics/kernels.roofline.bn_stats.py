"""Sum of roofline bounds over sum of device times of the BN-statistics
kernels, forward and backward, at the full-resolution level (batch x filters
x crop x crop) of both domains, over the traced slice, in per cent. Each
launch's bound is the larger of its bytes over HBM bandwidth and its
operations over the f32 peak (``counting.bn_stats_work``); at that level the
input (bfloat16 or float32) exceeds the 50 MB L2, so the bytes bound is a floor.

A kernel's shape is that of set-up's first step's call in the same place:
each traced iteration's BN-statistics kernels, in their order on the device,
are matched to that sequence (``tracing.match_bn``), so kernels replayed from
a CUDA graph are read as eager ones are. Where an iteration's kernels do not
match it, the metric is not read, and standard error says why."""

import sys

from perfbench import counting, tracing

_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if not run.trace or not run.bn_calls:
        return None
    cfg = run.cfg
    full = (cfg.bs, cfg.filters, cfg.crop_size, cfg.crop_size)
    bound, took, by = 0.0, 0.0, set()
    for i, kernels in enumerate(run.trace["bn_kernels"]):
        matched = tracing.match_bn(kernels, run.bn_calls)
        if isinstance(matched, str):
            print(f"kernels.roofline.bn_stats: traced iteration {i}: {matched}; not read", file=sys.stderr)
            return None
        for kind, shape, dtype, ns in matched:
            if shape != full:
                continue
            nbytes, ops = counting.bn_stats_work(shape, _BYTES[dtype], kind == "bn_bwd")
            t, which = counting.bound_s(nbytes, ops)
            bound, took = bound + t, took + ns / 1e9
            by.add(which)
    if took == 0.0:
        return None
    print(f"kernels.roofline.bn_stats: bound by {sorted(by)}", file=sys.stderr)
    return 100.0 * bound / took
