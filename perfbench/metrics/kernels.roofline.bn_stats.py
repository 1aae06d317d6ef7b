"""Sum of roofline bounds over sum of device times of the BN-statistics
kernels, forward and backward, at the full-resolution level (batch x filters
x crop x crop) of both domains, over the traced slice, in per cent. Each
launch's bound is the larger of its bytes over HBM bandwidth and its
operations over the f32 peak (``counting.bn_stats_work``); at that level the
bf16 input exceeds the 50 MB L2, so the bytes bound is a floor."""

import sys

from perfbench import counting

_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if not run.trace:
        return None
    cfg = run.cfg
    full = f"{cfg.bs}x{cfg.filters}x{cfg.crop_size}x{cfg.crop_size}"
    bound, took, by = 0.0, 0.0, set()
    for span, kernel, ns in run.trace["kernel_times"]:
        parts = span.split(".")  # bench.kernel.bn_fwd.<shape>.<dtype>
        if len(parts) != 5 or parts[2] not in ("bn_fwd", "bn_bwd") or parts[3] != full:
            continue
        shape = tuple(int(d) for d in parts[3].split("x"))
        nbytes, ops = counting.bn_stats_work(shape, _BYTES[parts[4]], parts[2] == "bn_bwd")
        t, which = counting.bound_s(nbytes, ops)
        bound, took = bound + t, took + ns / 1e9
        by.add(which)
    if took == 0.0:
        return None
    print(f"kernels.roofline.bn_stats: bound by {sorted(by)}", file=sys.stderr)
    return 100.0 * bound / took
