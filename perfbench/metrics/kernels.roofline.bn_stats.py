"""Sum of roofline bounds over sum of device times of the BN-statistics
kernels, forward and backward, at the level with the largest input among
set-up's recorded calls (every call whose input has the most elements), over
the traced slice, in per cent. For the U-Net that is the full-resolution
level of both domains, (bs, filters, crop, crop): (16, 32, 224, 224) for
MS-CMRSeg, (16, 32, 256, 256) for MM-WHS. Each launch's bound is the larger
of its bytes over HBM bandwidth and its operations over the f32 peak
(``counting.bn_stats_work``); at that level the input (bfloat16 or float32)
exceeds the 50 MB L2, so the bytes bound is a floor.

Set-up's first step records every call of the port's two BN-statistics
wrappers (``RECORD``) with its input's shape and dtype; each traced
iteration's BN-statistics kernels, in their order on the device, are paired
with that sequence by direction and dtype (``tracing.match_calls``), so
kernels replayed from a CUDA graph are read as eager ones are. Where an
iteration's kernels do not match it, the metric is not read, and standard
error says why."""

import math
import sys

from perfbench import counting, tracing

RECORD = ("pointcloududa_torch.ops.bn_kernel.stats_forward", "pointcloududa_torch.ops.bn_kernel.stats_backward")
_DIRECTION = dict(zip(RECORD, ("bn_fwd", "bn_bwd")))
_KERNELS = {"stats_forward_kernel": "bn_fwd", "stats_backward_kernel": "bn_bwd"}  # the program's kernel names
_BYTES = {"bfloat16": 2, "float32": 4}


def kernel_kind(name: str):
    """(direction, dtype) of a BN-statistics kernel's name, else ``None``."""
    for kernel, direction in _KERNELS.items():
        if kernel in name:
            return direction, "bfloat16" if "bfloat16" in name else "float32"
    return None


def calls(recorded: list) -> list:
    """``[((direction, dtype), shape)]`` of the recorded BN-statistics calls, in order."""
    out = []
    for name, args in recorded:
        if name in _DIRECTION:
            shape, dtype = args[0]
            out.append(((_DIRECTION[name], dtype), shape))
    return out


def level(seq: list) -> set:
    """The shapes of the calls in ``seq`` whose input has the most elements."""
    largest = max(math.prod(shape) for _, shape in seq)
    return {shape for _, shape in seq if math.prod(shape) == largest}


def read(run):
    seq = calls(run.recorded or [])
    if not run.trace or not seq:
        return None
    full = level(seq)
    bound, took, by = 0.0, 0.0, set()
    for i, kernels in enumerate(run.trace["iter_kernels"]):
        matched = tracing.match_calls(kernels, seq, kernel_kind)
        if isinstance(matched, str):
            print(f"kernels.roofline.bn_stats: traced iteration {i}: {matched}; not read", file=sys.stderr)
            return None
        for (direction, dtype), shape, ns in matched:
            if shape not in full:
                continue
            nbytes, ops = counting.bn_stats_work(shape, _BYTES[dtype], direction == "bn_bwd")
            t, which = counting.bound_s(nbytes, ops)
            bound, took = bound + t, took + ns / 1e9
            by.add(which)
    if took == 0.0:
        return None
    print(f"kernels.roofline.bn_stats: bound by {sorted(by)}", file=sys.stderr)
    return 100.0 * bound / took
