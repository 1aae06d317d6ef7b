"""Sum of roofline bounds over sum of device times of the FPS kernel over
the traced slice, in per cent; each launch's work is counted from the valid
candidates of the masks it was given (``counting.fps_work``). The kernel's
serial chain of k - 1 dependent rounds is not part of the bound."""

from perfbench import counting


def read(run):
    if not run.trace:
        return None
    bound, took = 0.0, 0.0
    for span, kernel, ns in run.trace["kernel_times"]:
        parts = span.split(".")  # bench.kernel.fps.<i>
        if len(parts) != 4 or parts[2] != "fps" or "fps" not in kernel:
            continue
        i = int(parts[3])
        b, p, k = run.fps_shapes[i]
        t, _ = counting.bound_s(*counting.fps_work(b, p, k, run.fps_valid[i]))
        bound, took = bound + t, took + ns / 1e9
    return 100.0 * bound / took if took else None
