"""Launch calls the host makes an iteration in the traced slice: runtime or
driver calls that launch a kernel, and those that launch a CUDA graph, each
graph launch counted once however many kernels it runs (a lower bound: the
profiler can lose events)."""


def read(run):
    return run.trace["launches_per_iter"] if run.trace else None
