"""Host milliseconds an iteration inside the program's ``uda.step`` span
(``pointcloududa_torch/utils/timer.py``): the time the host takes to enqueue
the 5-phase step, beside ``step.device_ms``. Over the window's iterations
that began with no profiler recording (in a ``--trace 1`` run, those before
the traced slice); ``None`` where the program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils.timer import per_iteration_ms
    except ImportError:
        return None
    return per_iteration_ms().get("uda.step")
