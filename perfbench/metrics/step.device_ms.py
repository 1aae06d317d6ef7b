"""Device milliseconds an iteration of the operations launched inside
``bench.step`` (the 5-phase step, its backward passes and updates), over
the traced slice."""


def read(run):
    return run.trace["step_device_ms"] if run.trace else None
