"""Device milliseconds an iteration of the operations launched inside
``bench.step`` (the 5-phase step, its backward passes and updates), over
the traced slice: kernels launched one at a time and those replayed from a
CUDA graph whose launch lies inside the range alike."""


def read(run):
    return run.trace["step_device_ms"] if run.trace else None
