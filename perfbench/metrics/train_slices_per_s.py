"""Slices a second: the batch size times the iterations completed in the
window, over the window's wall time (host clock), all the work over all the
time."""


def read(run):
    return run.bs * run.iterations / run.window_s if run.iterations else None
