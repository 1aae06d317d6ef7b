"""Seconds from the process's start to the window's start: imports, CUDA
start-up, the kernels' library, the trainer, weights and batches, the
three checked steps and the warm-up epoch."""


def read(run):
    return run.setup_s
