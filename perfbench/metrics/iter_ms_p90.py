"""The 90th percentile of the iteration times of the window: the gaps
between the CUDA events recorded on the trainer's stream right after each
``train_step`` call (the first from the event after the last set-up
step), read after the window."""

import numpy as np


def read(run):
    return float(np.percentile(run.iter_ms, 90)) if len(run.iter_ms) >= 10 else None
