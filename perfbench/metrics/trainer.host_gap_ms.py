"""Host milliseconds an iteration that the trainer's thread spends outside
``pre_train`` and ``train_step`` (waiting on the prefetcher's queue, and the
loop itself), from the benchmark's host-clock spans, over the window's
iterations before the traced slice."""


def read(run):
    gaps = run.host_gap_s
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
