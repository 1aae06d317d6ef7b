"""1 - (union of the device operations' intervals) / the traced slice's
wall time, in per cent."""


def read(run):
    return 100.0 * run.trace["idle_share"] if run.trace else None
