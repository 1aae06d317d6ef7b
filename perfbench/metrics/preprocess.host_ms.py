"""Host milliseconds an iteration inside the program's ``uda.preprocess``
span: the host time of the device preprocess (augmentation, clouds,
normalise/crop/one-hot), beside ``preprocess.device_ms``. Over the window's
iterations that began with no profiler recording; ``None`` where the
program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils.timer import per_iteration_ms
    except ImportError:
        return None
    return per_iteration_ms().get("uda.preprocess")
