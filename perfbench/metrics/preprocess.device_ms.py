"""Device milliseconds an iteration of the operations launched inside
``bench.preprocess`` (the device augmentation, cloud regeneration,
normalisation, crop and one-hot), over the traced slice: kernels launched
one at a time and those replayed from a CUDA graph alike."""


def read(run):
    return run.trace["preprocess_device_ms"] if run.trace else None
