"""Host milliseconds an iteration inside the program's backward spans
(``uda.step.gen_backward``, ``uda.step.d<k>.backward``): autograd's share
of ``step.host_ms``, over the window's iterations that began with no
profiler recording; ``None`` where the program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils.timer import per_iteration_ms
    except ImportError:
        return None
    ms = per_iteration_ms()
    parts = [v for k, v in ms.items() if k.startswith("uda.step.") and k.endswith("backward")]
    return sum(parts) if parts else None
