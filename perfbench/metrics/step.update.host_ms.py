"""Host milliseconds an iteration inside the program's update spans
(``uda.step.gen_update``, ``uda.step.d<k>.update``: ``zero_grad``, the
gradients' averaging and the optimisers' steps): the optimisers' share of
``step.host_ms``, over the window's iterations that began with no profiler
recording; ``None`` where the program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils.timer import per_iteration_ms
    except ImportError:
        return None
    ms = per_iteration_ms()
    parts = [v for k, v in ms.items() if k.startswith("uda.step.") and k.endswith("update")]
    return sum(parts) if parts else None
