"""Share, in %, of the window's iterations that began with no profiler
recording whose generator phases (1-2 of the step) were replayed from their
CUDA graph: the calls of the program's ``uda.step.gen_replay`` span
(``pointcloududa_torch/utils/timer.py``) over those of ``uda.iteration``.
``None`` where the program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils import timer
    except ImportError:
        return None
    replay = getattr(timer, "GEN_REPLAY", None)
    if replay is None or replay not in timer.SPAN_NAMES:
        return None
    totals = timer.span_totals()
    iterations = totals.get(timer.ITERATION, (0, 0))[1]
    if not iterations:
        return None
    return 100.0 * totals.get(replay, (0, 0))[1] / iterations
