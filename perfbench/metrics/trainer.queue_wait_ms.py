"""Host milliseconds an iteration the trainer's thread spends in the program's
``uda.queue_wait`` span: the wait on the prefetcher's queue (and the enqueue
of its stream's wait for the batch's copies), the time starved of batches,
the inside part of ``trainer.host_gap_ms``. Over the window's iterations that began with no
profiler recording; ``None`` where the program has no such span."""


def read(run):
    try:
        from pointcloududa_torch.utils.timer import per_iteration_ms
    except ImportError:
        return None
    return per_iteration_ms().get("uda.queue_wait")
