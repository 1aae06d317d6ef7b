"""Device timing on one NVIDIA GPU, for the smoke test and the measurement
scripts."""

from __future__ import annotations

import torch


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events. The replay
    sends the captured launches back to back, so the host's share of a call
    (the Python wrapper, ctypes, allocation) is not in the number, only the
    kernels and the gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def event_ms(fn):
    """``(fn(), ms)``: one call between two CUDA events, host time included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)
