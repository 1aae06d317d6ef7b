"""Blocks of the train step replayed from CUDA graphs.

The step's two blocks are a few thousand small kernels each: phases 1-2 (the
generator's forward on source and target, its losses, phase 2's pass through
D1, D2 and D4, and the backward to the generator's gradients) and phases 3-5
(``step.discriminator_phase`` for D1, D2 and D4: forward, backward and update
on the generator's detached outputs). Launched one at a time from Python they
cost the host tens of milliseconds a step. :class:`StepGraphs` captures a
block once and replays it: the block's inputs are copied into tensors the
graph owns, one graph launch runs it, its metrics come out in one copy, and
its other outputs are tensors the graph owns, which the next replay
rewrites. The generator's update (Adam or SGD) runs eagerly after phases
1-2: a captured Adam would need ``capturable=True``, whose bias correction on
the device is not the eager arithmetic, and the decayed lr
(``set_generator_lr``) takes effect with no new capture.

Whether a block engages depends only on what the step observes: the models
on a CUDA device, no data mesh (``average_grads`` would all-reduce), anomaly
mode off (``-debug_nans`` checks on the host). A graph is keyed by the
inputs' names, shapes and dtypes (a tail's ``sample_mask`` and the cadence's
``vert_t`` among them) and by the hyper-parameters of the optimisers the
block updates, which the graph holds as constants (phases 3-5: every
discriminator's; phases 1-2 update nothing). The first step with a key runs
eagerly: it makes the SGD momentum buffers and picks cuDNN's plans. The
second captures the block and replays it, and later ones replay it. A replay
first checks that the tensors the block reads or writes in place (the
parameters and buffers of the networks it runs, BatchNorm's running
statistics among them, and the momentum buffers of the optimisers it
updates) and the dropout generator are the objects captured, at the same
addresses; a restored optimiser (``opt.load_state_dict``) replaces the
buffers, and the block is captured again. Everything else runs the block
eagerly.

The graph runs the eager block's arithmetic: the same kernels on the same
tensors, torch's float32 SGD, the BatchNorm statistics in the same order,
and dropout drawn from the step's generator, which is registered with both
graphs, so the masks, and the generator's state after K replays, are those of
K eager steps. A block sets each gradient it takes anew
(``zero_grad(set_to_none=True)``) and never reads an older one, so an eager
step in between (a padded tail batch) that left other ``.grad`` tensors needs
no new capture: they are pointed back at the graph's before a replay. No
autograd graph may outlive a block: a capture makes its own nodes on the
capture's stream (an older gradient accumulator would synchronise with the
stream it was made on). A block's live graphs share one memory pool: they
replay one at a time on one stream, and a graph's outputs are read before
another of the block's graphs replays, so a capture may take what another's
temporaries held. A capture that finds none of the block's graphs alive
starts a pool of its own (torch captures into no pool that its graphs have
all left). A replay calls no kernel wrapper, so the
hand-written kernels' launch counters (``<wrapper>.launches``) see only the
block's eager and captured calls; a trace of the card sees what a replay
launches.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from pointcloududa_torch.parallel import collectives
from pointcloududa_torch.utils.timer import trace_annotation

Tensors = Dict[str, torch.Tensor]
def graph_key(inputs: Tensors, optimizers) -> tuple:
    """What a captured block is valid for: the inputs' names, shapes and
    dtypes, and each optimiser's hyper-parameters (lr, momentum, weight
    decay, ...)."""
    return (tuple((name, tuple(x.shape), x.dtype) for name, x in inputs.items()),
            tuple(tuple(sorted((k, v) for k, v in group.items() if k != "params"))
                  for opt in optimizers for group in opt.param_groups))


def _in_place(models, optimizers) -> list:
    """The tensors a captured block reads or writes in place: the networks'
    parameters and buffers, and the optimisers' momentum buffers."""
    out = [t for m in models for t in (*m.parameters(), *m.buffers())]
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                buf = opt.state[p].get("momentum_buffer") if p in opt.state else None
                if buf is not None:
                    out.append(buf)
    return out


class CudaGraph:
    """``body()`` captured into one CUDA graph, ``generator``'s draws among
    it, its memory from ``pool`` (``None``: a pool of its own), which
    ``self.pool`` names; ``replay()`` runs the graph and returns the tensor
    ``body`` returned, which each replay rewrites."""

    def __init__(self, body: Callable[[], torch.Tensor], generator: torch.Generator, pool=None):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.register_generator_state(generator)
        # garbage in reference cycles (a dropped trainer's graphs, events, streams) is freed now: freed by the
        # collector during the capture, it would invalidate it (torch no longer collects before a capture)
        gc.collect()
        # thread_local: the prefetcher's thread copies and allocates on its own stream during the capture
        with torch.cuda.graph(self._graph, pool=pool, capture_error_mode="thread_local"):
            self._out = body()
        self.pool = self._graph.pool()

    def replay(self) -> torch.Tensor:
        self._graph.replay()
        return self._out


class _Captured:
    """One capture of the block: its own inputs, the graph, its outputs, and
    what a replay checks and restores."""

    def __init__(self, block, inputs, generator, in_place: Callable[[], list], params, make_graph, pool):
        self.inputs = {name: x.detach().clone() for name, x in inputs.items()}
        self.generator = generator
        self.names: list = []
        self.outputs: Tensors = {}

        def body():
            metrics, self.outputs = block(self.inputs, generator)
            self.names = list(metrics)
            return torch.stack([metrics[k].detach() for k in self.names])

        self.graph = make_graph(body, generator, pool)
        self.params = params
        self.grads = [p.grad for p in params]
        self.tensors = in_place()
        self.addresses = [t.data_ptr() for t in self.tensors]

    def holds(self, now: list, generator) -> bool:
        return (generator is self.generator and len(now) == len(self.tensors)
                and all(a is b for a, b in zip(now, self.tensors))
                and [t.data_ptr() for t in now] == self.addresses)

    def run(self, inputs) -> Tuple[Tensors, Tensors]:
        torch._foreach_copy_(list(self.inputs.values()), [inputs[name] for name in self.inputs])
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        out = self.graph.replay().clone()  # the step's own metrics: the graph rewrites its output
        return dict(zip(self.names, out.unbind())), self.outputs


class StepGraphs:
    """``graphs(inputs, generator) -> (metrics, outputs)``: ``block(inputs,
    generator)`` (a block of the step on the named tensors ``inputs``,
    returning 0-d float32 metrics and a dictionary of detached tensors) run
    eagerly or replayed from a CUDA graph, as the module's docstring says.
    ``models``: the networks the block runs; ``params``: the parameters whose
    gradients it sets; ``optimizers``: those it updates (``None`` entries
    skipped); ``spans``: the names of its replay and capture spans
    (``utils/timer.py``); ``max_graphs``: the keys it keeps a graph for, the
    oldest going first. ``make_graph(body, generator, pool)`` builds the
    graph (:class:`CudaGraph`) in the pool of the block's live graphs."""

    def __init__(self, block: Callable, device, models, params, optimizers=(), *, spans, max_graphs: int):
        self._block = block
        self._models = [m for m in models if m is not None]
        self._params = list(params)
        self._opts = [opt for opt in optimizers if opt is not None]
        self._replay, self._capture = map(trace_annotation, spans)
        self._max_graphs = max_graphs
        self.on_card = torch.device(device).type == "cuda"
        self.make_graph = CudaGraph
        self._seen: set = set()
        self._graphs: OrderedDict = OrderedDict()

    def engaged(self) -> bool:
        return self.on_card and not collectives.active() and not torch.is_anomaly_enabled()

    def _in_place(self) -> list:
        return _in_place(self._models, self._opts)

    def __call__(self, inputs: Tensors, generator: torch.Generator) -> Tuple[Tensors, Tensors]:
        if not self.engaged():
            return self._block(inputs, generator)
        key = graph_key(inputs, self._opts)
        if key not in self._seen:  # the warm-up: momentum buffers made, cuDNN's plans picked
            self._seen.add(key)
            return self._block(inputs, generator)
        captured = self._graphs.pop(key, None)
        if captured is None or not captured.holds(self._in_place(), generator):
            captured = None  # the stale graph goes before the new one is captured
            pool = next(iter(self._graphs.values())).graph.pool if self._graphs else None
            with self._capture:
                captured = _Captured(self._block, inputs, generator, self._in_place, self._params, self.make_graph, pool)
        self._graphs[key] = captured
        while len(self._graphs) > self._max_graphs:
            self._graphs.popitem(last=False)
        with self._replay:
            return captured.run(inputs)
