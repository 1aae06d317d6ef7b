"""Phases 3-5 of the train step replayed from one CUDA graph.

The discriminators' forward, backward and update on the generator's
detached outputs (``step.discriminator_phase`` for D1, D2 and D4, in that
order) are a few thousand small kernels with a few milliseconds of device
work; launched one at a time from Python they cost the host tens of
milliseconds a step. :class:`DiscriminatorGraphs` captures the block once and
replays it: the block's inputs are copied into tensors the graph owns, one
graph launch runs it, and its metrics come out in one copy.

Whether it engages depends only on what the step observes: the models on a
CUDA device, no data mesh (``average_grads`` would all-reduce), anomaly mode
off (``-debug_nans`` checks on the host). A graph is keyed by the inputs'
names, shapes and dtypes (a ``sample_mask`` among them) and by every
discriminator optimiser's hyper-parameters, which the graph holds as
constants. The first step with a key runs eagerly: it makes the SGD momentum
buffers and picks cuDNN's plans. The second captures the block and replays
it, and later ones replay it. A replay first checks that the parameters,
their momentum buffers and the dropout generator are the objects captured,
at the same addresses; a restored optimiser (``opt.load_state_dict``)
replaces the buffers, and the block is captured again. Everything else runs
the block eagerly.

The graph runs the eager block's arithmetic: the same kernels on the same
tensors, torch's float32 SGD, D4's BatchNorm statistics in the same order,
and D4's dropout drawn from the step's generator, which is registered with
the graph, so the masks, and the generator's state after K replays, are
those of K eager steps. The block sets each gradient anew
(``zero_grad(set_to_none=True)``) and never reads an older one, so an eager
step in between (a padded tail batch) that left other ``.grad`` tensors
needs no new capture: they are pointed back at the graph's before a replay.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict

import torch

from pointcloududa_torch.parallel import collectives
from pointcloududa_torch.utils import timer
from pointcloududa_torch.utils.timer import trace_annotation

MAX_GRAPHS = 2  # the full batch's and a padded tail's; the oldest (an optimiser's former lr) goes first

_REPLAY = trace_annotation(timer.DISC_REPLAY)
_CAPTURE = trace_annotation(timer.DISC_CAPTURE)


def graph_key(inputs: Dict[str, torch.Tensor], optimizers) -> tuple:
    """What a captured block is valid for: the inputs' names, shapes and
    dtypes, and each optimiser's hyper-parameters (lr, momentum, weight
    decay, ...)."""
    return (tuple((name, tuple(x.shape), x.dtype) for name, x in inputs.items()),
            tuple(tuple(sorted((k, v) for k, v in group.items() if k != "params"))
                  for opt in optimizers for group in opt.param_groups))


def _updated_in_place(optimizers) -> list:
    """The tensors a captured update writes: the parameters and their momentum buffers."""
    out = []
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                out.append(p)
                buf = opt.state[p].get("momentum_buffer") if p in opt.state else None
                if buf is not None:
                    out.append(buf)
    return out


class CudaGraph:
    """``body()`` captured into one CUDA graph, ``generator``'s draws among
    it; ``replay()`` runs the graph and returns the tensor ``body`` returned,
    which each replay rewrites."""

    def __init__(self, body: Callable[[], torch.Tensor], generator: torch.Generator):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.register_generator_state(generator)
        # thread_local: the prefetcher's thread copies and allocates on its own stream during the capture
        with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
            self._out = body()

    def replay(self) -> torch.Tensor:
        self._graph.replay()
        return self._out


class _Captured:
    """One capture of the block: its own inputs, the graph, and what a
    replay checks and restores."""

    def __init__(self, block, inputs, generator, optimizers, make_graph):
        self.inputs = {name: x.detach().clone() for name, x in inputs.items()}
        self.generator = generator
        self.names: list = []

        def body():
            metrics = block(self.inputs, generator)
            self.names = list(metrics)
            return torch.stack([metrics[k].detach() for k in self.names])

        self.graph = make_graph(body, generator)
        self.params = [p for opt in optimizers for group in opt.param_groups for p in group["params"]]
        self.grads = [p.grad for p in self.params]
        self.tensors = _updated_in_place(optimizers)
        self.addresses = [t.data_ptr() for t in self.tensors]

    def holds(self, optimizers, generator) -> bool:
        now = _updated_in_place(optimizers)
        return (generator is self.generator and len(now) == len(self.tensors)
                and all(a is b for a, b in zip(now, self.tensors))
                and [t.data_ptr() for t in now] == self.addresses)

    def run(self, inputs) -> Dict[str, torch.Tensor]:
        torch._foreach_copy_(list(self.inputs.values()), [inputs[name] for name in self.inputs])
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        out = self.graph.replay().clone()  # the step's own metrics: the graph rewrites its output
        return dict(zip(self.names, out.unbind()))


class DiscriminatorGraphs:
    """``graphs(inputs, generator) -> metrics``: ``block(inputs,
    generator)`` (phases 3-5 on the named detached tensors ``inputs``,
    returning 0-d float32 metrics) run eagerly or replayed from a CUDA graph,
    as the module's docstring says. ``make_graph(body, generator)`` builds
    the graph (:class:`CudaGraph`)."""

    def __init__(self, block: Callable, optimizers, device):
        self._block = block
        self._opts = [opt for opt in optimizers if opt is not None]
        self.on_card = torch.device(device).type == "cuda"
        self.make_graph = CudaGraph
        self._seen: set = set()
        self._graphs: OrderedDict = OrderedDict()

    def engaged(self) -> bool:
        return self.on_card and bool(self._opts) and not collectives.active() and not torch.is_anomaly_enabled()

    def __call__(self, inputs: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if not self.engaged():
            return self._block(inputs, generator)
        key = graph_key(inputs, self._opts)
        if key not in self._seen:  # the warm-up: momentum buffers made, cuDNN's plans picked
            self._seen.add(key)
            return self._block(inputs, generator)
        captured = self._graphs.pop(key, None)
        if captured is None or not captured.holds(self._opts, generator):
            captured = None  # the stale graph goes before the new one is captured
            with _CAPTURE:
                captured = _Captured(self._block, inputs, generator, self._opts, self.make_graph)
        self._graphs[key] = captured
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        with _REPLAY:
            return captured.run(inputs)
