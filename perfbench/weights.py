"""The initial weights of every network, made on the device from the seed
in a few large draws, and handed alike to the program and the reference.

Each leaf (parameter or buffer) is drawn by the first rule, in
``INIT_RULES`` of the generator's architecture (``reference/arch/<arch>.py``)
and then in ``BASE_RULES``, whose module type the leaf's module is an
instance of and that covers the leaf's name; a leaf that no rule covers
raises. A rule is ``rule(module, leaf, cfg) -> (draw, scale) | None``, with
draw ``normal`` (N(0, scale)), ``uniform`` (U(-scale, scale)), ``zeros``,
``ones`` or ``count`` (an int64 zero).

The base rules are the reference models' initialisers
(``reference/init.py``): a 2-D convolution's weight N(0, 0.02) (He's normal
under ``heinit``) and zero bias; a 1-D convolution's and a linear layer's
weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)); a norm's scale 1 and
shift 0, running mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from perfbench.reference import arch
from perfbench.reference.iteration import model_leaves
from perfbench.reference.unet import TwinBatchNorm


def _conv2d(module, leaf, cfg):
    if leaf == "weight":
        fan_in = math.prod(module.weight.shape[1:])
        return "normal", math.sqrt(2.0 / fan_in) if cfg.heinit else 0.02
    if leaf == "bias":
        return "zeros", 0.0
    return None


def _torch_default(module, leaf, cfg):
    if leaf in ("weight", "bias"):
        return "uniform", 1.0 / math.sqrt(math.prod(module.weight.shape[1:]))
    return None


_NORM = {"weight": ("ones", 0.0), "bias": ("zeros", 0.0), "running_mean": ("zeros", 0.0),
         "running_var": ("ones", 0.0), "num_batches_tracked": ("count", 0.0)}


def _norm(module, leaf, cfg):
    return _NORM.get(leaf)


BASE_RULES = (
    (nn.Conv2d, _conv2d),
    ((nn.Conv1d, nn.Linear), _torch_default),
    ((TwinBatchNorm, nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm), _norm),
)


def _plan(cfg) -> list:
    """[(net, name, shape, draw, scale)] in ``state_dict`` order."""
    rules = tuple(getattr(arch.load(cfg.arch), "INIT_RULES", ())) + BASE_RULES
    plan = []
    for net, leaves in model_leaves(cfg).items():
        for name, module, leaf, shape in leaves:
            got = next((r for r in (rule(module, leaf, cfg) for kind, rule in rules if isinstance(module, kind))
                        if r is not None), None)
            if got is None:
                raise ValueError(f"{net}.{name}: no initial-weight rule covers the leaf {leaf!r} of a "
                                 f"{type(module).__name__}")
            plan.append((net, name, shape) + got)
    return plan


def make_weights(cfg, seed: int, device) -> dict:
    """``{net: state_dict}`` of float32 tensors on ``device`` (the count
    buffers int64), drawn from ``seed``: one normal and one uniform draw for
    all the leaves."""
    plan = _plan(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(math.prod(s) for _, _, s, d, _ in plan if d == kind) for kind in ("normal", "uniform")}
    pools = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device).mul_(2.0).sub_(1.0),
    }
    offsets = {"normal": 0, "uniform": 0}
    out: dict = {}
    for net, name, shape, draw, scale in plan:
        n = math.prod(shape)
        if draw in pools:
            o = offsets[draw]
            t = pools[draw][o:o + n].view(shape) * scale
            offsets[draw] = o + n
        elif draw == "count":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            t = (torch.ones if draw == "ones" else torch.zeros)(shape, device=device)
        out.setdefault(net, {})[name] = t
    return out
