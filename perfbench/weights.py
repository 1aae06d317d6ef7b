"""The initial weights of every network, made on the device from the seed
in a few large draws, and handed alike to the program and the reference.

The distributions are the reference models' initialisers
(``reference/init.py``): a 2-D convolution's weight N(0, 0.02) (He's normal
under ``heinit``) and zero bias; a 1-D convolution's and a linear layer's
weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)); a BatchNorm's scale 1 and
shift 0, running mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.iteration import model_shapes


def _plan(cfg) -> list:
    """[(net, name, shape, draw, scale)] with draw in normal / uniform / zeros
    / ones / count."""
    plan = []
    for net, leaves in model_shapes(cfg).items():
        for name, (shape, kind, leaf) in leaves.items():
            if leaf == "num_batches_tracked":
                plan.append((net, name, shape, "count", 0.0))
            elif kind == "Conv2d" and leaf == "weight":
                fan_in = math.prod(shape[1:])
                plan.append((net, name, shape, "normal", math.sqrt(2.0 / fan_in) if cfg.heinit else 0.02))
            elif kind == "Conv2d":
                plan.append((net, name, shape, "zeros", 0.0))
            elif kind in ("Conv1d", "Linear"):
                weight_shape = leaves[name.rsplit(".", 1)[0] + ".weight"][0]
                plan.append((net, name, shape, "uniform", 1.0 / math.sqrt(math.prod(weight_shape[1:]))))
            elif leaf in ("weight", "running_var"):
                plan.append((net, name, shape, "ones", 0.0))
            else:  # a norm's shift, running mean
                plan.append((net, name, shape, "zeros", 0.0))
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
