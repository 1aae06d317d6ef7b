"""Parameter initialisers matching the reference's PyTorch initialisation
(counterpart of ``pointcloududa_tpu/models/init.py``).

Each draws from an explicit ``torch.Generator``; the distributions are the
JAX package's, the bits are not.

- default conv init: N(0, 0.02), zero bias (reference ``unet.py:203-208``);
- ``heinit``: N(0, sqrt(2 / fan_in)), fan_in = in_ch * kh * kw (``unet.py:195-202``);
- torch layer defaults U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias
  of every layer the reference's init loops skip (nn.Linear, all of PointNetCls).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def normal_002(weight: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.normal_(weight, 0.0, 0.02, generator=generator)


def he_prod_normal(weight: torch.Tensor, generator: torch.Generator) -> None:
    """std = sqrt(2 / (in_ch * kh * kw)), not truncated."""
    fan_in = weight[0].numel()
    nn.init.normal_(weight, 0.0, math.sqrt(2.0 / fan_in), generator=generator)


def conv_init(conv: nn.Module, heinit: bool, generator: torch.Generator) -> None:
    """Reference conv init: normal weight, zero bias."""
    (he_prod_normal if heinit else normal_002)(conv.weight, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def torch_linear_init(layer: nn.Module, generator: torch.Generator) -> None:
    """torch nn.Linear/Conv default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias."""
    bound = 1.0 / math.sqrt(layer.weight[0].numel())
    nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
    if layer.bias is not None:
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
