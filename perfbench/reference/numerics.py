"""The reference's numerics that every generator architecture shares, in one
place: the layers whose products the control rounds one precision lower,
the roundings themselves, and the BatchNorm statistics that the float64
witness swaps.

- :class:`Conv2d`, :class:`Conv1d`, :class:`Linear` compute in the model's
  compute dtype as flax does (:class:`_ComputeDtype`), and :class:`Product`
  is a plain matrix product (``torch.matmul``, which batches) under the same
  rule, for products that have no layer, such as attention's QK^T and PV.
  An architecture routes every product through these, so that
  :func:`set_operand_rounding` reaches all of them.
- :func:`tf32` and :func:`fp8_e4m3`: the control's roundings
  (``correctness.control_rounding``).
- :func:`batch_stats`: every BatchNorm's batch statistics, called through
  this module (``numerics.batch_stats(...)``), so that
  :func:`float64_bn_statistics` swaps them for every architecture at once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.bn import batch_stats  # noqa: F401  (swapped by float64_bn_statistics)


class _ComputeDtype:
    """A conv or linear layer that computes in ``compute_dtype`` (set by
    :func:`set_compute_dtype`) as flax's ``nn.Conv`` / ``nn.Dense(dtype=...)``
    do: input, weight and bias cast to it, the bias added after the product
    as an op of its own (a bias fused into the convolution rounds once where
    flax rounds twice). In float32 the layer is PyTorch's own."""

    compute_dtype = torch.float32
    operand_round = None  # the control's lower precision (set_operand_rounding); None in the reference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 and self.operand_round is None:
            return super().forward(x)
        xc, wc = x.to(dt), self.weight.to(dt)
        if self.operand_round is not None:
            xc, wc = self.operand_round(xc), self.operand_round(wc)
        if isinstance(self, nn.Linear):
            y, channels = F.linear(xc, wc), (-1,)
        else:  # channels on dim 1, then the spatial dims
            y, channels = self._conv_forward(xc, wc, None), (-1,) + (1,) * (x.dim() - 2)
        return y if self.bias is None else y + self.bias.to(dt).view(channels)


class Conv2d(_ComputeDtype, nn.Conv2d):
    pass


class Conv1d(_ComputeDtype, nn.Conv1d):
    pass


class Linear(_ComputeDtype, nn.Linear):
    pass


class Product(nn.Module):
    """``torch.matmul(a, b)`` in the compute dtype, both operands rounded
    first where the control's rounding is set; no parameters, so the
    weights do not see it."""

    compute_dtype = torch.float32
    operand_round = None

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(self.compute_dtype), b.to(self.compute_dtype)
        if self.operand_round is not None:
            a, b = self.operand_round(a), self.operand_round(b)
        return torch.matmul(a, b)


_ROUNDED = (_ComputeDtype, Product)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every :class:`Conv2d`, :class:`Conv1d`, :class:`Linear` and
    :class:`Product` under ``module`` computes in ``dtype`` from now on."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {dtype}")
    for m in module.modules():
        if isinstance(m, _ROUNDED):
            m.compute_dtype = dtype


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to e4m3's largest finite value, 448), returned in ``t``'s
    dtype. The gradient passes straight through: the rounded operands enter
    the product, and the backward runs in ``t``'s dtype on them."""
    amax = t.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = 448.0 / amax
    rounded = ((t.detach().to(torch.float32) * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale).to(t.dtype)
    return t + (rounded - t.detach())


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32, the tensor cores' 10-bit mantissa
    (to nearest, ties away from zero), returned in float32. The gradient
    passes straight through, as :func:`fp8_e4m3`'s does."""
    bits = t.detach().to(torch.float32).contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)
    return t + (rounded - t.detach())


def set_operand_rounding(module: nn.Module, fn) -> None:
    """Every :class:`Conv2d`, :class:`Conv1d`, :class:`Linear` and
    :class:`Product` under ``module`` rounds its operands with ``fn`` before
    the product (the control: :func:`fp8_e4m3` under bfloat16, :func:`tf32`
    under float32), or not, with ``None``."""
    for m in module.modules():
        if isinstance(m, _ROUNDED):
            m.operand_round = fn


def float64_stats(x: torch.Tensor, use_kernel: bool = False):
    """:func:`batch_stats` with its sums in float64, rounded once to float32."""
    dims = (0,) + tuple(range(2, x.dim()))
    xd = x.to(torch.float64)
    mean, meansq = torch.mean(xd, dim=dims).float(), torch.mean(xd * xd, dim=dims).float()
    return mean, torch.clamp_min(meansq - torch.square(mean), 0.0)


@contextlib.contextmanager
def float64_bn_statistics():
    """Inside the block every BatchNorm that calls ``numerics.batch_stats``
    sums its statistics in float64 (the rounding witness of
    ``calibrate.py``)."""
    global batch_stats
    plain, batch_stats = batch_stats, float64_stats
    try:
        yield
    finally:
        batch_stats = plain
