"""Frozen copy of ``pointcloududa_torch/models/unet.py`` (the benchmark's reference;
imports nothing of the program; later changes to the program do not reach it).

The segmentation generator: dense-skip U-Net with a dilated bottleneck and
an optional point-cloud head (counterpart of ``pointcloududa_tpu/models/unet.py``,
standard layout only).

Modules are named with the reference's ``state_dict`` key layout
(``encoder.encoder1.0.weight``, ``pointNet.final_fc.weight``, ...), the layout
``pointcloududa_tpu/utils/torch_import.py`` parses, so the reference's
released ``.pt`` files load with a plain ``load_state_dict``. The public
forward takes and returns NHWC tensors, like the JAX model; inside, the
convolutions run NCHW.

BatchNorm is :class:`TwinBatchNorm`: flax's fast-variance normalisation in
f32 and torch's running-statistics update (momentum 0.1, unbiased n/(n-1)
variance), with the batch statistics from the CUDA kernel when ``bn_kernel``
is set. The first block's 1x1 "dense remix" conv (``conv1_1``) is built but
never applied, as in the reference, so parameter counts line up.

``compute_dtype`` (float32 or bfloat16) is the JAX models' compute dtype,
with flax's rounding points written out rather than left to
``torch.autocast``: the parameters stay float32 (same names, same
``state_dict``); every ``Conv2d`` / ``Conv1d`` / ``Linear`` (``numerics.py``)
casts its input, weight and bias to the compute dtype and adds the bias as a
separate op in it, as ``nn.Conv(dtype=...)`` does; a Python constant that
meets an activation (the leaky slope, dropout's keep rate) is rounded to the
activation's dtype first (:func:`weak_scalar`, JAX's weak typing); the
BatchNorms compute in float32 and return the compute dtype; the classifier
runs in float32, and the logits and the cloud come out in float32. In
float32 every layer is PyTorch's own, as before.
"""

from __future__ import annotations

import struct
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import numerics
from perfbench.reference.init import conv_init, torch_linear_init
from perfbench.reference.numerics import Conv2d, Linear, set_compute_dtype

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU() default, used by the whole generator


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (ndim - 2))


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (to nearest even), as JAX rounds a
    Python constant that meets an array of that dtype. Pure Python, so
    ``torch.export`` sees a constant. In float32 it returns ``value``:
    PyTorch rounds a Python scalar to a float32 op's type itself."""
    if dtype != torch.bfloat16:
        return value
    bits = struct.unpack("<I", struct.pack("<f", value))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, weak_scalar(slope, x.dtype))


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` with the slope rounded to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit ``torch.Generator``:
    keep with probability 1 - p and scale kept values by 1 / (1 - p), the
    keep rate rounded to the input's dtype (flax's ``x / keep_prob``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        b = x.shape[0]
        keep = torch.rand(tuple(x.shape), generator=generator, device=x.device) < 1.0 - self.p
        scaled = x / weak_scalar(1.0 - self.p, x.dtype)
        return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class TwinBatchNorm(nn.Module):
    """BatchNorm over every axis but dim 1 with flax numerics: the batch
    variance is the fast ``max(E[x^2] - E[x]^2, 0)`` in f32 and normalises as
    ``x * (rsqrt(var + eps) * weight) + (bias - mean * mul)`` in f32, returned
    in x's dtype (the compute dtype: flax's ``.astype(compute_dtype)``). The
    running update is torch's: momentum 0.1 and the unbiased n/(n-1)
    variance (reference ``src/networks/unet.py:28``). Parameters and buffers
    carry ``nn.BatchNorm2d``'s names."""

    def __init__(self, num_features: int, bn_kernel: bool = False, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.bn_kernel = bn_kernel
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = numerics.batch_stats(x.contiguous(), use_kernel=self.bn_kernel)
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * (var * (n / (n - 1))))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * mul
        out = x.to(torch.float32) * _channel_view(mul, x.dim()) + _channel_view(shift, x.dim())
        return out.to(x.dtype)


class DoubleConv(nn.Module):
    """Two ``ConvLReLUNorm`` halves (conv3x3 -> LeakyReLU -> optional
    Dropout(0.5), first half only -> BatchNorm), children numbered like the
    reference's ``nn.Sequential`` so the ``state_dict`` keys match
    (``unet.py:23-30``)."""

    def __init__(self, in_ch: int, out_ch: int, *, batch_norm: bool = True, dropout: bool = False,
                 bn_kernel: bool = False):
        super().__init__()
        layers: list[nn.Module] = []
        for j in range(2):
            layers += [Conv2d(in_ch if j == 0 else out_ch, out_ch, 3, padding=1), LeakyReLU(LEAKY_SLOPE)]
            if dropout and j == 0:
                layers.append(Dropout(0.5))
            if batch_norm:
                layers.append(TwinBatchNorm(out_ch, bn_kernel))
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x


def _conv_lrelu(in_ch: int, out_ch: int, kernel: int, **kw) -> nn.Sequential:
    return nn.Sequential(Conv2d(in_ch, out_ch, kernel, **kw), LeakyReLU(LEAKY_SLOPE))


class Encoder(nn.Module):
    """Downsampling path: per block, double conv -> skip -> (block > 1: concat
    the previous pooled tensor -> 1x1 conv + LeakyReLU) -> 2x2 max-pool
    (reference ``unet.py:35-51``)."""

    def __init__(self, filters=32, in_channels=3, n_block=4, batch_norm=True, bn_kernel=False):
        super().__init__()
        self.n_block = n_block
        for i in range(n_block):
            out_ch = filters * 2**i
            in_ch = in_channels if i == 0 else filters * 2 ** (i - 1)
            if i == 0:
                self.conv1_1 = _conv_lrelu(in_ch * 3, out_ch, 1)  # built, never applied
            self.add_module(f"encoder{i + 1}", DoubleConv(in_ch, out_ch, batch_norm=batch_norm, bn_kernel=bn_kernel))
            if i > 0:
                self.add_module(f"conv1_{i + 1}", _conv_lrelu(out_ch + in_ch, out_ch, 1))

    def forward(self, x, generator=None):
        skips = []
        res = None
        for i in range(self.n_block):
            x = getattr(self, f"encoder{i + 1}")(x, generator)
            skips.append(x)
            if i > 0:
                x = getattr(self, f"conv1_{i + 1}")(torch.cat([x, res], dim=1))
            x = F.max_pool2d(x, 2)
            res = x
        return x, skips


class Bottleneck(nn.Module):
    """Four dilated 3x3 convs (dilation 1, 2, 4, 8) whose activations are
    summed (reference ``unet.py:54-73``)."""

    def __init__(self, filters=32, n_block=4, depth=4):
        super().__init__()
        self.depth = depth
        out_ch = filters * 2**n_block
        for i in range(depth):
            in_ch = filters * 2 ** (n_block - 1) if i == 0 else out_ch
            self.add_module(f"bottleneck{i + 1}", _conv_lrelu(in_ch, out_ch, 3, padding=2**i, dilation=2**i))

    def forward(self, x):
        total = 0.0
        for i in range(self.depth):
            x = getattr(self, f"bottleneck{i + 1}")(x)
            total = total + x
        return total


class PointHead(nn.Module):
    """(ext: two 3x3 convs) -> Conv k6 VALID to ``num_points`` channels +
    LeakyReLU -> channel-first flatten -> Linear(fc_inch -> 3)
    (reference ``unet.py:76-96``)."""

    def __init__(self, in_ch, num_points=300, fc_inch=81, conv_inch=512, ext=False):
        super().__init__()
        if fc_inch <= 0:
            raise ValueError(
                "PointHead needs fc_inch = (bottleneck_hw - 5)^2 > 0 "
                f"(got {fc_inch}); the input must be >= 96px for a "
                "4-block encoder (bottleneck >= 6 for the k6 VALID conv)"
            )
        self.ext = ext
        if ext:
            self.conv1 = Conv2d(in_ch, conv_inch * 2, 3, padding=1)
            self.conv2 = Conv2d(conv_inch * 2, conv_inch, 3, padding=1)
            in_ch = conv_inch
        self.final_conv = Conv2d(in_ch, num_points, 6)
        self.final_fc = Linear(fc_inch, 3)

    def forward(self, x):
        if self.ext:
            x = leaky_relu(self.conv1(x), LEAKY_SLOPE)
            x = leaky_relu(self.conv2(x), LEAKY_SLOPE)
        x = leaky_relu(self.final_conv(x), LEAKY_SLOPE)
        b, p, h, w = x.shape
        return self.final_fc(x.reshape(b, p, h * w))  # (B, num_points, 3)


class Decoder(nn.Module):
    """Up-blocks: nearest 2x + conv -> concat [skip, up] (LIFO skips) ->
    double conv (reference ``unet.py:100-136``)."""

    def __init__(self, filters=32, n_block=4, batch_norm=True, drop=False, bn_kernel=False):
        super().__init__()
        self.n_block = n_block
        for i in reversed(range(n_block)):
            out_ch = filters * 2**i
            self.add_module(
                f"decoder1_{i + 1}",
                nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                              Conv2d(filters * 2 ** (i + 1), out_ch, 3, padding=1)),
            )
            self.add_module(
                f"decoder2_{i + 1}",
                DoubleConv(2 * out_ch, out_ch, batch_norm=batch_norm, dropout=drop, bn_kernel=bn_kernel),
            )

    def forward(self, x, skips: Sequence[torch.Tensor], generator=None):
        skips = list(skips)
        for i in reversed(range(self.n_block)):
            x = getattr(self, f"decoder1_{i + 1}")(x)
            x = torch.cat([skips.pop(), x], dim=1)
            x = getattr(self, f"decoder2_{i + 1}")(x, generator)
        return x


class SegmentationPointModel(nn.Module):
    """Encoder -> Bottleneck -> {PointHead} -> Decoder -> 1x1 classifier.

    ``forward(x)`` takes NHWC images and returns the reference's 3-tuple
    ``(logits, None, points)``: NHWC logits with ``n_class`` channels and the
    (B, 300, 3) cloud under ``pointnet`` (else None), both float32 in either
    compute dtype. ``bn_kernel`` takes the BatchNorm statistics from the CUDA
    kernel (``bn_stats_impl="pallas"``)."""

    def __init__(self, filters=32, in_channels=3, n_block=4, bottleneck_depth=4, n_class=4,
                 pointnet=False, fc_inch=81, extpn=False, batchnorm=True, drop=False, heinit=False,
                 bn_kernel=False, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = Encoder(filters, in_channels, n_block, batchnorm, bn_kernel)
        self.bottleneck = Bottleneck(filters, n_block, bottleneck_depth)
        if pointnet:
            self.pointNet = PointHead(filters * 2**n_block, 300, fc_inch, 512 * filters // 32, extpn)
        self.decoder = Decoder(filters, n_block, batchnorm, drop, bn_kernel)
        # float32 whatever the compute dtype: early in training the gaps
        # between class logits are below bfloat16's resolution
        self.classifier = nn.Conv2d(filters, n_class, 1)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init(m, heinit, generator)
            elif isinstance(m, nn.Linear):  # final_fc keeps torch defaults (unet.py:194-208)
                torch_linear_init(m, generator)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        feats, skips = self.encoder(x, generator)
        bott = self.bottleneck(feats)
        points = self.pointNet(bott).to(torch.float32) if hasattr(self, "pointNet") else None
        x = self.decoder(bott, skips, generator)
        return self.classifier(x.to(torch.float32)).permute(0, 2, 3, 1), None, points
