"""A small generator architecture that only the benchmark's CPU tests build,
from this file alone, as a configuration's ``arch`` would name a file of
``perfbench/reference/arch/``: a weight-standardised patch convolution with
GroupNorm, a bare position parameter, one pre-LayerNorm attention block
whose QK^T and PV go through ``numerics.Product``, then a 3x3 convolution,
a BatchNorm and a bilinear upsampling to the 1x1 classifier, and the U-Net's
point head on the token map. Tokens lie on a (crop / 2**n_block)^2 grid, the
U-Net's bottleneck, so ``fc_inch`` is the U-Net's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import numerics
from perfbench.reference.unet import LEAKY_SLOPE, PointHead, TwinBatchNorm, leaky_relu

HEADS = 2


class StdConv2d(numerics.Conv2d):
    """A convolution whose weight is standardised per output channel
    (zero mean, unit variance) before the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v, m = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = ((self.weight - m) / torch.sqrt(v + 1e-5)).to(self.compute_dtype)
        x = x.to(self.compute_dtype)
        if self.operand_round is not None:
            x, w = self.operand_round(x), self.operand_round(w)
        return self._conv_forward(x, w, None if self.bias is None else self.bias.to(self.compute_dtype))


class Embeddings(nn.Module):
    def __init__(self, in_channels: int, width: int, patch: int, tokens: int):
        super().__init__()
        self.patch = StdConv2d(in_channels, width, patch, stride=patch, bias=False)
        self.norm = nn.GroupNorm(2, width)
        self.position = nn.Parameter(torch.zeros(1, tokens, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm(self.patch(x)))
        return x.flatten(2).transpose(1, 2) + self.position


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.norm = nn.LayerNorm(width)
        self.qkv = numerics.Linear(width, 3 * width)
        self.scores = numerics.Product()
        self.mix = numerics.Product()
        self.out = numerics.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        q, k, v = self.qkv(self.norm(x)).reshape(b, n, 3, HEADS, w // HEADS).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(self.scores(q, k.transpose(-2, -1)) / math.sqrt(w // HEADS), dim=-1)
        return x + self.out(self.mix(attn, v).transpose(1, 2).reshape(b, n, w))


class TinyViT(nn.Module):
    def __init__(self, cfg, generator, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        width, self.grid = 2 * cfg.filters, cfg.crop_size // 2**cfg.n_block
        self.embeddings = Embeddings(cfg.in_channels, width, 2**cfg.n_block, self.grid**2)
        self.attention = Attention(width)
        if cfg.point_head:
            self.pointNet = PointHead(width, 300, cfg.fc_inch, width)
        self.conv_more = numerics.Conv2d(width, cfg.filters, 3, padding=1)
        self.norm = TwinBatchNorm(cfg.filters, cfg.bn_stats_impl == "pallas")
        self.classifier = nn.Conv2d(cfg.filters, cfg.n_class, 1)
        numerics.set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        size = x.shape[1]
        x = self.attention(self.embeddings(x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()))
        x = x.transpose(1, 2).reshape(x.shape[0], -1, self.grid, self.grid)
        points = self.pointNet(x).to(torch.float32) if hasattr(self, "pointNet") else None
        x = self.norm(leaky_relu(self.conv_more(x), LEAKY_SLOPE))
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
        return self.classifier(x.to(torch.float32)).permute(0, 2, 3, 1), None, points


def build_generator(cfg, generator, compute_dtype):
    return TinyViT(cfg, generator, compute_dtype)


def generator_flops(c, cfg, b: int, train: bool) -> None:
    width, grid, patch = 2 * cfg.filters, cfg.crop_size // 2**cfg.n_block, 2**cfg.n_block
    n, head = grid * grid, width // HEADS
    g = c.conv(b, cfg.in_channels, width, patch, grid, grid, False, train)
    c.product(2.0 * b * n * width * 3 * width, g, train)  # qkv
    c.product(2.0 * b * HEADS * n * n * head, g, g)  # QK^T
    c.product(2.0 * b * HEADS * n * n * head, g, g)  # PV
    c.product(2.0 * b * n * width * width, g, train)  # out
    if cfg.point_head:
        c.conv(b, width, 300, 6, grid - 5, grid - 5, g, train)
        c.product(2.0 * b * 300 * cfg.fc_inch * 3, g, train)
    c.conv(b, width, cfg.filters, 3, grid, grid, g, train)
    c.conv(b, cfg.filters, cfg.n_class, 1, cfg.crop_size, cfg.crop_size, g, train)


def _position(module, leaf, cfg):
    return ("normal", 0.02) if leaf == "position" else None


def _std_conv(module, leaf, cfg):  # He's normal: the standardisation takes the scale out
    if leaf == "weight":
        return "normal", math.sqrt(2.0 / math.prod(module.weight.shape[1:]))
    return None


INIT_RULES = [(Embeddings, _position), (StdConv2d, _std_conv)]
