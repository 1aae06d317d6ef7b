"""Frozen copy of ``pointcloududa_torch/models/discriminator.py`` (the benchmark's reference;
imports nothing of the program; later changes to the program do not reach it).

PatchGAN discriminator for output space (D1) and entropy-map space (D2),
the counterpart of ``pointcloududa_tpu/models/discriminator.py``.

Reference ``src/networks/GAN.py:89-144`` (UncertaintyDiscriminator): strided
4x4 convs 64-128-256-512-1 with padding 2, LeakyReLU(0.2), no normalisation,
no biases; ``ext`` inserts two 3x3 stride-2 convs before the head. NHWC in and
out, like the JAX module; ``compute_dtype`` as in ``models/unet.py``, the patch
logits float32 in either.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.init import conv_init
from perfbench.reference.numerics import Conv2d, set_compute_dtype
from perfbench.reference.unet import leaky_relu


class UncertaintyDiscriminator(nn.Module):
    def __init__(self, in_channel: int = 2, heinit: bool = False, ext: bool = False,
                 generator: torch.Generator | None = None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ext = ext
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(in_channel, 64, 4, stride=2, padding=2, bias=False)
        self.conv2 = Conv2d(64, 128, 4, stride=2, padding=2, bias=False)
        self.conv3 = Conv2d(128, 256, 4, stride=2, padding=2, bias=False)
        self.conv4 = Conv2d(256, 512, 4, stride=2, padding=2, bias=False)
        if ext:
            self.conv4_2 = Conv2d(512, 1024, 3, stride=2, padding=1, bias=False)
            self.conv4_3 = Conv2d(1024, 256, 3, stride=2, padding=1, bias=False)
        self.conv5 = Conv2d(256 if ext else 512, 1, 4, stride=2, padding=2, bias=False)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init(m, heinit, generator)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> patch logits (B, h', w', 1)."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        names = ("conv1", "conv2", "conv3", "conv4") + (("conv4_2", "conv4_3") if self.ext else ())
        for name in names:
            x = leaky_relu(getattr(self, name)(x), 0.2)
        return self.conv5(x).to(torch.float32).permute(0, 2, 3, 1)
