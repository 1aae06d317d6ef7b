"""PatchGAN discriminator for output space (D1) and entropy-map space (D2),
the counterpart of ``pointcloududa_tpu/models/discriminator.py``.

Reference ``src/networks/GAN.py:89-144`` (UncertaintyDiscriminator): strided
4x4 convs 64-128-256-512-1 with padding 2, LeakyReLU(0.2), no normalisation,
no biases; ``ext`` inserts two 3x3 stride-2 convs before the head. NHWC in and
out, like the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointcloududa_torch.models.init import conv_init


class UncertaintyDiscriminator(nn.Module):
    def __init__(self, in_channel: int = 2, heinit: bool = False, ext: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ext = ext
        self.conv1 = nn.Conv2d(in_channel, 64, 4, stride=2, padding=2, bias=False)
        self.conv2 = nn.Conv2d(64, 128, 4, stride=2, padding=2, bias=False)
        self.conv3 = nn.Conv2d(128, 256, 4, stride=2, padding=2, bias=False)
        self.conv4 = nn.Conv2d(256, 512, 4, stride=2, padding=2, bias=False)
        if ext:
            self.conv4_2 = nn.Conv2d(512, 1024, 3, stride=2, padding=1, bias=False)
            self.conv4_3 = nn.Conv2d(1024, 256, 3, stride=2, padding=1, bias=False)
        self.conv5 = nn.Conv2d(256 if ext else 512, 1, 4, stride=2, padding=2, bias=False)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init(m, heinit, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> patch logits (B, h', w', 1)."""
        x = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        names = ("conv1", "conv2", "conv3", "conv4") + (("conv4_2", "conv4_3") if self.ext else ())
        for name in names:
            x = F.leaky_relu(getattr(self, name)(x), 0.2)
        return self.conv5(x).permute(0, 2, 3, 1)
