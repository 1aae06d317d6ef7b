"""Frozen copy of ``pointcloududa_torch/models/pointnet.py`` (the benchmark's reference;
imports nothing of the program; later changes to the program do not reach it).

PointNet binary classifier (D4) with STN3d / STNkd transformers, the
counterpart of ``pointcloududa_tpu/models/pointnet.py``.

Reference ``src/networks/PointNetCls.py``, with its quirks: the non-ext path
applies bn3 *without* a ReLU before the max-pool (``:159``, PARITY.md
deviation 3), and the classifier's Dropout(0.3) comes *before* bn2
(``:209``). Module names follow the reference's ``state_dict`` (STN BNs are
bn1-3 for convs and bn4-5 for FCs).

The public forward takes (B, N, 3) clouds, like the JAX module; inside, the
shared MLP runs channel-first as Conv1d. The norms have the generator's
BatchNorm numerics (flax fast variance, torch running update) but never use
the BN kernel (as in JAX, ``pointnet.py:60``); at batch size 1 they
normalise per sample instead (:class:`Norm1d`). Every layer keeps the torch
default init, as the reference's init loop skips PointNet. ``compute_dtype``
as in ``models/unet.py``: the input transforms multiply in float32, as the
JAX module's ``einsum(..., preferred_element_type=f32)`` does, and the logit
comes out in float32 (the transforms in the compute dtype, as in JAX).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.init import torch_linear_init
from perfbench.reference.numerics import Conv1d, Linear, set_compute_dtype
from perfbench.reference.unet import Dropout, TwinBatchNorm


class Norm1d(TwinBatchNorm):
    """BatchNorm over (B, C) or (B, C, N) with the generator's numerics and
    plain statistics; for a single sample, normalise over the points
    (B, C, N) or the features (B, C) without running stats."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] > 1:
            return super().forward(x)
        dim = 2 if x.dim() == 3 else 1
        mean = torch.mean(x, dim=dim, keepdim=True)
        var = torch.var(x, dim=dim, unbiased=False, keepdim=True)
        shape = (1, -1, 1) if x.dim() == 3 else (1, -1)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.weight.view(shape) + self.bias.view(shape)


class STNkd(nn.Module):
    """Identity-biased (k, k) transform per sample (reference STN3d for k=3,
    STNkd otherwise); input (B, k, N) channel-first."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.conv1 = Conv1d(k, 64, 1)
        self.conv2 = Conv1d(64, 128, 1)
        self.conv3 = Conv1d(128, 1024, 1)
        self.fc1 = Linear(1024, 512)
        self.fc2 = Linear(512, 256)
        self.fc3 = Linear(256, k * k)
        for i, ch in enumerate((64, 128, 1024, 512, 256), start=1):
            self.add_module(f"bn{i}", Norm1d(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = torch.amax(x, dim=2)
        x = F.relu(self.bn4(self.fc1(x)))
        x = F.relu(self.bn5(self.fc2(x)))
        x = self.fc3(x) + torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, -1)
        return x.reshape(-1, self.k, self.k)


def _transform(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(B, D, N) channel-first points times a (B, D, D) transform, in f32."""
    return torch.bmm(x.transpose(1, 2).to(torch.float32), trans.to(torch.float32)).transpose(1, 2)


class PointNetFeat(nn.Module):
    """Global feature extractor (reference ``PointNetfeat``): (B, 3, N) ->
    (B, 1024) max-pooled feature, the input transform, the feature transform."""

    def __init__(self, feature_transform=False, ext=False):
        super().__init__()
        self.feature_transform = feature_transform
        self.ext = ext
        self.stn = STNkd(3)
        ladder = (
            (("conv1", 3, 8), ("conv1_1", 8, 64), ("conv2", 64, 128), ("conv2_1", 128, 256),
             ("conv3", 256, 512), ("conv3_1", 512, 1024))
            if ext else (("conv1", 3, 64), ("conv2", 64, 128), ("conv3", 128, 1024))
        )
        for name, cin, cout in ladder:
            self.add_module(name, Conv1d(cin, cout, 1))
            self.add_module(name.replace("conv", "bn"), Norm1d(cout))
        if feature_transform:
            self.fstn = STNkd(64)

    def _stage(self, x, name, relu=True):
        x = getattr(self, name.replace("conv", "bn"))(getattr(self, name)(x))
        return F.relu(x) if relu else x

    def forward(self, x: torch.Tensor):
        trans = self.stn(x)
        x = _transform(x, trans)
        trans_feat = None
        if self.ext:
            x = self._stage(self._stage(x, "conv1"), "conv1_1")
        else:
            x = self._stage(x, "conv1")
        if self.feature_transform:
            trans_feat = self.fstn(x)
            x = _transform(x, trans_feat)
        x = self._stage(x, "conv2")
        if self.ext:
            x = self._stage(x, "conv2_1")
            # bn3 with no ReLU in both paths (reference PointNetCls.py:159)
            x = self._stage(self._stage(x, "conv3", relu=False), "conv3_1")
        else:
            x = self._stage(x, "conv3", relu=False)
        return torch.amax(x, dim=2), trans, trans_feat


class PointNetCls(nn.Module):
    """Binary point-cloud discriminator: (B, N, 3) -> (logit (B, 1), trans,
    trans_feat)."""

    def __init__(self, feature_transform=False, ext=False, drop: float = 0.3,
                 generator: torch.Generator | None = None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat = PointNetFeat(feature_transform, ext)
        self.fc1 = Linear(1024, 512)
        self.fc2 = Linear(512, 256)
        self.fc3 = Linear(256, 1)
        self.bn1 = Norm1d(512)
        self.bn2 = Norm1d(256)
        self.dropout = Dropout(drop)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                torch_linear_init(m, generator)
        set_compute_dtype(self, compute_dtype)

    def forward(self, points: torch.Tensor, generator: torch.Generator | None = None):
        x, trans, trans_feat = self.feat(points.to(torch.float32).transpose(1, 2).contiguous())
        x = F.relu(self.bn1(self.fc1(x)))
        x = self.dropout(self.fc2(x), generator)  # before the norm (PointNetCls.py:209)
        x = F.relu(self.bn2(x))
        return self.fc3(x).to(torch.float32), trans, trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Orthogonality penalty ``mean_b ||I - A A^T||_F`` (``PointNetCls.py:217-224``)."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)[None]
    return torch.mean(torch.linalg.matrix_norm(torch.bmm(trans, trans.transpose(1, 2)) - eye))
