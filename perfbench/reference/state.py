"""Frozen copy of ``pointcloududa_torch/train/state.py``: the models, the
optimisers and the state that holds them.

Train state and reference-parity optimisers (counterpart of
``pointcloududa_tpu/train/state.py``).

Optimiser parity (torch's own optimisers are the reference's):
- generator: Adam(lr, betas=(0.9, 0.99), eps=1e-8) (``train_mscmrseg.py:427-431``)
  or, under ``cfg.sgd``, SGD(momentum 0.95, wd 5e-4) (``train_mmwhs.py:453-459``);
- discriminators: SGD(momentum ``cfg.disc_momentum``, wd 5e-4), the weight
  decay added to the gradient before the momentum buffer, which is torch's
  order (``train_mscmrseg.py:432-455``).

The modules hold the weights and the optimisers hold their moments, so the
state is a container of both, plus the step count and the generator that
draws dropout masks. Under ``compute_dtype="bfloat16"`` the modules compute
in bfloat16 (``models/unet.py`` says where they round); the weights, their
gradients and the optimisers' moments stay float32.

One departure from the port: the generator is built by the architecture that
``cfg.arch`` names (``reference/arch/<arch>.py``), the U-Net by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torch import nn

from perfbench.reference import arch
from perfbench.reference.config import UDAConfig
from perfbench.reference.discriminator import UncertaintyDiscriminator
from perfbench.reference.pointnet import PointNetCls


@dataclasses.dataclass
class UDATrainState:
    models: tuple  # (gen, d1, d2, d4), None where disabled
    optimizers: tuple  # matching torch optimisers
    step: int
    generator: torch.Generator  # dropout masks, on the models' device


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: UDAConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def check_config(cfg: UDAConfig) -> None:
    """Reject the settings the port does not implement."""
    if cfg.packed_level0 or cfg.packed_level1 or cfg.packed_compute:
        raise ValueError(
            "packed_level0/packed_level1/packed_compute are TPU lane-padding "
            "workarounds (docs/PACKED.md); the PyTorch port runs the standard layout only"
        )
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16' (got {cfg.compute_dtype!r})")
    if not cfg.torch_bn_stats:
        raise ValueError("the PyTorch port keeps torch's unbiased running variance (torch_bn_stats=True)")


def build_generator(cfg: UDAConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Instantiate the segmentation generator alone (what evaluation needs)
    by its architecture's module, drawing its initial weights from
    ``generator`` (a CPU generator)."""
    check_config(cfg)
    return arch.load(cfg.arch).build_generator(cfg, generator, compute_dtype(cfg))


def build_models(cfg: UDAConfig, generator: Optional[torch.Generator] = None):
    """Instantiate the generator and the enabled discriminators, drawing
    their initial weights from ``generator`` (a CPU generator: the modules
    are built in host memory and :func:`create_train_state` moves them to
    its device)."""
    gen = build_generator(cfg, generator)
    dt = compute_dtype(cfg)
    d1 = UncertaintyDiscriminator(cfg.n_class, cfg.heinit, cfg.extd1, generator, dt) if cfg.d1 else None
    d2 = UncertaintyDiscriminator(cfg.n_class, cfg.heinit, cfg.extd2, generator, dt) if cfg.d2 else None
    d4 = PointNetCls(feature_transform=cfg.ft, ext=cfg.extd4, generator=generator, compute_dtype=dt) if cfg.d4 else None
    return gen, d1, d2, d4


def _sgd(module, lr: float, momentum: float) -> torch.optim.SGD:
    return torch.optim.SGD(module.parameters(), lr=lr, momentum=momentum, weight_decay=5e-4)


def build_optimizers(cfg: UDAConfig, models):
    gen, d1, d2, d4 = models
    # the reference hardcodes momentum .95 under -sgd; its -mmt flag reaches
    # only the appendix string (src/train_mmwhs.py:453-459 vs :744-745)
    gen_opt = (
        _sgd(gen, cfg.lr, 0.95)
        if cfg.sgd
        else torch.optim.Adam(gen.parameters(), lr=cfg.lr, betas=(0.9, 0.99), eps=1e-8)
    )
    d1_opt = _sgd(d1, cfg.d1lr, cfg.disc_momentum("d1")) if d1 is not None else None
    d2_opt = _sgd(d2, cfg.d2lr, cfg.disc_momentum("d2")) if d2 is not None else None
    d4_opt = _sgd(d4, cfg.d4lr, cfg.disc_momentum("d4")) if d4 is not None else None
    return gen_opt, d1_opt, d2_opt, d4_opt
