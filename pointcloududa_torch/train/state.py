"""Train state and reference-parity optimisers (counterpart of
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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.models import PointNetCls, SegmentationPointModel, UncertaintyDiscriminator
from pointcloududa_torch.utils.device import resolve_device


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


def build_generator(cfg: UDAConfig, generator: Optional[torch.Generator] = None) -> SegmentationPointModel:
    """Instantiate the segmentation generator alone (what evaluation needs),
    drawing its initial weights from ``generator`` (a CPU generator)."""
    check_config(cfg)
    return SegmentationPointModel(
        filters=cfg.filters,
        in_channels=cfg.in_channels,
        n_block=cfg.n_block,
        bottleneck_depth=cfg.bottleneck_depth,
        n_class=cfg.n_class,
        pointnet=cfg.point_head,
        fc_inch=cfg.fc_inch,
        extpn=cfg.extpn,
        batchnorm=cfg.batchnorm,
        drop=cfg.drop,
        heinit=cfg.heinit,
        generator=generator,
        compute_dtype=compute_dtype(cfg),
    )


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


def create_train_state(cfg: UDAConfig, seed: int = 0, device=None) -> UDATrainState:
    """Initialise all networks and their optimisers on ``device``: ``None``
    means the current CUDA device and raises when there is none; pass
    ``device="cpu"`` to run on the CPU. The initial weights are drawn in host
    memory from ``seed``, so they do not depend on the device."""
    device = resolve_device(device)
    init_gen = torch.Generator().manual_seed(seed)
    models = tuple(m.to(device) if m is not None else None for m in build_models(cfg, init_gen))
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return UDATrainState(models, build_optimizers(cfg, models), 0, dropout_gen)


def set_generator_lr(state: UDATrainState, lr: float) -> UDATrainState:
    """Host-side lr change for the x0.2 step decay."""
    for group in state.optimizers[0].param_groups:
        group["lr"] = lr
    return state


def get_generator_lr(state: UDATrainState) -> float:
    return float(state.optimizers[0].param_groups[0]["lr"])
