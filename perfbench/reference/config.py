"""Frozen copy of ``pointcloududa_torch/config.py`` (the benchmark's reference;
imports nothing of the program; later changes to the program do not reach it).

Structured configuration for the UDA engine: the port's copy of the JAX
package's ``pointcloududa_tpu/config.py``, field for field. The checkpoint
naming and JSON round trip of the original are left out: the benchmark
neither names nor saves checkpoints. One field is ahead of the port:
``arch``, the generator's architecture (``reference/arch/<arch>.py``); the
port gains the same name and default in the change that adds a second
architecture.
"""

from __future__ import annotations

import dataclasses

from perfbench.reference import arch as _arch


@dataclasses.dataclass(frozen=True)
class UDAConfig:
    """Static configuration of the 5-phase UDA train step.

    Field names follow the reference flags (SURVEY.md §2.5).
    """

    # workload
    workload: str = "mscmrseg"  # "mscmrseg" | "mmwhs"
    n_class: int = 4
    in_channels: int = 3
    crop_size: int = 224  # image H=W fed to the model
    fc_inch: int = 81  # point-head flatten width (81 @224, 121 @256)

    # generator
    arch: str = "unet"  # ahead of the port: the file reference/arch/<arch>.py builds it
    filters: int = 32
    n_block: int = 4
    bottleneck_depth: int = 4
    drop: bool = False
    heinit: bool = False
    cvinit: bool = False
    batchnorm: bool = True
    extpn: bool = False

    # adversaries
    d1: bool = False
    d2: bool = False
    d4: bool = False
    d4aux: bool = False
    extd1: bool = False
    extd2: bool = False
    extd4: bool = False
    ft: bool = False  # STNkd feature transform in D4

    # loss semantics
    softmax: bool = False  # MM-WHS CE-on-softmax variant (else sigmoid+BCE)
    entropy_norm: bool = False  # divide entropy maps by log(C) (MM-WHS)
    d1_on_probs: bool = False  # D1 sees activations (MM-WHS) vs raw logits
    etpls: bool = False  # direct entropy minimisation on source
    Tetpls: bool = False  # direct entropy minimisation on target
    dr: float = 0.01  # adversarial loss ratio for the generator
    wp: float = 1.0  # point-cloud (chamfer) weight
    w1: float = 1.0
    w2: float = 1.0
    w4: float = 1.0

    # optimisers
    lr: float = 1e-3
    lr_fix: float = 1e-3
    sgd: bool = False  # SGD for the generator instead of Adam (MM-WHS -sgd)
    mmt: float = 0.95  # generator SGD momentum
    d1lr: float = 2.5e-5
    d2lr: float = 2.5e-5
    d4lr: float = 2.5e-5
    dmmt: float = 0.95  # shared discriminator momentum override
    d1mmt: float = 0.95
    d2mmt: float = 0.95
    d4mmt: float = 0.95
    offdecay: bool = True  # True => step-decay ON (flag parity: store_false)
    decay_e: int = 50  # epochs between x0.2 generator lr decays

    # schedule
    bs: int = 16
    ns: int = 2000  # samples per epoch
    epochs: int = 200
    seed: int = 0
    apdx: str = "train_point_tpu"
    max_hours: float = 24.0  # wall-clock budget (reference 24h cluster limit)
    load_weight: bool = False  # warm restart from the last checkpoint
    patience: int = 0  # early stopping on val_lge_dice (0 = off; the
    # reference defines EarlyStoppingCallback but never wires it)

    # data
    aug: str = "heavy"  # '', 'heavy', 'light'/'aug2' per workload
    mh: bool = False  # histogram matching (MM-WHS)
    data_dir: str = "./input"

    # implementation knobs (no reference equivalent). The names and values
    # are the JAX package's; what each selects in this package:
    compute_dtype: str = "float32"  # or "bfloat16", the training CLIs' default
    num_devices: int = 0  # 0 = all visible devices
    # Chamfer loss: "pallas" = the hand-written CUDA kernels
    # (csrc/chamfer.cu); "auto" and "jnp" = the plain PyTorch loss
    chamfer_impl: str = "auto"
    # space-to-depth packed layouts of the JAX package; the port rejects them
    packed_level0: bool = False
    packed_level1: bool = False
    packed_compute: bool = False
    # BN batch statistics: "pallas" = the hand-written CUDA kernels
    # (csrc/bn_stats.cu), single device only; "xla" = the plain reduction
    bn_stats_impl: str = "xla"
    # compute the logged-only target-domain chamfer diagnostic
    # (``loss_vert_target`` -- the reference computes it but only
    # ``.item()``-logs it, never backprops: src/train_mscmrseg.py:230-231,
    # src/train_mmwhs.py:257-258). True = reference parity. On the MM-WHS
    # device-augment + point-head path its input is the on-device TARGET
    # cloud regeneration; turning this off skips that without touching any
    # gradient.
    vert_t_metric: bool = True
    # cadence of that diagnostic: compute it on steps where
    # ``step % vert_t_every == 0`` (per-epoch step counter; 1 = every step =
    # exact reference parity). Epoch means of ``ver_t_loss`` average only
    # the sampled steps. Ignored when ``vert_t_metric`` is False.
    vert_t_every: int = 1
    # torch-exact BatchNorm running-variance update: the unbiased (n/(n-1))
    # batch variance of nn.BatchNorm2d (reference src/networks/unet.py:28).
    # The port rejects False.
    torch_bn_stats: bool = True
    # NaN guard: stand-in for the reference's always-on
    # torch.autograd.set_detect_anomaly (train_mscmrseg.py:703); opt-in
    # because it forces sync checks
    debug_nans: bool = False

    def __post_init__(self):
        _arch.check(self.arch)
        if self.vert_t_every < 1:
            raise ValueError(
                f"vert_t_every must be >= 1 (got {self.vert_t_every}); use "
                "vert_t_metric=False to disable the diagnostic entirely"
            )

    @property
    def point_head(self) -> bool:
        return self.d4 or self.d4aux

    def disc_momentum(self, which: str) -> float:
        per = {"d1": self.d1mmt, "d2": self.d2mmt, "d4": self.d4mmt}[which]
        # reference: per-disc momentum applies only when dmmt is default
        # (train_mmwhs.py:471,479,487)
        return per if self.dmmt == 0.95 else self.dmmt


def mscmrseg_default(**overrides) -> UDAConfig:
    base = dict(
        workload="mscmrseg",
        n_class=4,
        crop_size=224,
        fc_inch=81,
        entropy_norm=False,
        d1_on_probs=False,
        # the reference hardcodes SGD momentum .99 (wd 5e-4) for all three
        # discriminators and exposes no flags for it
        # (src/train_mscmrseg.py:434-454); MM-WHS keeps the 0.95 flag
        # defaults (src/train_mmwhs.py:466-489)
        d1mmt=0.99,
        d2mmt=0.99,
        d4mmt=0.99,
    )
    base.update(overrides)
    return UDAConfig(**base)


def mmwhs_default(**overrides) -> UDAConfig:
    base = dict(
        workload="mmwhs",
        n_class=5,
        crop_size=256,
        fc_inch=121,
        entropy_norm=True,
        d1_on_probs=True,
        aug="",
    )
    base.update(overrides)
    return UDAConfig(**base)
