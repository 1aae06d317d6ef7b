"""Frozen copy of the train branch of
``pointcloududa_torch/train/loop.py:make_device_preprocess`` (augment,
regenerate the MM-WHS clouds, normalise, centre-crop, one-hot), with the
plain FPS in the kernel's place, and the trainer's random generators as
``UDATrainer.__init__`` and ``create_train_state`` seed them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import augment as augment_lib
from perfbench.reference.config import UDAConfig
from perfbench.reference.pointcloud import draw_starts, masks_to_point_clouds_from_starts


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def generators(seed: int, device) -> dict:
    """The trainer's generators from its seed: the device augmentation's
    (seed + 17), the host decisions of the heavy and medium pipelines
    (seed + 19, on the CPU) and the dropout masks (seed + 1)."""
    return {
        "aug": torch.Generator(device=device).manual_seed(seed + 17),
        "aug_host": torch.Generator().manual_seed(seed + 19),
        "dropout": torch.Generator(device=device).manual_seed(seed + 1),
    }


def make_device_preprocess(cfg: UDAConfig, device, device_augment: bool = True):
    """``process_train(generator, raw, with_vert_t=True, draws=None,
    host_generator=None)`` of the port, on ``device``."""
    device = torch.device(device)
    aug_cfg = {"heavy": augment_lib.heavy(), "aug2": augment_lib.medium(), "light": augment_lib.light()}.get(cfg.aug)
    use_aug = bool(device_augment and aug_cfg)
    is_png = cfg.workload == "mscmrseg"
    # MM-WHS + augmentation + point head: regenerate clouds on device from
    # the warped masks (the reference does this per sample on the host via
    # mcubes+python FPS, data_generator_mmwhs.py:256-264). MS-CMRSeg keeps
    # precomputed clouds regardless of warping (parity: its generator loads
    # vertex files unconditionally).
    regen_verts = use_aug and cfg.point_head and cfg.workload == "mmwhs"

    def tensors(raw) -> Dict[str, torch.Tensor]:
        # a tensor that a prefetcher already put on the device passes through untouched
        return to_device(raw, device)

    def crop(x):
        h = x.shape[1]
        if h > cfg.crop_size:
            o = (h - cfg.crop_size) // 2
            return x[:, o : o + cfg.crop_size, o : o + cfg.crop_size]
        return x

    def norm_img(img):
        if is_png:
            return img.to(torch.float32) / 255.0
        return img.to(torch.float32)

    def one_hot(mask):
        classes = torch.arange(cfg.n_class, device=mask.device)
        return (mask[..., None] == classes).to(torch.float32)

    def aug_pair(generator, host_generator, img, mask, draws):
        if not use_aug:
            return img.to(torch.float32), mask
        if draws is None:
            b = img.shape[0]
            draws = augment_lib.sample_draws(generator, aug_cfg, b, img.device,
                                             tuple(img.shape[1:]), host_generator)
        if is_png:
            return augment_lib.augment_from_draws(aug_cfg, img, mask, draws)
        lo, hi = torch.min(img), torch.max(img)
        scaled = (img - lo) * 255.0 / (hi - lo + 1e-12)
        out, mask = augment_lib.augment_from_draws(aug_cfg, scaled, mask, draws)
        return lo + out * (hi - lo + 1e-12) / 255.0, mask

    def cloud(generator, mask, starts):
        if starts is None:
            starts = draw_starts(mask, generator)
        return masks_to_point_clouds_from_starts(mask, starts) / 255.0

    @torch.no_grad()
    def process_train(generator: Optional[torch.Generator], raw, with_vert_t: bool = True, draws=None,
                      host_generator: Optional[torch.Generator] = None):
        raw = tensors(raw)
        draws = draws or {}
        vert_t_on = cfg.vert_t_metric and with_vert_t
        img_s, mask_s = aug_pair(generator, host_generator, raw["img_s"], raw["mask_s"].to(torch.int32), draws.get("aug_s"))
        mask_t = raw["mask_t"].to(torch.int32) if (regen_verts and "mask_t" in raw) else None
        img_t, mask_t = aug_pair(generator, host_generator, raw["img_t"], mask_t, draws.get("aug_t"))
        batch = {
            "img_s": crop(norm_img(img_s)),
            "mask_s": one_hot(crop(mask_s)),
            "img_t": crop(norm_img(img_t)),
        }
        if regen_verts and mask_t is not None:
            batch["vert_s"] = cloud(generator, mask_s, draws.get("starts_s"))
            if vert_t_on:  # target clouds feed a logged-only metric
                batch["vert_t"] = cloud(generator, mask_t, draws.get("starts_t"))
        else:
            if "vert_s" in raw:
                batch["vert_s"] = raw["vert_s"].to(torch.float32) / 255.0
            if "vert_t" in raw and vert_t_on:
                batch["vert_t"] = raw["vert_t"].to(torch.float32) / 255.0
        if "sample_mask" in raw:
            batch["sample_mask"] = raw["sample_mask"].to(torch.float32)
        return batch

    return process_train
