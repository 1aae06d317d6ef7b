"""The device preprocess of the training loop (counterpart of
``pointcloududa_tpu/train/loop.py:make_device_preprocess``): raw host batch
-> model batch, on the accelerator.

Pipeline shape per step: the host ships raw arrays (uint8 slices for
MS-CMRSeg, volume-normalised floats for MM-WHS, integer label masks, 0..255
vertex clouds); the *device preprocess* augments, regenerates the point
clouds of warped MM-WHS masks, normalises, centre-crops and one-hots; the
5-phase UDA step (``train/step.py``) consumes the result. The trainer around
the two (``UDATrainer`` in the JAX package) is still to be ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.ops import augment as augment_lib
from pointcloududa_torch.ops.pointcloud_device import (
    draw_starts,
    masks_to_point_clouds_from_starts,
)
from pointcloududa_torch.utils.device import resolve_device


def make_device_preprocess(cfg: UDAConfig, train: bool, device_augment: bool, device=None, fps_impl: str = "auto"):
    """Raw-batch -> model-batch transform on ``device`` (``None`` = the
    current CUDA device; raises without one).

    Order of operations matches the reference data generators: augment (on
    0..255-scale values) -> normalise -> centre-crop -> one-hot
    (``data_generator_mscmrseg.py:305-317``). MM-WHS float slices are
    min-max mapped to 0..255 around augmentation and back
    (``data_generator_mmwhs.py:245-254``); without augmentation they pass
    through untouched (already volume-normalised upstream).

    ``train=True`` returns ``process_train(generator, raw, with_vert_t=True,
    draws=None)``: ``generator`` is a ``torch.Generator`` on ``device``;
    ``with_vert_t=False`` drops the logged-only target cloud (the
    ``cfg.vert_t_every`` cadence gate); ``draws`` replays recorded random
    draws instead of drawing (``{"aug_s", "aug_t"}``: dictionaries of
    ``ops.augment.sample_draws``; ``{"starts_s", "starts_t"}``: FPS start
    indices), which is how the tests feed both packages the same numbers.
    ``train=False`` returns ``process_eval(raw)``.

    ``fps_impl`` goes to ``masks_to_point_clouds_from_starts``: ``"auto"``
    launches the FPS kernel on the card; ``"plain"`` is what the checks on
    the card hold it against.
    """
    device = resolve_device(device)
    aug_cfg = {"heavy": augment_lib.heavy(), "aug2": augment_lib.medium(), "light": augment_lib.light()}.get(cfg.aug)
    use_aug = bool(train and device_augment and aug_cfg)
    if use_aug:
        augment_lib.make_augment_fn(aug_cfg)  # raises for a pipeline that is not ported
    is_png = cfg.workload == "mscmrseg"
    # MM-WHS + augmentation + point head: regenerate clouds on device from
    # the warped masks (the reference does this per sample on the host via
    # mcubes+python FPS, data_generator_mmwhs.py:256-264). MS-CMRSeg keeps
    # precomputed clouds regardless of warping (parity: its generator loads
    # vertex files unconditionally).
    regen_verts = use_aug and cfg.point_head and cfg.workload == "mmwhs"

    def tensors(raw) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=device) for k, v in raw.items()}

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

    def aug_pair(generator, img, mask, draws):
        if not use_aug:
            return img.to(torch.float32), mask
        if draws is None:
            draws = augment_lib.sample_draws(generator, aug_cfg, img.shape[0], img.device)
        if is_png:
            return augment_lib.augment_from_draws(aug_cfg, img, mask, draws)
        lo, hi = torch.min(img), torch.max(img)
        scaled = (img - lo) * 255.0 / (hi - lo + 1e-12)
        out, mask = augment_lib.augment_from_draws(aug_cfg, scaled, mask, draws)
        return lo + out * (hi - lo + 1e-12) / 255.0, mask

    def cloud(generator, mask, starts):
        if starts is None:
            starts = draw_starts(mask, generator)
        return masks_to_point_clouds_from_starts(mask, starts, impl=fps_impl) / 255.0

    @torch.no_grad()
    def process_train(generator: Optional[torch.Generator], raw, with_vert_t: bool = True, draws=None):
        raw = tensors(raw)
        draws = draws or {}
        vert_t_on = cfg.vert_t_metric and with_vert_t
        img_s, mask_s = aug_pair(generator, raw["img_s"], raw["mask_s"].to(torch.int32), draws.get("aug_s"))
        mask_t = raw["mask_t"].to(torch.int32) if (regen_verts and "mask_t" in raw) else None
        img_t, mask_t = aug_pair(generator, raw["img_t"], mask_t, draws.get("aug_t"))
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

    @torch.no_grad()
    def process_eval(raw):
        raw = tensors(raw)
        batch = {
            "img": crop(norm_img(raw["img"])),
            "mask": one_hot(crop(raw["mask"].to(torch.int32))),
        }
        if "vert" in raw:
            batch["vert"] = raw["vert"].to(torch.float32) / 255.0
        if "sample_mask" in raw:
            batch["sample_mask"] = raw["sample_mask"].to(torch.float32)
        return batch

    return process_train if train else process_eval
