"""Wire manifests + adapters + samplers into trainer-ready pipelines
(counterpart of the JAX package's ``data/build.py``).

Mirrors the generator wiring of the reference ``get_generators``
(``src/train_mscmrseg.py:26-50``, ``src/train_mmwhs.py:26-48``):
five streams: source-train, source-val, target-train, target-val, and
"testB" (a full no-aug pass over target-train used as the third validation
set each epoch).

Augmentation runs on the device only: ``device_augment=False`` and
``host_cloud_regen=True`` ask for the host pipelines (cv2, the host FPS
library), which are not ported, and raise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.data.loader import BatchAssembler, PairedIterator, shard_index_batch
from pointcloududa_torch.data.manifest import load_ids
from pointcloududa_torch.data.mmwhs import MMWHSAdapter
from pointcloududa_torch.data.mscmrseg import MSCMRSegAdapter
from pointcloududa_torch.data.sampler import RingSampler


def _no_host_pipeline(what: str) -> None:
    raise NotImplementedError(
        f"{what} asks for the host augmentation pipeline (ops/host_augment.py, data/pointcloud.py), "
        "which is not ported: ROADMAP Queue 1 items 9 and 10; augment on the device instead"
    )


def _val_iter_factory(adapter, batch_size: int, workers: int, seed: int, row_shard=None) -> Callable:
    sampler = RingSampler(len(adapter), batch_size, n_samples=-1, shuffle_seed=seed)
    assemble = BatchAssembler(adapter, workers=workers)

    def make():
        for idx in sampler.epoch():
            if row_shard is None:
                yield assemble(idx)
            else:
                lo, hi, target = row_shard
                local_idx, mask = shard_index_batch(idx, lo, hi, target)
                batch = assemble(local_idx)
                batch["sample_mask"] = mask
                yield batch

    return make


def build_mscmrseg_pipelines(cfg: UDAConfig, workers: int = 4, device_augment: bool = True,
                             row_shard=None):
    """Returns (train_iter, val_iters). Augmentation runs on the device
    (MS-CMRSeg vertices are precomputed and deliberately NOT re-derived from
    warped masks: the reference loads them from files regardless of
    augmentation, ``data_generator_mscmrseg.py:266,296-302``).

    ``row_shard=(lo, hi, target)``: multi-host operation, where all processes
    run identical samplers but each decodes only its global-batch row slice
    (``loader.shard_index_batch``).
    """
    if not device_augment:
        _no_host_pipeline("device_augment=False")
    d = cfg.data_dir
    ids_train = load_ids(os.path.join(d, "aug_trainA.csv"))
    ids_valid = load_ids(os.path.join(d, "testA.csv"))
    ids_train_lge = load_ids(os.path.join(d, "aug_trainB.csv"))
    ids_valid_lge = load_ids(os.path.join(d, "testB.csv"))

    vert = cfg.point_head
    mk = lambda ids, source, phase: MSCMRSegAdapter(  # noqa: E731
        data_dir=d, ids=ids, source=source, phase=phase, load_vertices=vert
    )
    train_iter = PairedIterator(
        RingSampler(len(ids_train), cfg.bs, cfg.ns, shuffle_seed=cfg.seed),
        RingSampler(len(ids_train_lge), cfg.bs, cfg.ns, shuffle_seed=cfg.seed + 1),
        BatchAssembler(mk(ids_train, "source", "train"), workers),
        BatchAssembler(mk(ids_train_lge, "target", "train"), workers),
        seed=cfg.seed,
        row_shard=row_shard,
    )
    val_iters: Dict[str, Callable] = {
        "val": _val_iter_factory(mk(ids_valid, "source", "valid"), cfg.bs, workers, cfg.seed + 2, row_shard),
        "val_lge": _val_iter_factory(mk(ids_valid_lge, "target", "valid"), cfg.bs, workers, cfg.seed + 3, row_shard),
        "test_lge": _val_iter_factory(mk(ids_train_lge, "target", "train"), cfg.bs, workers, cfg.seed + 4, row_shard),
    }
    return train_iter, val_iters


def build_mmwhs_pipelines(
    cfg: UDAConfig, workers: int = 4, device_augment: bool = True, host_cloud_regen: bool = False,
    row_shard=None,
):
    """Returns (train_iter, val_iters, used_device_augment).

    When augmentation is on AND the point head is enabled, vertex clouds
    must be regenerated from the *warped* masks
    (``data_generator_mmwhs.py:256-264``). Everything stays on the device: the
    preprocess warps both streams' masks and rebuilds the clouds with the
    farthest-point-sampling kernel (``ops/pointcloud_device.py``), so the
    train streams ship their masks and no precomputed clouds.
    """
    if host_cloud_regen:
        _no_host_pipeline("host_cloud_regen=True")
    if cfg.aug and not device_augment:
        _no_host_pipeline("device_augment=False")
    d = cfg.data_dir
    mr_train = load_ids(os.path.join(d, "mr_train_list.csv"))
    mr_valid = load_ids(os.path.join(d, "mr_val_list.csv"))
    ct_train = load_ids(os.path.join(d, "ct_train_list.csv"))
    ct_valid = load_ids(os.path.join(d, "ct_val_list.csv"))

    vert = cfg.point_head

    def mk(ids, source, phase, mh, load_vert=None):
        if load_vert is None:
            # train streams under augmentation discard the precomputed
            # clouds (regenerated from warped masks on the device), so skip
            # loading them; validation never augments and always needs them
            # when the point head is on
            load_vert = vert and (phase == "valid" or not cfg.aug)
        return MMWHSAdapter(
            data_dir=d,
            ids=ids,
            source=source,
            phase=phase,
            load_vertices=load_vert,
            match_hist=mh,
        )

    train_iter = PairedIterator(
        RingSampler(len(mr_train), cfg.bs, cfg.ns, shuffle_seed=cfg.seed),
        RingSampler(len(ct_train), cfg.bs, cfg.ns, shuffle_seed=cfg.seed + 1),
        BatchAssembler(mk(mr_train, "source", "train", cfg.mh), workers),
        BatchAssembler(mk(ct_train, "target", "train", False), workers),
        seed=cfg.seed,
        row_shard=row_shard,
    )
    val_iters: Dict[str, Callable] = {
        "val": _val_iter_factory(mk(mr_valid, "source", "valid", cfg.mh), cfg.bs, workers, cfg.seed + 2, row_shard),
        "val_lge": _val_iter_factory(mk(ct_valid, "target", "valid", False), cfg.bs, workers, cfg.seed + 3, row_shard),
        "test_lge": _val_iter_factory(
            mk(ct_train, "target", "train", False, load_vert=vert), cfg.bs, workers, cfg.seed + 4, row_shard
        ),
    }
    return train_iter, val_iters, device_augment
