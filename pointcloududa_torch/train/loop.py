"""The training loop: one engine for both workloads (counterpart of
``pointcloududa_tpu/train/loop.py``).

The reference duplicates ~80% of its logic between ``train_mscmrseg.py`` and
``train_mmwhs.py`` (SURVEY.md §1); here a single :class:`UDATrainer` is
parameterised by :class:`UDAConfig` and the dataset adapters.

Pipeline shape per step (vs the reference's synchronous host loop with
per-step H2D copies, ``train_mscmrseg.py:183-330``):

  host workers decode raw arrays (uint8 slices for MS-CMRSeg,
  volume-normalised floats for MM-WHS, integer label masks, 0..255 vertex
  clouds) -> a prefetch thread copies them to the card one batch ahead ->
  the *device preprocess* (:func:`make_device_preprocess`: augment,
  regenerate the point clouds of warped MM-WHS masks, normalise, centre-crop,
  one-hot) -> the 5-phase UDA step (``train/step.py``). The host never reads
  a device result inside the epoch: metrics stay on the device and are
  fetched once per epoch.

On the card the preprocess runs on a high-priority stream of the trainer's
own, so that its many small kernels run beside the step's CUDA graphs, and
the host launches batch i's preprocess while the card runs step i-1. Before
it does, the host waits for step i-2 to finish: the card always holds a
whole step to hide the host's launches behind, and no more batches wait in
device memory than that. The draws are made in the same
order on the same generators, so the batches are bit for bit those the main
stream would make.

Epoch cadence parity: validation over (source-val, target-val, target-train)
every epoch (``train_mscmrseg.py:102-139``), checkpoint monitor =
``val_lge_dice`` mode=max, generator lr x0.2 every ``decay_e`` epochs, and a
wall-clock stop with the MM-WHS adaptive margin (``train_mmwhs.py:673-675``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from pointcloududa_torch.config import UDAConfig, appendix
from pointcloududa_torch.data.loader import BatchPadder, DevicePrefetcher, to_device
from pointcloududa_torch.ops import augment as augment_lib
from pointcloududa_torch.ops.pointcloud_device import (
    draw_starts,
    masks_to_point_clouds_from_starts,
)
from pointcloududa_torch.parallel import collectives, mesh_is_multiprocess, replicate
from pointcloududa_torch.train import checkpoint as ckpt_lib
from pointcloududa_torch.train.state import create_train_state, get_generator_lr, set_generator_lr
from pointcloududa_torch.train.step import make_eval_step, make_train_step
from pointcloududa_torch.utils.device import resolve_device
from pointcloududa_torch.utils.logging import MetricWriter
from pointcloududa_torch.utils import timer
from pointcloududa_torch.utils.timer import trace_annotation


def make_device_preprocess(cfg: UDAConfig, train: bool, device_augment: bool, device=None, mesh=None):
    """Raw-batch -> model-batch transform on ``device`` (``None`` = the
    current CUDA device; raises without one).

    Order of operations matches the reference data generators: augment (on
    0..255-scale values) -> normalise -> centre-crop -> one-hot
    (``data_generator_mscmrseg.py:305-317``). MM-WHS float slices are
    min-max mapped to 0..255 around augmentation and back
    (``data_generator_mmwhs.py:245-254``); without augmentation they pass
    through untouched (already volume-normalised upstream).

    ``train=True`` returns ``process_train(generator, raw, with_vert_t=True,
    draws=None, host_generator=None)``: ``generator`` is a ``torch.Generator``
    on ``device``; ``host_generator`` a CPU one, for the decisions the heavy
    and medium pipelines take on the host (the orders, the SomeOf members
    that fire; ``ops.augment.sample_draws``), needed when ``generator`` is
    not itself on the CPU; ``with_vert_t=False`` drops the logged-only
    target cloud (the ``cfg.vert_t_every`` cadence gate); ``draws`` replays
    recorded random draws instead of drawing (``{"aug_s", "aug_t"}``:
    dictionaries of ``ops.augment.sample_draws``; ``{"starts_s",
    "starts_t"}``: FPS start indices), which is how the tests feed both
    packages the same numbers. ``train=False`` returns ``process_eval(raw)``.
    A train call on a batch already on the card does not wait for the card
    (``chip_smoke.py`` phase (h) checks it for the heavy pipeline).

    ``mesh``: a data mesh whose rank holds rows ``lo:hi`` of each global
    batch. Every random draw (the augmentations', the FPS starts') is then
    made for the global batch, in the one-process run's calls, shapes and
    order, and the rank keeps its rows, so the generators stay in step on
    every rank and each rank's rows are the one-process run's; MM-WHS's
    min-max scaling takes the global batch's extremes. Replayed ``draws`` are
    the rank's own rows.
    """
    device = resolve_device(device)
    aug_cfg = {"heavy": augment_lib.heavy(), "aug2": augment_lib.medium(), "light": augment_lib.light()}.get(cfg.aug)
    use_aug = bool(train and device_augment and aug_cfg)
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
            draws = augment_lib.sample_draws(generator, aug_cfg, collectives.global_batch_size(b), img.device,
                                             tuple(img.shape[1:]), host_generator)
            draws = augment_lib.draw_rows(draws, *collectives.own_range(b))
        if is_png:
            return augment_lib.augment_from_draws(aug_cfg, img, mask, draws)
        lo, hi = collectives.global_min(torch.min(img)), collectives.global_max(torch.max(img))
        scaled = (img - lo) * 255.0 / (hi - lo + 1e-12)
        out, mask = augment_lib.augment_from_draws(aug_cfg, scaled, mask, draws)
        return lo + out * (hi - lo + 1e-12) / 255.0, mask

    def cloud(generator, mask, starts):
        if starts is None:
            starts = draw_starts(mask, generator)
        return masks_to_point_clouds_from_starts(mask, starts) / 255.0

    span = trace_annotation(timer.PREPROCESS)
    span_augment, span_clouds, span_finish = map(trace_annotation, timer.PREPROCESS_PARTS)

    @torch.no_grad()
    def process_train(generator: Optional[torch.Generator], raw, with_vert_t: bool = True, draws=None,
                      host_generator: Optional[torch.Generator] = None):
        with span:
            raw = tensors(raw)
            draws = draws or {}
            vert_t_on = cfg.vert_t_metric and with_vert_t
            with span_augment:
                img_s, mask_s = aug_pair(generator, host_generator, raw["img_s"], raw["mask_s"].to(torch.int32),
                                         draws.get("aug_s"))
                mask_t = raw["mask_t"].to(torch.int32) if (regen_verts and "mask_t" in raw) else None
                img_t, mask_t = aug_pair(generator, host_generator, raw["img_t"], mask_t, draws.get("aug_t"))
            clouds = {}
            if regen_verts and mask_t is not None:
                with span_clouds:
                    clouds["vert_s"] = cloud(generator, mask_s, draws.get("starts_s"))
                    if vert_t_on:  # target clouds feed a logged-only metric
                        clouds["vert_t"] = cloud(generator, mask_t, draws.get("starts_t"))
            with span_finish:
                batch = {
                    "img_s": crop(norm_img(img_s)),
                    "mask_s": one_hot(crop(mask_s)),
                    "img_t": crop(norm_img(img_t)),
                }
                if regen_verts and mask_t is not None:
                    batch.update(clouds)
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

    return collectives.within(mesh, process_train if train else process_eval)


def _fetch_means(history: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per-key means of a list of metric dictionaries of 0-d device tensors,
    with one transfer to the host for the whole list. A key that only some
    entries have (``ver_t_loss`` on cadence steps) is averaged over those."""
    if not history:
        return {}
    names = [(i, k) for i, m in enumerate(history) for k in sorted(m)]
    flat = torch.stack([history[i][k].detach().to(torch.float32).reshape(()) for i, k in names]).cpu().numpy()
    by_key: Dict[str, list] = {}
    for (_, k), v in zip(names, flat):
        by_key.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in by_key.items()}


class UDATrainer:
    """End-to-end UDA training with validation, checkpoints and logging.

    ``train_iter``: object with ``.epoch()`` yielding raw host batches and
    ``.steps_per_epoch``. ``val_iters``: mapping of
    {"val": fn, "val_lge": fn, "test_lge": fn} each returning a fresh
    iterator of raw eval batches. ``device=None`` is the current CUDA device
    (raising without one); ``place`` copies a raw host batch to the device
    and defaults to a copy of every array.

    ``mesh`` (``parallel.create_mesh``): data-parallel training. The trainer
    runs on ``mesh.device`` and takes the one-process step over the global
    batch, of which this rank's loaders decode its own rows (build them with
    ``row_shard=parallel.trainer_row_shard(mesh, cfg.bs)``). The state is
    replicated from rank 0 after it is built and after a restore, and every
    rank validates over the global batch, so every rank takes the same
    checkpoint, decay and early-stopping decisions. Rank 0 writes
    ``workdir`` and ``logdir``; rank i writes under their ``.rank{i}``
    (``checkpoint.rank_dir``).
    """

    def __init__(
        self,
        cfg: UDAConfig,
        train_iter,
        val_iters: Dict[str, Callable[[], Iterable]],
        workdir: str = "weights",
        logdir: str = "runs",
        mesh=None,
        device_augment: bool = True,
        place: Optional[Callable] = None,
        device=None,
    ):
        self.cfg = cfg
        self.train_iter = train_iter
        self.val_iters = val_iters
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # tail batches are wrap-padded to a multiple of the mesh (and to the
        # stream's full batch size) with a sample_mask; see data.loader.BatchPadder.
        # On a multi-process mesh padding already happened at index level
        # (loader.shard_index_batch wrap-pads the GLOBAL batch before slicing
        # this rank's rows), so the host-side padder must stay a no-op
        self._pad_multiple = mesh.world_size if mesh is not None else 1
        if mesh is not None and mesh_is_multiprocess(mesh):
            self._pad_multiple = 1
            if getattr(train_iter, "_row_shard", True) is None:
                raise ValueError("a multi-process mesh needs loaders that decode this rank's rows: build them with "
                                 "row_shard=parallel.trainer_row_shard(mesh, cfg.bs)")
        self._rank = mesh.rank if mesh is not None else 0
        workdir, logdir = ckpt_lib.rank_dir(workdir, self._rank), ckpt_lib.rank_dir(logdir, self._rank)
        self.appendix = appendix(cfg)
        if cfg.debug_nans:
            # NaN guard: what the reference has always on (train_mscmrseg.py:703)
            torch.autograd.set_detect_anomaly(True)

        self.state = create_train_state(cfg, seed=cfg.seed, device=self.device)
        self.gen = self.state.models[0]
        self.train_step = make_train_step(cfg, self.state.models, self.state.optimizers, mesh=mesh)
        self.eval_step = make_eval_step(cfg, self.gen, mesh=mesh)
        self.pre_train = make_device_preprocess(cfg, train=True, device_augment=device_augment, device=self.device, mesh=mesh)
        self.pre_eval = make_device_preprocess(cfg, train=False, device_augment=False, device=self.device, mesh=mesh)
        self.place = place if place is not None else (lambda b: to_device(b, self.device))
        self._iteration_span = trace_annotation(timer.ITERATION, iteration=True)
        # the preprocess's stream on the card (None on the CPU), scheduled ahead of the step's kernels
        self._pre_stream = torch.cuda.Stream(self.device, priority=-1) if self.device.type == "cuda" else None
        self._aug_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 17)
        # the heavy and medium pipelines' orders and SomeOf members, drawn on
        # the host so that it never waits for the device to learn them
        self._aug_host_gen = torch.Generator().manual_seed(cfg.seed + 19)
        self.replicate_state()

        self.writer = MetricWriter(logdir, comment=self.appendix)
        mk = lambda name, best: ckpt_lib.ModelCheckpointCallback(  # noqa: E731
            mode="max",
            best_model_name=f"{workdir}/best_{name}_{self.appendix}",
            model_name=f"{workdir}/{name}_{self.appendix}",
            save_best=best,
            save_last_model=True,
            n_epochs=cfg.epochs,
        )
        self.ckpt_gen = mk("unet_model_checkpoint", best=True)
        self.ckpt_d1 = mk("out_dis", best=False) if cfg.d1 else None
        self.ckpt_d2 = mk("entropy_dis", best=False) if cfg.d2 else None
        self.ckpt_d4 = mk("point_dis", best=False) if cfg.d4 else None

        self.best = {"epoch": 0, "val_lge_dice": -1.0, "train": {}, "valid": {}}
        self._lr = cfg.lr
        self.early_stop = (
            ckpt_lib.EarlyStoppingCallback(cfg.patience, mode="max") if cfg.patience > 0 else None
        )

    def replicate_state(self) -> None:
        """Give every rank rank 0's train state and generators, raising if
        any rank held another (``parallel.replicate``); nothing without a
        mesh."""
        self.state = replicate(self.state, self.mesh, (self._aug_gen, self._aug_host_gen))

    # ------------------------------------------------------------------ #
    def train_epoch(self) -> Dict[str, float]:
        metrics_acc = []
        step = 0
        # a background thread decodes + places the next batch while the
        # device runs the current step (vs the reference's blocking host
        # loop); tail batches are padded + masked to a single static shape
        prefetch = DevicePrefetcher(place=self.place, depth=2, device=self.device)
        padder = BatchPadder(self._pad_multiple)
        every = self.cfg.vert_t_every
        batches = prefetch(map(padder, self.train_iter.epoch()))
        side = self._pre_stream
        main = torch.cuda.current_stream(self.device) if side is not None else None
        # events after the last two steps: the host waits for the older before it prepares the next batch, so the
        # card holds one step to hide the host's launches behind (more would hold more batches in device memory
        # and put the host's spans further from the card's work)
        older = newer = None
        timer.reset_spans()  # timer.per_iteration_ms reads this epoch's spans
        while True:
            with self._iteration_span as turn:
                if older is not None:
                    older.synchronize()
                # on the side stream (a no-op on the CPU): the prefetcher's copy is waited for there, the
                # preprocess's kernels are enqueued there
                with torch.cuda.stream(side):
                    raw = next(batches, None)  # the wait is the prefetcher's uda.queue_wait
                    if raw is None:
                        turn.discard()  # the stream's end: no iteration
                        break
                    # cadence of the logged-only target chamfer (vert_t_every):
                    # off-cadence steps drop vert_t, and with it the target
                    # cloud's regeneration and the diagnostic's launch
                    with_vt = every <= 1 or step % every == 0
                    batch = self.pre_train(self._aug_gen, raw, with_vert_t=with_vt, host_generator=self._aug_host_gen)
                if side is not None:
                    # the step waits for the batch; its memory, the side stream's, is not reused before the step
                    # has read it (DevicePrefetcher's rules)
                    main.wait_stream(side)
                    for v in batch.values():
                        v.record_stream(main)
                self.state, metrics = self.train_step(self.state, batch)
                if side is not None:
                    older, newer = newer, main.record_event()
                metrics_acc.append(metrics)  # 0-d tensors on the device: nothing is read here
            step += 1
        # key union: ver_t_loss is present only on cadence steps; its epoch
        # mean averages the sampled steps
        return _fetch_means(metrics_acc)

    def _validate_one(self, make_iter) -> Dict[str, float]:
        outs = []
        padder = BatchPadder(self._pad_multiple)
        for raw in make_iter():
            batch = self.pre_eval(self.place(padder(raw)))
            out = self.eval_step(batch)
            outs.append({k: v for k, v in out.items() if k != "logits"})
        return _fetch_means(outs)

    def validate(self) -> Dict[str, float]:
        r = {}
        a = self._validate_one(self.val_iters["val"])
        r["val_dice"], r["val_loss"], r["valid_vert_loss"] = a["dice"], a["loss"], a["vert_loss"]
        b = self._validate_one(self.val_iters["val_lge"])
        r["val_lge_dice"], r["val_lge_loss"] = b["dice"], b["loss"]
        r["val_lge_vert_loss"] = b["vert_loss"]
        c = self._validate_one(self.val_iters["test_lge"])
        r["test_lge_dice"], r["test_lge_loss"] = c["dice"], c["loss"]
        return r

    def print_epoch_result(self, tr, vr, epoch: int) -> None:
        cfg = self.cfg
        n = cfg.epochs
        line1 = (
            f"[{epoch}/{n}] train_loss: {tr.get('seg_loss', 0):.5f} "
            f"valid_loss: {vr['val_loss']:.5f} valid_lge_loss: {vr['val_lge_loss']:.5f} "
            f"test_lge_loss: {vr['test_lge_loss']:.5f} "
        )
        if cfg.point_head:
            line1 += f"vertex_s_loss: {tr.get('ver_s_loss', -1):.5f}, vertex_t_loss: {tr.get('ver_t_loss', -1):.5f} "
        line2 = (
            f"train_dice: {tr.get('seg_dice', 0):.5f} valid_dice: {vr['val_dice']:.5f} "
            f"valid_lge_dice: {vr['val_lge_dice']:.5f} test_lge_dice: {vr['test_lge_dice']:.5f} "
        )
        for d in ("1", "2", "4"):
            if tr.get(f"dis{d}_acc1") is not None:
                line2 += f"d{d}_acc1: {tr[f'dis{d}_acc1']:.5f} d{d}_acc2: {tr[f'dis{d}_acc2']:.5f} "
        print(line1)
        print(line2)

    # ------------------------------------------------------------------ #
    _NETS = ("gen", "d1", "d2", "d4")

    def save_full(self, path: str, epoch: int) -> None:
        """Snapshot EVERYTHING needed to resume mid-run: all four networks
        (weights + BN statistics + optimiser state), the step count, the
        dropout generator's and both augmentation generators' states, the
        epoch counter, lr, best-so-far, the monitors of the best-checkpoint
        callback and of early stopping, and the samplers' ring cursors and
        orders.

        Goes beyond the reference's warm restart (model+optimizer only,
        ``train_mmwhs.py:537-583``): a resumed run continues the exact
        data order and decay schedule. Under a mesh rank i writes its copy
        under ``.rank{i}`` beside ``path`` (``checkpoint.rank_file``).
        """
        payload = {
            "epoch": int(epoch),
            "lr": float(self._lr),
            "best_val_lge_dice": float(self.best["val_lge_dice"]),
            "best_epoch": int(self.best["epoch"]),
            "aug_rng": self._aug_gen.get_state(),
            "aug_host_rng": self._aug_host_gen.get_state(),
            "dropout_rng": self.state.generator.get_state(),
            "step": int(self.state.step),
            "nets": {
                name: ckpt_lib.net_state(module, opt)
                for name, module, opt in zip(self._NETS, self.state.models, self.state.optimizers)
                if module is not None
            },
            # monitor state of the best-checkpoint callback + early stopping,
            # so a resumed run keeps the same best/patience decisions
            "ckpt_best": float(self.ckpt_gen.best_result),
            "ckpt_epoch": int(self.ckpt_gen.epoch),
            "es_counter": int(self.early_stop.counter if self.early_stop else 0),
            "es_best": float(self.early_stop.best_result if self.early_stop else -np.inf),
        }
        if hasattr(self.train_iter, "_src_sampler"):
            for key, sampler in (("src_sampler", self.train_iter._src_sampler), ("tgt_sampler", self.train_iter._tgt_sampler)):
                st = sampler.state()
                payload[key] = {"cursor": int(st["cursor"]), "order": torch.from_numpy(np.asarray(st["order"], np.int64))}
        ckpt_lib.save_pytree(ckpt_lib.rank_file(path, self._rank), payload)

    def restore_full(self, path: str) -> int:
        """Restore a :meth:`save_full` snapshot; returns the next epoch. The
        generators' states restore only into generators of the same device
        type as those that wrote them: a snapshot of a run on the card
        resumes on a card, one of a CPU run on the CPU. Under a mesh every
        rank reads ``path`` itself, rank 0's snapshot, and the state is
        replicated (and so checked) after the restore. The state is the same
        on every rank and the samplers' cursors are the global batch's, so a
        snapshot does not depend on the number of ranks that wrote it."""
        payload = ckpt_lib.restore_pytree(path)
        for name, module, opt in zip(self._NETS, self.state.models, self.state.optimizers):
            if module is not None:
                module.load_state_dict(payload["nets"][name]["model"])
                opt.load_state_dict(payload["nets"][name]["optimizer"])
        self.state.step = int(payload["step"])
        self.state.generator.set_state(payload["dropout_rng"])
        self._aug_gen.set_state(payload["aug_rng"])
        self._aug_host_gen.set_state(payload["aug_host_rng"])
        self._lr = float(payload["lr"])
        self.best["val_lge_dice"] = float(payload["best_val_lge_dice"])
        self.best["epoch"] = int(payload["best_epoch"])
        self.ckpt_gen.best_result = float(payload["ckpt_best"])
        self.ckpt_gen.epoch = int(payload["ckpt_epoch"])
        if self.early_stop is not None:
            self.early_stop.counter = int(payload["es_counter"])
            self.early_stop.best_result = float(payload["es_best"])
        if "src_sampler" in payload and hasattr(self.train_iter, "_src_sampler"):
            for key, sampler in (("src_sampler", self.train_iter._src_sampler), ("tgt_sampler", self.train_iter._tgt_sampler)):
                sampler.restore({"cursor": payload[key]["cursor"], "order": payload[key]["order"].numpy()})
        self.replicate_state()
        return int(payload["epoch"]) + 1

    def initial_validation(self) -> Dict[str, float]:
        """Warm-restart pre-train validation with the reference's print
        format (``train_mscmrseg.py:511-524``, ``train_mmwhs.py:584-600``)."""
        vr = self.validate()
        print(
            f"valid_loss: {vr['val_loss']:.5f} "
            f"valid_lge_loss: {vr['val_lge_loss']:.5f} "
            f"test_lge_loss: {vr['test_lge_loss']:.5f} "
        )
        print(
            f"valid_dice: {vr['val_dice']:.5f} "
            f"valid_lge_dice: {vr['val_lge_dice']:.5f} "
            f"test_lge_dice: {vr['test_lge_dice']:.5f} "
        )
        return vr

    def _net_trees(self):
        """(callback, checkpoint tree) of the generator and each enabled discriminator."""
        callbacks = (self.ckpt_gen, self.ckpt_d1, self.ckpt_d2, self.ckpt_d4)
        for cb, module, opt in zip(callbacks, self.state.models, self.state.optimizers):
            if cb is not None:
                yield cb, {"net": ckpt_lib.net_state(module, opt), "config": None}

    def fit(
        self,
        epochs: Optional[int] = None,
        start_epoch: int = 1,
        save_full_every: int = 0,
        save_full_path: Optional[str] = None,
    ) -> Dict:
        """Run training. ``start_epoch`` > 1 continues a :meth:`restore_full`
        snapshot (decay schedule, best-so-far and checkpoint cadence all pick
        up where they left off); ``save_full_every``/``save_full_path``
        enable periodic full snapshots for crash recovery. The wall-clock
        budget counts from *this* process start (the reference has no mid-run
        resume; its 24h budget is per submission)."""
        cfg = self.cfg
        n_epochs = epochs or cfg.epochs
        budget = cfg.max_hours * 3600 - 10 * 60  # reference margin (:667)
        start = time.perf_counter()
        slowest_epoch = 0.0
        for epoch in range(start_epoch, n_epochs + 1):
            e0 = time.perf_counter()
            tr = self.train_epoch()
            timing = timer.per_iteration_ms()
            vr = self.validate()
            self.print_epoch_result(tr, vr, epoch)
            self.writer.scalars(epoch, tr, prefix="train/")
            self.writer.scalars(epoch, vr, prefix="valid/")
            self.writer.scalars(epoch, {"lr": get_generator_lr(self.state)}, prefix="opt/")
            if timing:  # host ms an iteration of each span, over the epoch's iterations that no profiler recorded
                self.writer.scalars(epoch, timing, prefix="timing/")

            if vr["val_lge_dice"] > self.best["val_lge_dice"]:
                self.best = {
                    "epoch": epoch,
                    "val_lge_dice": vr["val_lge_dice"],
                    "train": tr,
                    "valid": vr,
                }
            out_of_time = (time.perf_counter() - start) > budget
            stop_early = False
            if self.early_stop is not None:
                self.early_stop.step(vr["val_lge_dice"])
                stop_early = self.early_stop.should_stop()
            # a terminal epoch (budget or patience) triggers the final-epoch
            # checkpoint behaviour (.Scr rename + last snapshot), like the
            # reference's epoch = n_epochs - 1 trick (train_mscmrseg.py:573-574)
            ckpt_epoch = n_epochs if (out_of_time or stop_early) else epoch
            monitor = vr["val_lge_dice"]
            for cb, tree in self._net_trees():
                cb.step(monitor, tree, ckpt_epoch)
            if out_of_time:
                print("wall-clock budget reached; stopping")
                break
            if stop_early:
                print(f"early stopping: no val_lge_dice improvement for {cfg.patience} epochs")
                break
            if cfg.offdecay and epoch % cfg.decay_e == 0:
                self._lr *= 0.2
                self.state = set_generator_lr(self.state, self._lr)
            # full snapshot AFTER the decay so a resume continues the
            # uninterrupted run's schedule exactly
            if save_full_every and save_full_path and epoch % save_full_every == 0:
                self.save_full(save_full_path, epoch)
            # adaptive margin (train_mmwhs.py:673-675)
            slowest_epoch = max(slowest_epoch, time.perf_counter() - e0)
            budget = cfg.max_hours * 3600 - slowest_epoch - 25 * 60
        print(
            "Best model on epoch {}: train_dice {:.3f}, valid_dice {:.3f}, "
            "lge_dice {:.3f}, test_lge_dice {:.3f}".format(
                self.best["epoch"],
                self.best["train"].get("seg_dice", 0.0),
                self.best["valid"].get("val_dice", 0.0),
                self.best["valid"].get("val_lge_dice", 0.0),
                self.best["valid"].get("test_lge_dice", 0.0),
            )
        )
        self.writer.close()
        return self.best
