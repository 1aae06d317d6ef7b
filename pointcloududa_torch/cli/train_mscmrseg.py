"""MS-CMRSeg (bSSFP -> LGE) UDA training CLI (counterpart of the JAX
package's ``cli/train_mscmrseg.py``; same flags).

Flag set mirrors reference ``src/train_mscmrseg.py:675-697`` (including the
store_false semantics of ``-aug``/``-offdecay``), plus the JAX package's
extras (``-dtype``, ``bfloat16`` by default as there, ``-ndev``, ``-dist``,
``-workdir``, ``-logdir``, ``-host_aug``, ``-workers``). What differs here,
said in its help: ``-no_packed`` parses and changes nothing. Without
``-aug`` the run augments with the heavy pipeline on the device, as the
reference does (``-aug2``: the medium one; ``-aug``: no augmentation);
``-host_aug`` runs the same pipeline on the host instead, with the numpy
twin (``ops/host_augment.py``) in the loader's feeder thread. Training runs
on the current CUDA device with the hand-written kernels (Chamfer, BN
statistics). PNG slices are read by ``utils/png.py``, without OpenCV.

Data parallelism (``cli/common.py:run_ranks``): ``-ndev N`` starts N ranks,
one a card (0: every visible card), and ``-dist`` makes this process one
rank of a launcher's group (``torchrun ... -dist``). Every rank trains on its
rows of the global batch of ``-bs`` and computes the one-process step over
it. Rank 0 writes ``-workdir`` and ``-logdir``, rank i under their
``.rank{i}``. With ``-resume``, rank i writes its snapshots to
``.rank{i}/<name>`` beside the path, and every rank resumes from the path
itself, rank 0's snapshot (the ranks hold one state, so a snapshot does not
depend on how many ranks wrote it).

Usage (the reference's command):
  python -m pointcloududa_torch.cli.train_mscmrseg -bs 16 -ns 2000 -e 200 \
      -d1 -d2 -d4 -data_dir ./input_aug
  torchrun --nproc_per_node 4 -m pointcloududa_torch.cli.train_mscmrseg -dist ...
"""

from __future__ import annotations

import argparse

from pointcloududa_torch import config as _config
from pointcloududa_torch.cli.common import resume_and_fit, run_ranks, warm_restart, with_kernels
from pointcloududa_torch.config import appendix


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-aug", action="store_false",
                   help="whether NOT to augment the data; without it the heavy pipeline runs on the device")
    p.add_argument("-aug2", action="store_true", help="augment with the 2nd (medium) method")
    p.add_argument("-load_weight", action="store_true")
    p.add_argument("-bs", type=int, default=16)
    p.add_argument("-ns", help="samples per epoch", type=int, default=2000)
    p.add_argument("-e", help="number of epochs", type=int, default=200)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-lr_fix", type=float, default=1e-3)
    p.add_argument("-offdecay", help="whether NOT to decay the unet lr", action="store_false")
    p.add_argument("-decay_e", type=int, default=50)
    p.add_argument("-apdx", type=str, default="train_point_tpu")
    p.add_argument("-d1", help="output-space discriminator", action="store_true")
    p.add_argument("-d2", help="entropy discriminator", action="store_true")
    p.add_argument("-d4", help="point-cloud discriminator", action="store_true")
    p.add_argument("-d1lr", type=float, default=2.5e-5)
    p.add_argument("-d2lr", type=float, default=2.5e-5)
    p.add_argument("-d4lr", type=float, default=2.5e-5)
    p.add_argument("-dr", help="discriminator loss ratio for the unet", type=float, default=0.01)
    p.add_argument("-wp", help="point-cloud loss weight", type=float, default=1.0)
    p.add_argument("-data_dir", type=str, default="./input_aug")
    # extras beyond the reference
    p.add_argument("-dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="compute type of activations and convolutions (weights, gradients and optimiser state stay float32)")
    p.add_argument("-ndev", type=int, default=0,
                   help="devices in the data mesh (0=all): N > 1 starts N ranks, one a card; with -dist, 0 or the world size")
    p.add_argument("-workdir", type=str, default="weights")
    p.add_argument("-logdir", type=str, default="runs")
    p.add_argument("-host_aug", action="store_true",
                   help="augment on the host (the numpy twin, in the loader) instead of the device")
    p.add_argument(
        "-no_vert_t_metric",
        help="skip the logged-only target-domain chamfer diagnostic (the "
        "reference's loss_vert_target is .item()-logged, never backpropped); "
        "with -aug and the point head on MM-WHS this also skips the per-step "
        "on-device TARGET cloud regeneration",
        action="store_true",
    )
    p.add_argument(
        "-vert_t_every",
        help="cadence of that diagnostic: compute it every N steps (1 = "
        "every step = reference parity; N=10 keeps a 1/N-subsampled log "
        "series at ~1/N of its cost)",
        type=int,
        default=1,
    )
    p.add_argument(
        "-no_packed",
        help="accepted for the JAX package's command lines and changes nothing: "
        "this package has no packed layout",
        action="store_true",
    )
    p.add_argument("-workers", type=int, default=4)
    p.add_argument(
        "-dist",
        help="multi-process: join the process group a launcher (torchrun) describes in the environment "
        "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), one process a card; every rank decodes "
        "only its own global-batch rows (parallel.trainer_row_shard)",
        action="store_true",
    )
    p.add_argument("-max_hours", type=float, default=24.0)
    p.add_argument("-patience", help="early stopping patience (0=off)", type=int, default=0)
    p.add_argument(
        "-resume",
        type=str,
        default="",
        help="path for periodic full train-state snapshots (params, optimizers, "
        "rng, lr, best, sampler cursors); restores from it when present, so a "
        "killed run continues where it stopped",
    )
    p.add_argument("-save_every", help="epochs between -resume snapshots", type=int, default=1)
    return p


def config_from_args(args) -> "UDAConfig":
    aug = "aug2" if args.aug2 else ("heavy" if args.aug else "")
    # late-bound through the config module so test/runbook fixtures that
    # swap config.mscmrseg_default take effect regardless of import order
    return _config.mscmrseg_default(
        aug=aug,
        load_weight=args.load_weight,
        bs=args.bs,
        ns=args.ns,
        epochs=args.e,
        lr=args.lr,
        lr_fix=args.lr_fix,
        offdecay=args.offdecay,
        decay_e=args.decay_e,
        apdx=args.apdx,
        d1=args.d1,
        d2=args.d2,
        d4=args.d4,
        d1lr=args.d1lr,
        d2lr=args.d2lr,
        d4lr=args.d4lr,
        dr=args.dr,
        wp=args.wp,
        data_dir=args.data_dir,
        compute_dtype=args.dtype,
        num_devices=args.ndev,
        max_hours=args.max_hours,
        patience=args.patience,
        vert_t_metric=not args.no_vert_t_metric,
        vert_t_every=args.vert_t_every,
    )


def main(argv=None, device=None):
    """Train. ``device=None`` is the current CUDA device (raising without
    one); the CPU tests pass ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    cfg = with_kernels(config_from_args(args))
    print(appendix(cfg))
    run_ranks(_train, cfg, args, device)


def _train(mesh, cfg, args, device=None):
    """One rank's run on ``mesh`` (``None``: the one process, on ``device``)."""
    from pointcloududa_torch.data.build import build_mscmrseg_pipelines
    from pointcloududa_torch.parallel import trainer_row_shard
    from pointcloududa_torch.train.loop import UDATrainer

    row_shard = None if mesh is None else trainer_row_shard(mesh, cfg.bs)
    device_augment = not args.host_aug
    train_iter, val_iters = build_mscmrseg_pipelines(
        cfg, workers=args.workers, device_augment=device_augment, row_shard=row_shard
    )
    trainer = UDATrainer(
        cfg,
        train_iter,
        val_iters,
        workdir=args.workdir,
        logdir=args.logdir,
        mesh=mesh,
        device_augment=device_augment,
        device=device,
    )
    if cfg.load_weight:
        # warm restart restores the generator AND every enabled
        # discriminator, then validates before training resumes
        # (src/train_mscmrseg.py:503-533)
        warm_restart(trainer)
        print("weights restored from", trainer.ckpt_gen.model_name)
        trainer.initial_validation()
    print(
        f"Training on {len(train_iter._src_sampler)} trainA, "
        f"{len(train_iter._tgt_sampler)} trainB slices"
    )
    resume_and_fit(trainer, args)


if __name__ == "__main__":
    main()
