"""MM-WHS (MR -> CT) whole-heart UDA training CLI (counterpart of the JAX
package's ``cli/train_mmwhs.py``; same flags).

Flag set mirrors reference ``src/train_mmwhs.py:815-872`` (~45 flags incl.
softmax-CE, per-loss adversarial weights, d4aux, etpls/Tetpls, ext* model
growth, per-discriminator momentum), plus the JAX package's extras
(``-dtype`` defaults to ``bfloat16``, as there). What differs here, said in
the flag's help: ``-no_packed`` parses and changes nothing (the port has no
packed layout). Training runs on the current CUDA device with the
hand-written kernels (Chamfer, BN statistics, farthest-point sampling); at
the end, unless ``-skip_final_eval``, the best checkpoint is evaluated on the
CT test volumes (``train_mmwhs.py:680-686``) on the same device.

Data parallelism (``cli/common.py:run_ranks``): ``-ndev N`` starts N ranks,
one a card (0: every visible card), and ``-dist`` makes this process one
rank of a launcher's group (``torchrun ... -dist``). Every rank trains on its
rows of the global batch of ``-bs`` and computes the one-process step over
it. Rank 0 writes ``-workdir`` and ``-logdir``, rank i under their
``.rank{i}``. With ``-resume``, rank i writes its snapshots to
``.rank{i}/<name>`` beside the path, and every rank resumes from the path
itself, rank 0's snapshot (the ranks hold one state, so a snapshot does not
depend on how many ranks wrote it). The final evaluation runs on rank 0
alone.

Usage:
  python -m pointcloududa_torch.cli.train_mmwhs -bs 16 -ns 2000 -e 200 \
      -softmax -d2 -d4 -aug light -data_dir ./input
  torchrun --nproc_per_node 4 -m pointcloududa_torch.cli.train_mmwhs -dist ...
"""

from __future__ import annotations

import argparse

from pointcloududa_torch import config as _config
from pointcloududa_torch.cli.common import restored_generator, resume_and_fit, run_ranks, warm_restart
from pointcloududa_torch.config import appendix


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # general
    p.add_argument("-bs", type=int, default=16)
    p.add_argument("-ns", type=int, default=2000)
    p.add_argument("-e", type=int, default=200)
    p.add_argument("-offdecay", help="whether NOT to decay the unet lr", action="store_false")
    p.add_argument("-apdx", type=str, default="train_point_tpu")
    p.add_argument("-load_weight", action="store_true")
    p.add_argument("-he", help="He initialiser", action="store_true")
    p.add_argument("-cvinit", help="constant-variance initialiser", action="store_true")
    p.add_argument("-data_dir", type=str, default="./input")
    # data augmentation
    p.add_argument("-aug", help="'', 'heavy' or 'light'", type=str, default="")
    p.add_argument("-mh", help="histogram matching", action="store_true")
    # unet
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-lr_fix", type=float, default=1e-3)
    p.add_argument("-sgd", help="SGD for the unet instead of Adam", action="store_true")
    p.add_argument("-nf", help="base filters", type=int, default=32)
    p.add_argument("-d4aux", help="train the point head without D4", action="store_true")
    p.add_argument("-drop", help="decoder dropout", action="store_true")
    p.add_argument("-softmax", help="softmax+CE instead of sigmoid+BCE", action="store_true")
    p.add_argument("-etpls", help="entropy minimisation on source", action="store_true")
    p.add_argument("-Tetpls", help="entropy minimisation on target", action="store_true")
    p.add_argument("-mmt", help="unet SGD momentum", type=float, default=0.95)
    # discriminators
    p.add_argument("-d1", action="store_true")
    p.add_argument("-d2", action="store_true")
    p.add_argument("-d4", action="store_true")
    p.add_argument("-d1lr", type=float, default=2.5e-5)
    p.add_argument("-d2lr", type=float, default=2.5e-5)
    p.add_argument("-d4lr", type=float, default=2.5e-5)
    p.add_argument("-ft", help="feature transform in PointNet D4", action="store_true")
    p.add_argument("-dmmt", type=float, default=0.95)
    p.add_argument("-d1mmt", type=float, default=0.95)
    p.add_argument("-d2mmt", type=float, default=0.95)
    p.add_argument("-d4mmt", type=float, default=0.95)
    # model growth
    p.add_argument("-extpn", action="store_true")
    p.add_argument("-extd1", action="store_true")
    p.add_argument("-extd2", action="store_true")
    p.add_argument("-extd4", action="store_true")
    # loss weights
    p.add_argument("-dr", type=float, default=0.01)
    p.add_argument("-wp", type=float, default=1.0)
    p.add_argument("-w1", type=float, default=1.0)
    p.add_argument("-w2", type=float, default=1.0)
    p.add_argument("-w4", type=float, default=1.0)
    # extras beyond the reference
    p.add_argument("-dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="compute type of activations and convolutions (weights, gradients and optimiser state stay float32)")
    p.add_argument("-ndev", type=int, default=0,
                   help="devices in the data mesh (0=all): N > 1 starts N ranks, one a card; with -dist, 0 or the world size")
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
    p.add_argument("-workdir", type=str, default="weights")
    p.add_argument("-logdir", type=str, default="runs")
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
        "-skip_final_eval",
        action="store_true",
        help="do not evaluate the best checkpoint on the CT test volumes after training",
    )
    p.add_argument(
        "-resume",
        type=str,
        default="",
        help="path for periodic full train-state snapshots; restores from it "
        "when present (crash recovery)",
    )
    p.add_argument("-save_every", help="epochs between -resume snapshots", type=int, default=1)
    return p


def config_from_args(args) -> "UDAConfig":
    assert args.aug in ("", "heavy", "light")
    # late-bound through the config module (see train_mscmrseg.py note)
    return _config.mmwhs_default(
        bs=args.bs,
        ns=args.ns,
        epochs=args.e,
        offdecay=args.offdecay,
        apdx=args.apdx,
        load_weight=args.load_weight,
        heinit=args.he,
        cvinit=args.cvinit,
        data_dir=args.data_dir,
        aug=args.aug,
        mh=args.mh,
        lr=args.lr,
        lr_fix=args.lr_fix,
        sgd=args.sgd,
        filters=args.nf,
        d4aux=args.d4aux,
        drop=args.drop,
        softmax=args.softmax,
        etpls=args.etpls,
        Tetpls=args.Tetpls,
        mmt=args.mmt,
        d1=args.d1,
        d2=args.d2,
        d4=args.d4,
        d1lr=args.d1lr,
        d2lr=args.d2lr,
        d4lr=args.d4lr,
        ft=args.ft,
        dmmt=args.dmmt,
        d1mmt=args.d1mmt,
        d2mmt=args.d2mmt,
        d4mmt=args.d4mmt,
        extpn=args.extpn,
        extd1=args.extd1,
        extd2=args.extd2,
        extd4=args.extd4,
        dr=args.dr,
        wp=args.wp,
        w1=args.w1,
        w2=args.w2,
        w4=args.w4,
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
    cfg = config_from_args(args)
    print(appendix(cfg))
    run_ranks(_train, cfg, args, device)


def _train(mesh, cfg, args, device=None):
    """One rank's run on ``mesh`` (``None``: the one process, on ``device``)."""
    from pointcloududa_torch.data.build import build_mmwhs_pipelines
    from pointcloududa_torch.parallel import trainer_row_shard
    from pointcloududa_torch.train.loop import UDATrainer

    row_shard = None if mesh is None else trainer_row_shard(mesh, cfg.bs)
    train_iter, val_iters, device_augment = build_mmwhs_pipelines(cfg, workers=args.workers, row_shard=row_shard)
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
        warm_restart(trainer)
        print("warm restart: model+optimizer states restored")
        # pre-train validation after the restore (train_mmwhs.py:584-600)
        trainer.initial_validation()
    resume_and_fit(trainer, args)

    best = trainer.ckpt_gen.final_best_path
    if not args.skip_final_eval and best and (mesh is None or mesh.rank == 0):
        # evaluate the best checkpoint (train_mmwhs.py:680-686) in a fresh
        # generator: the trainer's own holds the last epoch's weights
        from pointcloududa_torch.eval.volume import evaluate_mmwhs

        print("Evaluate the best model:", best)
        evaluate_mmwhs(cfg, restored_generator(cfg, best, trainer.device), data_dir=cfg.data_dir, device=trainer.device)


if __name__ == "__main__":
    main()
