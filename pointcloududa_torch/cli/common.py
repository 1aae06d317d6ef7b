"""What the CLIs share: the ranks of a data-parallel
run (``-ndev``, ``-dist``), the warm restart (``-load_weight``) and the full
resume (``-resume``), as ``pointcloududa_tpu/cli/train_mmwhs.py:176-236``
has them; the generator that the evaluations restore from a checkpoint
file."""

from __future__ import annotations

import dataclasses
import os

import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.parallel import create_mesh, init_distributed, launch
from pointcloududa_torch.train.checkpoint import restore_net_state


def with_kernels(cfg: UDAConfig) -> UDAConfig:
    """``cfg`` with the JAX package's kernel selectors set to its Pallas
    kernels. This package reads neither selector (the tensor's device picks
    the CUDA kernels or their plain versions), and none of its modules calls
    this: it is kept only because the benchmark's harness
    (``perfbench/harness.py``) imports it."""
    return dataclasses.replace(cfg, chamfer_impl="pallas", bn_stats_impl="pallas")


def run_ranks(train, cfg: UDAConfig, args, device) -> None:
    """Call ``train(mesh, cfg, args, device)`` as ``-dist`` and ``-ndev``
    ask, ``mesh`` being ``None`` for a run of one process.

    ``-dist``: this process is one rank of the group that a launcher (for
    example ``torchrun``) describes in the environment, on ``cuda:LOCAL_RANK``
    over NCCL (``device="cpu"``: the CPU over gloo); ``-ndev`` must be 0 or
    the world size. The group is left when training ends. Otherwise ``-ndev
    N`` above 1 starts N ranks on this host, one a card on ``cuda:0..N-1``
    over NCCL (``device="cpu"``: N processes on the CPU over gloo), and
    ``-ndev 0`` is every visible card."""
    if args.dist:
        import torch.distributed as dist

        rank_device = init_distributed(device=device)
        try:
            train(create_mesh(args.ndev, rank_device), cfg, args)
        finally:
            dist.destroy_process_group()
        return
    n = args.ndev
    if device is None:
        cards = torch.cuda.device_count()
        n = n or cards
        if n > max(cards, 1):
            raise ValueError(f"-ndev {n}: {cards} CUDA devices are visible")
        devices = [torch.device("cuda", r) for r in range(n)]
    else:
        devices = [device] * n
    if n <= 1:
        train(None, cfg, args, device)
    else:
        launch.spawn(train, devices, (cfg, args))


def restored_generator(cfg: UDAConfig, path: str, device):
    """A fresh generator built from ``cfg`` on ``device``, in ``cfg``'s
    compute dtype, its weights restored from the checkpoint file ``path``
    (the port's trainer layout, the reference's callback layout, or a bare
    ``state_dict``; float32 whatever dtype trained them)."""
    from pointcloududa_torch.train.state import build_generator

    gen = build_generator(cfg).to(device)
    restore_net_state(path, gen)
    return gen


def warm_restart(trainer) -> None:
    """Restore the generator and every enabled discriminator, weights and
    optimiser state, from the last-model checkpoints under the trainer's
    work directory (a data-parallel rank's own, as the JAX CLIs read them),
    then check that every rank holds the same state."""
    callbacks = (trainer.ckpt_gen, trainer.ckpt_d1, trainer.ckpt_d2, trainer.ckpt_d4)
    for cb, module, opt in zip(callbacks, trainer.state.models, trainer.state.optimizers):
        if cb is not None:
            restore_net_state(cb.model_name, module, opt)
    trainer.replicate_state()


def resume_and_fit(trainer, args) -> None:
    """Continue from the ``-resume`` snapshot when it exists, then train,
    writing a snapshot there every ``-save_every`` epochs."""
    start_epoch = 1
    if args.resume and os.path.exists(args.resume):
        start_epoch = trainer.restore_full(args.resume)
        print(f"full train state resumed from {args.resume}; continuing at epoch {start_epoch}")
    trainer.fit(
        start_epoch=start_epoch,
        save_full_every=args.save_every if args.resume else 0,
        save_full_path=args.resume or None,
    )
