"""What the CLIs share: the kernel selection, the warm restart
(``-load_weight``) and the full resume (``-resume``), as
``pointcloududa_tpu/cli/train_mmwhs.py:209-236`` has them; the generator
that the evaluations restore from a checkpoint file; the refusal of
``-dtype bfloat16``."""

from __future__ import annotations

import dataclasses
import os

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.train.checkpoint import restore_net_state


def with_kernels(cfg: UDAConfig) -> UDAConfig:
    """``cfg`` with the hand-written CUDA kernels selected for the Chamfer
    loss and the BatchNorm statistics. The selectors' defaults are the JAX
    package's (``"auto"``, ``"xla"``: its XLA routes), which in this package
    name the plain PyTorch versions the kernels are held against; a training
    run from the command line goes through the kernels. (On CPU tensors the
    wrappers compute with the plain versions, so a run with ``device="cpu"``
    takes the same route through the code.)"""
    return dataclasses.replace(cfg, chamfer_impl="pallas", bn_stats_impl="pallas")


def check_dtype(args) -> None:
    """Refuse, before anything is built, the compute type this package does
    not have yet."""
    if args.dtype != "float32":
        raise NotImplementedError(f"-dtype {args.dtype} is not ported: ROADMAP Queue 1 item 13; use -dtype float32")


def restored_generator(cfg: UDAConfig, path: str, device):
    """A fresh generator built from ``cfg`` on ``device``, its weights
    restored from the checkpoint file ``path`` (the port's trainer layout,
    the reference's callback layout, or a bare ``state_dict``)."""
    from pointcloududa_torch.train.state import build_generator

    gen = build_generator(cfg).to(device)
    restore_net_state(path, gen)
    return gen


def warm_restart(trainer) -> None:
    """Restore the generator and every enabled discriminator, weights and
    optimiser state, from the last-model checkpoints under the trainer's
    work directory."""
    callbacks = (trainer.ckpt_gen, trainer.ckpt_d1, trainer.ckpt_d2, trainer.ckpt_d4)
    for cb, module, opt in zip(callbacks, trainer.state.models, trainer.state.optimizers):
        if cb is not None:
            restore_net_state(cb.model_name, module, opt)


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
