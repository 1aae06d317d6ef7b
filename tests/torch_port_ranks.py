"""What the data-parallel tests run on each rank (``parallel.launch.spawn``
pickles these functions by name, so they live in a module that imports
neither JAX nor the JAX package: every rank imports it), and the same
functions run once more in the test's own process without a mesh, on the
global batch, for the one-process result. Each returns numpy arrays and
floats."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
from pointcloududa_torch.data.synthetic import synthetic_batch, synthetic_raw_batch
from pointcloududa_torch.parallel import collectives, process_row_slice, replicate, shard_batch

TINY = dict(filters=4, n_block=2, crop_size=32, bs=4, compute_dtype="float32")
# the step cases: D1 + D2 over three steps (SGD on the generator, so its
# parameters can be held against JAX's), and the triple adversary over one
# (He init: at the default init the cloud collapses and D4 normalises noise)
CASES = {
    "d1d2": dict(cfg=dict(d1=True, d2=True, sgd=True, fc_inch=0), steps=3, d4_drop=None),
    "d4": dict(cfg=dict(d1=True, d2=True, d4=True, heinit=True, sgd=True, fc_inch=9), steps=1, d4_drop=0.0),
    # dropout in the generator and in D4, whose masks each rank takes from the global batch's draw
    "dropout": dict(cfg=dict(d1=True, d2=True, d4=True, heinit=True, drop=True, sgd=True, fc_inch=9), steps=2, d4_drop=None),
}


def _local(batch, mesh):
    return batch if mesh is None else shard_batch(batch, mesh)


def _states(models) -> dict:
    return {f"{name}.{k}": v.detach().cpu().numpy().copy()
            for name, m in zip(("gen", "d1", "d2", "d4"), models) if m is not None
            for k, v in m.state_dict().items()}


def step_case(mesh, case: str) -> dict:
    """The train step of ``CASES[case]`` from the seed-0 init on the global
    batches of seeds 0, 1, ...: each step's metrics and all-reduces, and the
    networks' state before the first step and after every step."""
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step

    torch.set_num_threads(1)
    spec = CASES[case]
    cfg = mscmrseg_default(**TINY, **spec["cfg"])
    st = create_train_state(cfg, seed=0, device="cpu")
    if spec["d4_drop"] is not None:
        st.models[3].dropout.p = spec["d4_drop"]
    replicate(st, mesh)
    step = make_train_step(cfg, st.models, st.optimizers, mesh=mesh)
    out = {"metrics": [], "all_reduces": [], "init": _states(st.models), "states": []}
    for i in range(spec["steps"]):
        collectives.reset_launches()
        st, m = step(st, _local(synthetic_batch(cfg, cfg.bs, seed=i), mesh))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["all_reduces"].append(collectives.all_reduce.launches)
        out["states"].append(_states(st.models))
    return out


PRE_CFG = dict(softmax=True, d2=True, d4=True, aug="light", crop_size=32, bs=4, compute_dtype="float32")


def preprocess_case(mesh, calls: int = 2) -> list:
    """The MM-WHS device preprocess with light augmentation and regenerated
    clouds, called ``calls`` times with one pair of generators on the global
    raw batches of seeds 0, 1, ...: this rank's outputs."""
    from pointcloududa_torch.train.loop import make_device_preprocess

    torch.set_num_threads(1)
    cfg = mmwhs_default(**PRE_CFG)
    pre = make_device_preprocess(cfg, train=True, device_augment=True, device="cpu", mesh=mesh)
    gen, host = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
    return [{k: v.numpy().copy() for k, v in pre(gen, _local(synthetic_raw_batch(cfg, cfg.bs, seed=i), mesh),
                                                 host_generator=host).items()}
            for i in range(calls)]


def norm1d_case(mesh) -> dict:
    """A global batch of 2 through D4's ``Norm1d`` in training mode: the
    output of this rank's rows and the running statistics."""
    from pointcloududa_torch.models.pointnet import Norm1d

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 5)).astype(np.float32))
    norm = Norm1d(3)
    with collectives.data_parallel(mesh):
        y = norm(x if mesh is None else x[mesh.rank:mesh.rank + 1])
    return {"y": y.detach().numpy(), "running_mean": norm.running_mean.numpy(), "running_var": norm.running_var.numpy(),
            "tracked": int(norm.num_batches_tracked)}


def bn_case(mesh, device: str = "cpu", dtype: str = "float32", shape=(4, 8, 6, 6)) -> dict:
    """A generator BatchNorm (the kernel route) in training mode on a global
    batch: the statistics, the output of this rank's rows, the running
    statistics and dx of a global loss, ``sum(y * w)`` over the global
    batch. Under a mesh of W ranks autograd gives each rank W times the
    one-process dx of its rows (``parallel/collectives.py``); the result is
    divided by W, so that it is the one-process dx."""
    from pointcloududa_torch.models.unet import TwinBatchNorm
    from pointcloududa_torch.ops import bn_kernel

    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=shape).astype(np.float32)).to(device, dt)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    if mesh is not None:
        lo, hi = process_row_slice(mesh, shape[0])
        x, w = x[lo:hi].contiguous(), w[lo:hi]
    x.requires_grad_(True)
    bn = TwinBatchNorm(shape[1]).to(device)
    bn_kernel.reset_launches()
    with collectives.data_parallel(mesh):
        mean, var = bn_kernel.batch_stats(x.detach())
        y = bn(x)
        loss = collectives.global_sum(torch.sum(y.float() * w))
    loss.backward()
    world = 1 if mesh is None else mesh.world_size
    return {"mean": mean.cpu().numpy(), "var": var.cpu().numpy(), "y": y.detach().float().cpu().numpy(),
            "running_var": bn.running_var.cpu().numpy(), "dx": (x.grad.float() / world).cpu().numpy(),
            "launches": (bn_kernel.stats_forward.launches, bn_kernel.stats_backward.launches)}


# the trainer case: the data of tests/test_multihost_trainer.py, whose train
# streams end in a truncated batch (ns 10, bs 4: 4, 4, 2) and whose validation
# sets (6) do not divide the batch
N_TRAIN, N_VAL = 8, 6


class SynthAdapter:
    """index -> record, a function of (seed, index) alone, so every rank
    decodes the rows it is given as the one process does."""

    def __init__(self, seed: int, n: int, hw: int, n_class: int = 4):
        self._seed, self._n, self._hw, self._c = seed, n, hw, n_class

    def __len__(self):
        return self._n

    def __call__(self, i: int):
        rng = np.random.default_rng(self._seed * 1_000_003 + int(i))
        img = rng.integers(0, 255, (self._hw, self._hw, 3)).astype(np.uint8)
        yy, xx = np.mgrid[0:self._hw, 0:self._hw]
        cy, cx, r = rng.integers(8, 24, 3)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2).astype(np.uint8) * (1 + int(i) % (self._c - 1))
        return img, mask.astype(np.uint8), None


def trainer_cfg():
    return mscmrseg_default(**dict(TINY, fc_inch=0, ns=10, epochs=2, aug="", d1=True, d2=True, decay_e=1))


def trainer_case(mesh, root: str) -> dict:
    """``UDATrainer`` for 2 epochs, writing under ``root``; the best epoch,
    its metrics, the best checkpoint's name and the logged records."""
    from pointcloududa_torch.data.build import _val_iter_factory
    from pointcloududa_torch.data.loader import BatchAssembler, PairedIterator
    from pointcloududa_torch.data.sampler import RingSampler
    from pointcloududa_torch.parallel import trainer_row_shard
    from pointcloududa_torch.train.loop import UDATrainer

    torch.set_num_threads(1)
    cfg = trainer_cfg()
    row_shard = None if mesh is None else trainer_row_shard(mesh, cfg.bs)
    hw = cfg.crop_size
    train_iter = PairedIterator(
        RingSampler(N_TRAIN, cfg.bs, n_samples=cfg.ns, shuffle_seed=cfg.seed),
        RingSampler(N_TRAIN, cfg.bs, n_samples=cfg.ns, shuffle_seed=cfg.seed + 1),
        BatchAssembler(SynthAdapter(1, N_TRAIN, hw), workers=0),
        BatchAssembler(SynthAdapter(2, N_TRAIN, hw), workers=0),
        seed=cfg.seed,
        row_shard=row_shard,
    )
    val_iters = {name: _val_iter_factory(SynthAdapter(seed, N_VAL, hw), cfg.bs, 0, cfg.seed + seed - 1, row_shard)
                 for name, seed in (("val", 3), ("val_lge", 4), ("test_lge", 5))}
    trainer = UDATrainer(cfg, train_iter, val_iters, workdir=os.path.join(root, "w"), logdir=os.path.join(root, "r"),
                         mesh=mesh, device_augment=False, device="cpu")
    best = trainer.fit()
    return {"best_epoch": int(best["epoch"]), "train": dict(best["train"]), "valid": dict(best["valid"]),
            "ckpt": trainer.ckpt_gen.final_best_path, "gen": {k: v.numpy().copy() for k, v in trainer.gen.state_dict().items()}}


def host_iterator(loader_module, make_host_augment, row_shard):
    """The host augmentation route over the trainer case's streams: heavy
    pipeline, the source clouds rebuilt from its warped masks. The loader and
    the hook come from the caller, so that the test can build the JAX
    package's with the same adapters."""
    from pointcloududa_torch.data.sampler import RingSampler

    cfg = trainer_cfg()
    hook = make_host_augment("heavy")
    return loader_module.PairedIterator(
        RingSampler(N_TRAIN, cfg.bs, n_samples=cfg.ns, shuffle_seed=cfg.seed),
        RingSampler(N_TRAIN, cfg.bs, n_samples=cfg.ns, shuffle_seed=cfg.seed + 1),
        loader_module.BatchAssembler(SynthAdapter(1, N_TRAIN, cfg.crop_size), workers=0, host_augment=hook, regen_vertices=True),
        loader_module.BatchAssembler(SynthAdapter(2, N_TRAIN, cfg.crop_size), workers=0, host_augment=hook),
        seed=cfg.seed,
        row_shard=row_shard,
    )


HOST_GLOBAL_SEED = 9  # numpy's global generator, seeded before the epoch: the clouds' FPS starts


def host_augment_case(mesh) -> list:
    """This rank's raw train batches of one epoch of :func:`host_iterator`
    under its ``row_shard``."""
    from pointcloududa_torch.data import loader
    from pointcloududa_torch.ops.host_augment import make_host_augment
    from pointcloududa_torch.parallel import trainer_row_shard

    row_shard = None if mesh is None else trainer_row_shard(mesh, trainer_cfg().bs)
    np.random.seed(HOST_GLOBAL_SEED)
    return list(host_iterator(loader, make_host_augment, row_shard).epoch())


def replicate_case(mesh) -> dict:
    """``replicate`` over states built from one seed on every rank, then
    from a seed of each rank's own."""
    from pointcloududa_torch.train.state import create_train_state

    cfg = mscmrseg_default(**TINY, fc_inch=0)
    out = {}
    for name, seed in (("equal_seeds", 0), ("different_seeds", mesh.rank)):
        st = create_train_state(cfg, seed=seed, device="cpu")
        try:
            replicate(st, mesh)
            out[name] = "same"
        except RuntimeError:
            out[name] = "refused"
    return out


def average_grads_case(mesh) -> dict:
    """Rank r's gradient r + 1 averaged; a parameter without a gradient."""
    a, b = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))
    a.grad = torch.full((3,), float(mesh.rank + 1))
    with collectives.data_parallel(mesh):
        collectives.average_grads([a, b])
    return {"averaged": float(a.grad[0]), "none_stays_none": b.grad is None}


def run_all(mesh, root: str) -> dict:
    """Every case above on one set of ranks (a spawn costs seconds). A rank
    skips TensorBoard, whose import (TensorFlow's, where that is installed)
    takes seconds: ``MetricWriter`` then writes its JSONL records alone."""
    if mesh is not None:
        sys.modules["torch.utils.tensorboard"] = None
    out = {f"step/{case}": step_case(mesh, case) for case in CASES}
    out["preprocess"] = preprocess_case(mesh)
    out["norm1d"] = norm1d_case(mesh)
    out["bn"] = bn_case(mesh)
    out["trainer"] = trainer_case(mesh, root if mesh is None else os.path.join(root, "ranks"))
    out["host_augment"] = host_augment_case(mesh)
    if mesh is not None:
        out["replicate"] = replicate_case(mesh)
        out["average_grads"] = average_grads_case(mesh)
    return out
