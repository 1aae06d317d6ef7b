"""The data mesh: one process a device, joined by a ``torch.distributed``
process group (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package puts a 1-D ``data`` mesh over its devices: parameters are
replicated, batches are sharded over the batch axis, and GSPMD turns every
batch reduction of the step into a ``psum``, so data-parallel training
computes the one-device step over the global batch. Here each rank is a
process that holds one device and its own rows ``lo:hi`` of every global
batch; the batch reductions are taken over the global batch explicitly
(``parallel/collectives.py`` says how and why that gives the same
gradients), and every rank holds the same parameters, buffers, optimiser
state and generators throughout.

As in the JAX package, every rank runs the SAME sampler stream (same seeds,
same ring cursors) and decodes only its own rows of each global index batch
(``data.loader.shard_index_batch`` with :func:`trainer_row_shard`); the
random draws of the preprocess and of dropout are made for the global batch
on every rank, which keeps its rows. The global batch is therefore the
one-process run's by construction.

``pad_batch`` is the port's own copy of the JAX function (numpy only, held
equal by ``tests/test_torch_port_imports.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from pointcloududa_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the data mesh: the world size, this rank, its
    device and the process group (``None``: one process and no group, where
    every collective is the identity)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None


def init_distributed(backend: Optional[str] = None, device=None) -> torch.device:
    """``torch.distributed.init_process_group`` from the launcher's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, as ``torchrun`` sets them), for the train CLIs' ``-dist``
    flag; returns this rank's device.

    ``device=None`` is the card ``cuda:LOCAL_RANK``; the backend is ``nccl``
    for a CUDA device and ``gloo`` for the CPU, unless the caller names one.
    NCCL carries CUDA tensors only, so ``nccl`` with a CPU device raises."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", local)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend carries CUDA tensors only; this rank's device is {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
    )
    return device


def create_mesh(num_devices: int = 0, device=None) -> Mesh:
    """The data mesh of this process.

    With a process group (``init_distributed``): every rank of it, on
    ``device`` (``None``: the current CUDA device); ``num_devices`` must be 0
    (every rank) or the world size. Without one: a mesh of this process
    alone, and ``num_devices`` must be at most 1 (the ranks of a larger
    mesh are processes: start them with ``parallel.launch.spawn`` or
    ``-ndev N`` in the train CLIs)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if num_devices > 1:
            raise ValueError(f"a mesh of {num_devices} devices needs {num_devices} processes in a process group")
        return Mesh(1, 0, device)
    world = dist.get_world_size()
    if num_devices not in (0, world):
        raise ValueError(f"num_devices={num_devices} but the process group has {world} ranks")
    return Mesh(world, dist.get_rank(), device, dist.group.WORLD)


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans more than one process."""
    return mesh.world_size > 1


def process_row_slice(mesh: Mesh, global_rows: int) -> tuple:
    """(lo, hi): the contiguous global-batch row range owned by this rank.
    Raises if the rows do not divide the mesh."""
    if global_rows % mesh.world_size:
        raise ValueError(
            f"global batch {global_rows} must divide the {mesh.world_size}-device mesh "
            "for multi-process training (tail batches are wrap-padded to the "
            "static stream batch size upstream)"
        )
    per = global_rows // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def trainer_row_shard(mesh: Mesh, batch_size: int):
    """Loader ``row_shard`` tuple for :class:`~...train.loop.UDATrainer`.

    ``None`` on a single-process mesh (the loader decodes full global
    batches). On a multi-process mesh: ``(lo, hi, target)``: every process
    runs identical samplers, wrap-pads each global index batch to the static
    ``target`` (``batch_size`` rounded up to the mesh size), and decodes only
    its own rows ``lo:hi`` (``data.loader.shard_index_batch``).
    """
    if not mesh_is_multiprocess(mesh):
        return None
    target = -(-batch_size // mesh.world_size) * mesh.world_size
    lo, hi = process_row_slice(mesh, target)
    return lo, hi, target


def pad_batch(batch: dict, multiple: int, target: int = 0) -> dict:
    """Pad the leading (batch) dim of a dict-of-arrays to ``target`` (or the
    next multiple of ``multiple``), attaching a ``"sample_mask"`` of 1s for
    real samples and 0s for the pad.

    Pad rows wrap around the batch's own samples (``x[i % n]``) so train-mode
    BatchNorm sees plausible values; every loss/metric reduction in the step
    functions excludes the pad via the mask (``losses.masked_mean``),
    preserving the reference's short-tail-batch means
    (``src/data_generator_mscmrseg.py:281-291``).
    """
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    n = next(iter(arrays.values())).shape[0]
    t = max(target, -(-n // multiple) * multiple)
    if n == t:
        return batch
    idx = np.arange(t) % n
    out = {k: v[idx] for k, v in arrays.items()}
    base = arrays.get("sample_mask", np.ones(n, np.float32))
    out["sample_mask"] = np.where(np.arange(t) < n, base[idx], 0.0).astype(np.float32)
    return out


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a GLOBAL host batch (a dict of arrays with a
    leading batch dim), on the mesh's device. A batch whose leading dim does
    not divide the mesh is wrap-padded to the next multiple first
    (:func:`pad_batch`, which attaches the ``"sample_mask"`` the step
    functions honour). The trainer does not go through here: its loader
    already decodes only this rank's rows (:func:`trainer_row_shard`)."""
    n = next(iter(batch.values())).shape[0]
    if n % mesh.world_size:
        batch = pad_batch(batch, mesh.world_size)
        n = next(iter(batch.values())).shape[0]
    lo, hi = process_row_slice(mesh, n)
    return {k: torch.as_tensor(v[lo:hi], device=mesh.device) for k, v in batch.items()}


def _state_tensors(state, generators: Iterable[torch.Generator]) -> list:
    """Every tensor a rank holds of the train state, in one order on every
    rank: each network's parameters and buffers, each optimiser's state, and
    the generators' states."""
    out = []
    for module, opt in zip(state.models, state.optimizers):
        if module is None:
            continue
        out += list(module.state_dict().values())
        for group in opt.param_groups:
            for p in group["params"]:
                per = opt.state.get(p, {})
                out += [per[k] for k in sorted(per) if isinstance(per[k], torch.Tensor)]
    return out + [g.get_state() for g in (state.generator, *generators)]


def replicate(state, mesh: Optional[Mesh], generators: Iterable[torch.Generator] = ()):
    """Give every rank rank 0's train state: the networks' parameters and
    buffers, the optimisers' state, the dropout generator and ``generators``
    (the trainer's augmentation generators). Every rank builds its state from
    the same seed, as in the JAX package, so this is also a check: each rank
    compares its own state with rank 0's before it takes it, and every rank
    raises if any differs at all. Returns ``state``, updated in place."""
    if mesh is None or mesh.group is None:
        return state
    from pointcloududa_torch.parallel import collectives

    generators = tuple(generators)
    tensors = _state_tensors(state, generators)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    differs = torch.zeros((), dtype=torch.float32, device=mesh.device)
    received = {}
    for dtype, idx in by_dtype.items():
        mine = torch.cat([tensors[i].detach().reshape(-1).to(mesh.device) for i in idx])
        theirs = collectives.broadcast(mine.clone(), mesh.group)
        # bit for bit: a NaN equals itself here
        differs = torch.maximum(differs, torch.ne(mine.view(torch.uint8), theirs.view(torch.uint8)).any().to(torch.float32))
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            received[i] = theirs[offset:offset + n].view(tensors[i].shape)
            offset += n
    if float(collectives.all_reduce(differs, dist.ReduceOp.MAX, mesh.group)):
        raise RuntimeError("the ranks' train states differ before replication: every rank must start from the same seed")
    n_gen = 1 + len(generators)
    for i, t in enumerate(tensors[:-n_gen]):
        with torch.no_grad():
            t.copy_(received[i])
    for g, i in zip((state.generator, *generators), range(len(tensors) - n_gen, len(tensors))):
        g.set_state(received[i].cpu().clone())
    return state
