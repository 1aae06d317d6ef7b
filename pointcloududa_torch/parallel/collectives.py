"""Reductions over the global batch of a data mesh.

JAX's data-parallel step is the one-device step over the global batch:
under a data mesh GSPMD turns every batch-axis reduction (BatchNorm
statistics, losses, metrics) into a ``psum``, and every device ends with the
same parameters, buffers and metrics. The port reproduces that with one
rule: every reduction over the batch axis inside the step, the preprocess
and the eval step is taken over the global batch through a SUM all-reduce
that autograd differentiates (:func:`global_sum`); every rank then holds the
global loss and the global metrics. Before each ``optimizer.step()`` the
parameter gradients are averaged over the ranks (:func:`average_grads`, one
flat all-reduce per optimiser).

Why averaging is right. Read the W ranks as W copies of one program whose
objective is the mean of the copies' losses, ``L = (1/W) sum_r L_r``; each
``L_r`` equals the one-process loss of the global batch. A value that
differs between the ranks, ``a_r`` (a sum over rank r's rows), reaches every
copy only through ``s = sum_r a_r``. On rank r autograd starts from
``dL_r/dL_r = 1`` and, at ``s``, holds ``dL_r/ds``, equal on every rank;
the all-reduce's backward sums these W equal values, so
``a_r`` receives ``W dL_r/ds = W dL/da_r``. Every gradient autograd forms
on rank r is therefore W times the gradient of L with respect to rank r's
copy. The parameters are shared by the copies, so their gradient is the sum
over the copies, ``(1/W) sum_r grad_r``: the mean over the ranks of what
autograd gave each, which is exactly ``nabla L``. The BatchNorm statistics
are one case of it: ``mu = (1/W) all_reduce_sum(mu_r)`` with equal rows per
rank, and the kernel's backward, which divides by the rank's own row count,
receives ``W dL/dmu`` through the all-reduce's backward.

The forward of :func:`global_sum` sums in place of the psum and its backward
sums the incoming gradients (the adjoint of a sum that every rank receives).
``torch.distributed.nn.functional.all_reduce`` computes the same, but it is
deprecated and warns on every call in recent PyTorch, so the module has its
own ``autograd.Function``.

The mesh reaches the step, the preprocess, the losses and the models through
:func:`data_parallel`, a context that the functions ``make_train_step``,
``make_eval_step`` and ``make_device_preprocess`` return enter around each
call; outside it (and on a mesh without a process group) every function
here is the identity, so the one-process path computes what it always did.
A mesh of one rank with a group (NCCL on one card) runs every collective,
and every value keeps its bits: the sums are of one term, and the means
divide by 1.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Iterable

import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("pointcloududa_torch_mesh", default=None)


@contextlib.contextmanager
def data_parallel(mesh):
    """Within the block, batch reductions are taken over ``mesh``'s global
    batch (``None``: over this process's batch)."""
    token = _MESH.set(mesh if mesh is not None and mesh.group is not None else None)
    try:
        yield
    finally:
        _MESH.reset(token)


def within(mesh, fn):
    """``fn``, each call of it made inside ``data_parallel(mesh)``."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with data_parallel(mesh):
            return fn(*args, **kwargs)

    return call


def _mesh():
    return _MESH.get()


def active() -> bool:
    """Whether batch reductions are taken over a mesh's global batch here."""
    return _mesh() is not None


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` in place, counted in ``all_reduce.launches``."""
    dist.all_reduce(x, op=op, group=group)
    all_reduce.launches += 1
    return x


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.broadcast`` from rank 0 in place, counted in ``broadcast.launches``."""
    dist.broadcast(x, src=0, group=group)
    broadcast.launches += 1
    return x


all_reduce.launches = 0
broadcast.launches = 0


def reset_launches() -> None:
    all_reduce.launches = broadcast.launches = 0


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(memory_format=torch.contiguous_format), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), dist.ReduceOp.SUM, ctx.group), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (see the module's
    docstring); the identity without a mesh."""
    mesh = _mesh()
    return x if mesh is None else _GlobalSum.apply(x, mesh.group)


def global_sums(*xs: torch.Tensor) -> tuple:
    """:func:`global_sum` of tensors of one shape and dtype, in one
    all-reduce."""
    if _mesh() is None:
        return xs
    return tuple(global_sum(torch.stack(xs)).unbind(0))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: a mean over the
    global batch where ``x`` is a mean over the rank's rows (every rank holds
    as many)."""
    mesh = _mesh()
    return x if mesh is None else _GlobalSum.apply(x, mesh.group) / mesh.world_size


def _extreme(x: torch.Tensor, op) -> torch.Tensor:
    mesh = _mesh()
    return x if mesh is None else all_reduce(x.detach().clone(), op, mesh.group)


def global_min(x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks (no gradient)."""
    return _extreme(x, dist.ReduceOp.MIN)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (no gradient)."""
    return _extreme(x, dist.ReduceOp.MAX)


def global_batch_size(b: int) -> int:
    """The global batch of which every rank holds ``b`` rows."""
    mesh = _mesh()
    return b if mesh is None else b * mesh.world_size


def own_range(b: int) -> tuple:
    """(lo, hi): this rank's rows of the global batch, when it holds ``b``."""
    mesh = _mesh()
    rank = 0 if mesh is None else mesh.rank
    return rank * b, (rank + 1) * b


def own_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """This rank's rows of ``x``, a draw made for the global batch of which
    the rank holds ``b`` rows."""
    lo, hi = own_range(b)
    return x if (lo, hi) == (0, x.shape[0]) else x[lo:hi]


def average_grads(params: Iterable[torch.Tensor]) -> None:
    """Average the parameters' gradients over the ranks, in one all-reduce of
    one flat buffer; a parameter whose ``.grad`` is ``None`` keeps it."""
    mesh = _mesh()
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), dist.ReduceOp.SUM, mesh.group)
    flat /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
