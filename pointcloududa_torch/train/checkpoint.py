"""Checkpointing with the reference's best/last/.Scr-rename semantics
(counterpart of the JAX package's ``train/checkpoint.py``).

Mirrors ``src/utils/callbacks.py:33-94`` (``ModelCheckPointCallback``):
- tracks a monitor (``val_lge_dice``, mode=max);
- saves the best ``{epoch, model_state, optimizer_state}`` per network;
- at the final epoch renames the best checkpoint to embed the score
  (``...Scr{monitor:.3}``, ``callbacks.py:81-83``) and writes a last-model
  snapshot;
- one callback instance per network (generator + each discriminator,
  ``train_mscmrseg.py:469-501``).

Storage is one ``torch.save`` file per checkpoint (the JAX package writes an
Orbax directory). A file is written under a temporary name and moved into
place with ``os.replace``, so a run killed while it saves leaves the previous
checkpoint, never half of a new one. Files hold tensors and Python scalars
only and are read with ``torch.load(..., weights_only=True)``: a numpy object
in a payload would be refused there, so ``save_pytree`` refuses it first.

Layout of a network's checkpoint, the reference's ``{epoch, model_state,
optimizer_state}``::

    {"epoch": int,
     "state": {"net": {"model": module.state_dict(),
                       "optimizer": optimizer.state_dict()},
               "config": None}}

``EarlyStoppingCallback`` (``callbacks.py:6-30``) is reproduced too, wired
behind a config knob rather than dead like the reference's.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch


def _check_storable(tree: Any, where: str = "") -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_storable(v, f"{where}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_storable(v, f"{where}[{i}]")
    elif isinstance(tree, (np.ndarray, np.generic)):
        raise TypeError(f"checkpoint entry {where or '/'} is a numpy object; store a tensor or a Python scalar")


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors and Python
    scalars) to the file ``path``, atomically."""
    _check_storable(tree)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def rank_dir(path: str, rank: int) -> str:
    """The directory a data-parallel rank writes in place of ``path``: rank 0
    owns ``path``, rank i writes under ``path/.rank{i}`` (as the JAX
    package's training CLIs lay them out), so two ranks never write one
    file."""
    return path if rank == 0 else os.path.join(path, f".rank{rank}")


def rank_file(path: str, rank: int) -> str:
    """The file a data-parallel rank writes in place of ``path``: rank 0's is
    ``path``, rank i's ``.rank{i}/<name>`` beside it."""
    head, name = os.path.split(path)
    return os.path.join(rank_dir(head, rank), name)


def restore_pytree(path: str) -> Any:
    """Read a :func:`save_pytree` file; every tensor comes back on the CPU
    (``load_state_dict`` copies it to where the module lives)."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def net_state(module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer]) -> dict:
    """One network's state in the checkpoint layout (references, not copies:
    save it before the next step changes the tensors)."""
    state = {"model": module.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    return state


def _reference_optimizer_state(opt_state: dict, file_order: list, module: torch.nn.Module) -> dict:
    """The reference's ``optimizer_state_dict`` with its parameter indices
    moved to ``module``'s order. The reference's optimisers list
    ``module.parameters()``, which is the order of the parameter entries of
    its ``model_state_dict`` (``file_order``); the port's modules carry the
    reference's names, so each index is moved by name (the weights loaded
    strictly first, so both name the same parameters)."""
    ours = [name for name, _ in module.named_parameters()]
    to_ours = {i: ours.index(name) for i, name in enumerate(file_order)}
    # a loaded group's i-th index names the optimiser's i-th parameter, which
    # is the module's i-th: so each group lists its indices in the module's order
    groups = [dict(g, params=sorted(to_ours[i] for i in g["params"])) for g in opt_state["param_groups"]]
    return {"state": {to_ours[i]: st for i, st in opt_state["state"].items()}, "param_groups": groups}


def restore_net_state(path: str, module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> torch.nn.Module:
    """Load one network's weights (and its optimiser's state, when an
    optimiser is given and the file has one) from a checkpoint file in any
    of three layouts:

    - the port's trainer layout ``{"epoch", "state": {"net": {"model",
      "optimizer"}}}``;
    - the reference's callback layout ``{"epoch", "model_state_dict",
      "optimizer_state_dict"}`` (``src/utils/callbacks.py:75-80``; its
      released ``.pt`` files, written by torch 1.4), unwrapped as the JAX
      package's ``utils/torch_import.py:unwrap_payload`` does. Its optimiser
      state is indexed in the reference's parameter order, and is moved to
      the module's order by parameter name;
    - a bare ``state_dict``.
    """
    payload = restore_pytree(path)
    if isinstance(payload, dict) and "state" in payload and "net" in payload["state"]:
        net = payload["state"]["net"]
        module.load_state_dict(net["model"])
        if optimizer is not None and "optimizer" in net:
            optimizer.load_state_dict(net["optimizer"])
    elif isinstance(payload, dict) and "model_state_dict" in payload:
        weights = payload["model_state_dict"]
        module.load_state_dict(weights)
        opt_state = payload.get("optimizer_state_dict")
        if optimizer is not None and opt_state is not None:
            params = {name for name, _ in module.named_parameters()}
            order = [name for name in weights if name in params]
            optimizer.load_state_dict(_reference_optimizer_state(opt_state, order, module))
    else:
        module.load_state_dict(payload)
    return module


class EarlyStoppingCallback:
    """Patience counter (reference ``callbacks.py:6-30``)."""

    def __init__(self, patience: int, mode: str = "min"):
        assert mode in ("min", "max")
        self.patience = patience
        self.mode = mode
        self.counter = 0
        self.best_result = np.inf if mode == "min" else -np.inf

    def step(self, monitor: float) -> None:
        better = monitor > self.best_result if self.mode == "max" else monitor < self.best_result
        if better:
            self.best_result = monitor
            self.counter = 0
        else:
            self.counter += 1

    def should_stop(self) -> bool:
        return self.counter >= self.patience


class ModelCheckpointCallback:
    """Best/last checkpointing for ONE network's state tree."""

    def __init__(
        self,
        mode: str = "min",
        best_model_name: Optional[str] = None,
        save_best: bool = False,
        save_last_model: bool = False,
        model_name: str = "weights/model_checkpoint",
        n_epochs: int = 200,
    ):
        assert mode in ("min", "max")
        self.mode = mode
        self.best_result = np.inf if mode == "min" else -np.inf
        self.model_name = model_name
        self.best_model_name = best_model_name or model_name
        self.save_last_model = save_last_model
        self.n_epochs = n_epochs
        self.epoch = 0
        self._save_best = save_best
        self.final_best_path: Optional[str] = None

    def _payload(self, tree: Any, epoch: int) -> Any:
        return {"epoch": int(epoch), "state": tree}

    def step(self, monitor: float, tree: Any, epoch: int) -> None:
        if self._save_best:
            better = monitor > self.best_result if self.mode == "max" else monitor < self.best_result
            if epoch == 1 or better:
                self.best_result = monitor
                self.epoch = epoch
                save_pytree(self.best_model_name, self._payload(tree, epoch))
            if epoch == self.n_epochs:
                scored = f"{self.best_model_name}.Scr{np.around(self.best_result, 3)}"
                if os.path.exists(self.best_model_name):
                    os.replace(self.best_model_name, scored)  # over an earlier run's file of that name
                self.final_best_path = scored
        if self.save_last_model and epoch == self.n_epochs:
            save_pytree(self.model_name, self._payload(tree, epoch))
