"""The reference's training iteration: the models built from the
configuration, the weights the benchmark made, the optimisers and the
trainer's generators, then the device preprocess and the 5-phase step on
each raw batch, as ``UDATrainer.train_epoch`` runs them."""

from __future__ import annotations

import torch

from perfbench.reference.config import UDAConfig
from perfbench.reference.numerics import set_operand_rounding
from perfbench.reference.preprocess import generators, make_device_preprocess
from perfbench.reference.state import UDATrainState, build_models, build_optimizers
from perfbench.reference.step import make_train_step

NETS = ("gen", "d1", "d2", "d4")


def model_leaves(cfg: UDAConfig) -> dict:
    """``{net: [(name, module, leaf, shape)]}`` of every parameter and buffer
    in ``state_dict`` order, each with the module that holds it, from models
    built on the meta device (nothing is allocated or drawn)."""
    with torch.device("meta"):
        models = build_models(cfg, None)
    out = {}
    for net, module in zip(NETS, models):
        if module is None:
            continue
        leaves = []
        for mod_name, mod in module.named_modules():
            for leaf, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
                leaves.append((f"{mod_name}.{leaf}" if mod_name else leaf, mod, leaf, tuple(t.shape)))
        out[net] = leaves
    return out


class ReferenceRun:
    """One training run of the reference on ``device`` from ``weights``
    (``{net: state_dict}``). ``operand_round``: the control's rounding of
    every product's operands (``numerics.tf32``, ``numerics.fp8_e4m3``), or
None."""

    def __init__(self, cfg: UDAConfig, weights: dict, device, operand_round=None, device_augment: bool = True):
        self.cfg = cfg
        with torch.device("meta"):
            models = build_models(cfg, None)
        built = []
        for net, module in zip(NETS, models):
            if module is None:
                built.append(None)
                continue
            module = module.to_empty(device=device)
            module.load_state_dict(weights[net])
            if operand_round is not None:
                set_operand_rounding(module, operand_round)
            built.append(module)
        self.models = tuple(built)
        self.optimizers = build_optimizers(cfg, self.models)
        self.gens = generators(cfg.seed, device)
        self.state = UDATrainState(self.models, self.optimizers, 0, self.gens["dropout"])
        self.pre = make_device_preprocess(cfg, device, device_augment)
        self.step = make_train_step(cfg, self.models, self.optimizers)

    def preprocess(self, raw: dict) -> dict:
        return self.pre(self.gens["aug"], raw, with_vert_t=True, host_generator=self.gens["aug_host"])

    def iterate(self, raw: dict, batch_fn=None) -> dict:
        """One iteration on a raw host batch; returns the step's metrics.
        ``batch_fn`` alters the preprocessed batch before the step (a planted
        fault)."""
        batch = self.preprocess(raw)
        return self.step_on(batch if batch_fn is None else batch_fn(batch))

    def step_on(self, batch: dict) -> dict:
        """One step on a preprocessed batch; returns its metrics."""
        self.state, metrics = self.step(self.state, batch)
        return metrics
