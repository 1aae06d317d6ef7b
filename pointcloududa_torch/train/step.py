"""The 5-phase alternating UDA train step (counterpart of
``pointcloududa_tpu/train/step.py``).

  phase 1  supervised source loss through the generator;
  phase 2  adversarial target loss through the discriminators, whose
           parameters take no gradient -> one generator gradient and one
           generator update;
  phase 3  discriminators on source outputs vs label 1;
  phase 4  discriminators on target outputs vs label 0, both on the detached
           outputs of the generator *before* its update;
  phase 5  discriminator updates.

BatchNorm running statistics are updated in the reference's order: the
generator sees source then target; D4 sees target (phase 2), source, then
target (phases 3-4). On the card, phases 1-2 and phases 3-5 are each replayed
from a CUDA graph once their inputs' shapes have been seen, and the
generator's update runs eagerly between them (``train/step_graph.py`` says
when, and why the arithmetic is the eager block's). Batches are NHWC (``img_s``,
one-hot ``mask_s``, ``img_t``) with (B, 300, 3) clouds (``vert_s``, ``vert_t``) and an optional
(B,) ``sample_mask``; numpy arrays or tensors. Metrics are 0-d tensors on the
models' device, under the JAX step's keys.

Under a data mesh (``mesh=``) a batch holds this rank's rows of the global
batch, every batch reduction (BatchNorm statistics, losses, metrics) is the
global batch's, and each optimiser steps on the gradients averaged over the
ranks (``parallel/collectives.py`` derives why), so every rank takes the
one-process step over the global batch.
"""

from __future__ import annotations

from typing import Dict

import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.ops import chamfer_kernel, losses
from pointcloududa_torch.parallel import collectives
from pointcloududa_torch.train.step_graph import StepGraphs
from pointcloududa_torch.train.state import UDATrainState
from pointcloududa_torch.utils import timer
from pointcloududa_torch.utils.timer import trace_annotation

SOURCE_LABEL = 1.0  # reference train_mscmrseg.py:160-161
TARGET_LABEL = 0.0

# the step's spans (utils/timer.py): the generator's phases, the seg-dice block, each discriminator's phase
_SPAN = {name: trace_annotation(name) for name in (timer.STEP,) + timer.STEP_PARTS}


def _chamfer(x, y, sample_mask=None):
    """The kernels' Chamfer loss; a padded tail's batch takes the plain
    masked loss."""
    if sample_mask is None:
        return chamfer_kernel.chamfer_loss(x, y)
    return losses.chamfer_loss(x, y, sample_mask=sample_mask)


def _activate(cfg: UDAConfig, logits):
    return torch.softmax(logits, dim=-1) if cfg.softmax else torch.sigmoid(logits)


def _supervised_loss(cfg: UDAConfig, probs, mask_onehot, sample_mask=None):
    """MS-CMRSeg: BCE on sigmoid probs; MM-WHS ``-softmax``: CE on softmax
    outputs, a double softmax (``train_mmwhs.py:213-214``); plus Jaccard."""
    if cfg.softmax:
        l1 = losses.cross_entropy(probs, torch.argmax(mask_onehot, dim=-1), sample_mask=sample_mask)
    else:
        l1 = losses.bce_from_probs(probs, mask_onehot, sample_mask=sample_mask)
    return l1, losses.jaccard_loss(mask_onehot, probs, sample_mask=sample_mask)


def _entropy_map(cfg: UDAConfig, probs):
    return losses.weighted_self_information(probs, num_classes=cfg.n_class if cfg.entropy_norm else None)


def _disc_accuracy(logits, is_source: bool, sample_mask=None):
    """Fraction classified as source (sigmoid >= 0.5, i.e. logit >= 0)."""
    frac_source = losses.masked_mean((logits >= 0.0).to(torch.float32), sample_mask)
    return frac_source if is_source else 1.0 - frac_source


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


def _tensors(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def discriminator_phase(forward, opt, src, tgt, sample_mask, k: int) -> Dict[str, torch.Tensor]:
    """Phases 3-5 for discriminator ``k``: ``forward`` on the detached source,
    then target, outputs (the order D4's BatchNorm statistics see them), BCE
    towards the source and target labels, one update by ``opt``. Returns the
    discriminator's metrics."""
    update = _SPAN[f"uda.step.d{k}.update"]
    with _SPAN[f"uda.step.d{k}.forward"]:
        o_s, o_t = forward(src), forward(tgt)
        loss = losses.bce_with_logits(o_s, SOURCE_LABEL, sample_mask) + losses.bce_with_logits(
            o_t, TARGET_LABEL, sample_mask
        )
    with update:
        opt.zero_grad(set_to_none=True)
    with _SPAN[f"uda.step.d{k}.backward"]:
        loss.backward()
    with update:
        collectives.average_grads(p for group in opt.param_groups for p in group["params"])
        opt.step()
    return {
        f"dis{k}_acc1": _disc_accuracy(o_s, True, sample_mask),
        f"dis{k}_acc2": _disc_accuracy(o_t, False, sample_mask),
        f"d{k}_loss": loss,
    }


def make_train_step(cfg: UDAConfig, models, optimizers, mesh=None):
    """Build ``step(state, batch) -> (state, metrics)`` that trains ``models``
    = (gen, d1, d2, d4) (None where disabled) in place with ``optimizers``;
    ``state`` supplies the step count and the dropout generator. ``mesh``: the
    data mesh whose global batch the step trains on (``None``: this
    process's batch). ``step.gen_graphs`` and ``step.disc_graphs`` are the
    step's :class:`StepGraphs` of phases 1-2 and 3-5."""
    gen, d1, d2, d4 = models
    gen_opt, d1_opt, d2_opt, d4_opt = optimizers
    device = _device_of(gen)
    gen_params = list(gen.parameters())
    discs = [d for d in (d1, d2, d4) if d is not None]

    def disc_block(x, rng):
        """Phases 3-5 on the detached outputs ``x``, D1, D2, D4 in turn."""
        sm = x.get("sample_mask")
        metrics = {}
        if cfg.d1:
            metrics.update(discriminator_phase(d1, d1_opt, x["d1_src"], x["d1_tgt"], sm, 1))
        if cfg.d2:
            metrics.update(discriminator_phase(d2, d2_opt, x["d2_src"], x["d2_tgt"], sm, 2))
        if cfg.d4:
            # stats order: target (phase 2) -> source -> target
            d4_logits = lambda p: d4(p, rng)[0]  # noqa: E731
            metrics.update(discriminator_phase(d4_logits, d4_opt, x["d4_src"], x["d4_tgt"], sm, 4))
        return metrics, {}

    disc_params = [p for d in discs for p in d.parameters()]
    disc_graphs = StepGraphs(disc_block, device, discs, disc_params, (d1_opt, d2_opt, d4_opt), spans=timer.DISC_GRAPH,
                             max_graphs=2)

    def generator_phases(b, rng):
        """Phases 1+2 on the batch ``b`` up to the generator's gradients: the
        metrics, detached, and the detached outputs phases 3-5 take. The
        autograd graph dies with this frame, its accumulators of the
        discriminators' gradients among its nodes: a capture of either block
        makes its own on the capture's stream (an older one would
        synchronise with the stream it was made on)."""
        img_s, mask_s, img_t = b["img_s"], b["mask_s"].to(torch.float32), b["img_t"]
        vert_s, vert_t = b.get("vert_s"), b.get("vert_t")
        sm = b.get("sample_mask")

        # ---- phases 1+2: generator loss (supervised + adversarial) ---
        with _SPAN["uda.step.gen_forward"]:
            o_s, _, pv_s = gen(img_s, rng)
            probs_s = _activate(cfg, o_s)
            l1, l2 = _supervised_loss(cfg, probs_s, mask_s, sm)
            metrics = {}
            sup = l1 + l2
            if cfg.point_head:
                l3 = _chamfer(pv_s, vert_s, sm)
                metrics["ver_s_loss"] = l3
                sup = sup + cfg.wp * l3
            unc_s = _entropy_map(cfg, probs_s)
            ent_s = losses.masked_mean(torch.sum(unc_s, dim=-1), sm)
            if cfg.etpls and cfg.d2:
                sup = sup + ent_s  # train_mmwhs.py:227-230

            o_t, _, pv_t = gen(img_t, rng)
            probs_t = _activate(cfg, o_t)
            unc_t = _entropy_map(cfg, probs_t)
            ent_t = losses.masked_mean(torch.sum(unc_t, dim=-1), sm)
            adv = ent_t if cfg.Tetpls else torch.zeros((), device=device)
            if cfg.point_head and vert_t is not None:
                # logged only, never backpropagated (train_mscmrseg.py:230-231)
                with torch.no_grad():
                    metrics["ver_t_loss"] = _chamfer(pv_t.detach(), vert_t, sm)
            if cfg.d2:
                adv = adv + cfg.w2 * cfg.dr * losses.bce_with_logits(d2(unc_t), SOURCE_LABEL, sm)
            if cfg.d4:
                out4, _, _ = d4(pv_t, rng)
                adv = adv + cfg.w4 * cfg.dr * losses.bce_with_logits(out4, SOURCE_LABEL, sm)
            if cfg.d1:
                out1 = d1(probs_t if cfg.d1_on_probs else o_t)
                adv = adv + cfg.w1 * cfg.dr * losses.bce_with_logits(out1, SOURCE_LABEL, sm)
            gen_total = sup + adv
        with _SPAN["uda.step.gen_update"]:
            gen_opt.zero_grad(set_to_none=True)
        with _SPAN["uda.step.gen_backward"]:
            gen_total.backward(inputs=gen_params)  # the discriminators take no gradient
            if cfg.sgd:
                # a parameter no output depends on (the encoder's unused conv1_1)
                # has no gradient, and torch's SGD would skip it; the reference
                # numerics decay every parameter, so give it a zero gradient and
                # let weight decay and momentum act on it too
                for p in gen_params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)

        metrics.update(
            seg_loss=l1 + l2, adv_loss=adv, gen_total_loss=gen_total,
            entropy_loss=ent_s, entropy_loss_T=ent_t,
        )
        with _SPAN["uda.step.metrics"], torch.no_grad():
            hard = (o_s == torch.amax(o_s, dim=-1, keepdim=True)).to(torch.float32)
            metrics["seg_dice"] = losses.dice_coef_multilabel(mask_s, hard, num_labels=4, sample_mask=sm)

        # ---- what phases 3-5 take: the outputs, detached
        x = {}
        if cfg.d1:
            src_in, tgt_in = (probs_s, probs_t) if cfg.d1_on_probs else (o_s, o_t)
            x["d1_src"], x["d1_tgt"] = src_in.detach(), tgt_in.detach()
        if cfg.d2:
            x["d2_src"], x["d2_tgt"] = unc_s.detach(), unc_t.detach()
        if cfg.d4:
            x["d4_src"], x["d4_tgt"] = pv_s.detach(), pv_t.detach()
        if sm is not None:
            x["sample_mask"] = sm
        return {k: v.detach() for k, v in metrics.items()}, x

    # full batch and padded tail, each with and without the cadence's vert_t
    gen_graphs = StepGraphs(generator_phases, device, models, gen_params, spans=timer.GEN_GRAPH, max_graphs=4)

    def step(state: UDATrainState, batch):
        with _SPAN["uda.step"]:
            for m in (gen, *discs):
                m.train()
            # ---- phases 1+2, eagerly or from one CUDA graph, then the generator's update
            metrics, x = gen_graphs(_tensors(batch, device), state.generator)
            with _SPAN["uda.step.gen_update"]:
                collectives.average_grads(gen_params)  # after the zero gradients: every rank decays conv1_1 alike
                gen_opt.step()
            # ---- phases 3-5: discriminators on detached outputs, eagerly or from one CUDA graph
            if discs:
                metrics.update(disc_graphs(x, state.generator)[0])
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

    step.gen_graphs = gen_graphs
    step.disc_graphs = disc_graphs
    return collectives.within(mesh, step)


def make_eval_step(cfg: UDAConfig, gen, mesh=None):
    """``eval_step(batch) -> {"loss", "dice", "vert_loss", "logits"}`` on a
    batch with NHWC ``img``, one-hot ``mask``, optional ``vert`` and
    ``sample_mask``: the reference's validation loss and mean foreground
    Dice (``train_mscmrseg.py:53-99``), the generator in eval mode. Under
    ``mesh`` the metrics are the global batch's and ``logits`` this rank's
    rows."""
    device = _device_of(gen)

    def binary_dice(pred_lbl, true_lbl, c, sm):
        p = (pred_lbl == c).to(torch.float32)
        t = (true_lbl == c).to(torch.float32)
        if sm is not None:
            m = sm.to(torch.float32).reshape((-1,) + (1,) * (p.dim() - 1))
            p, t = p * m, t * m
        inter, denom = collectives.global_sums(torch.sum(p * t), torch.sum(p) + torch.sum(t))
        # medpy dc: 0 when both structures are empty
        return torch.where(denom > 0, 2.0 * inter / torch.clamp_min(denom, 1.0), torch.zeros_like(denom))

    @torch.no_grad()
    def eval_step(batch):
        b = _tensors(batch, device)
        sm = b.get("sample_mask")
        was_training = gen.training
        gen.eval()
        try:
            o, _, pv = gen(b["img"])
        finally:
            gen.train(was_training)
        mask = b["mask"].to(torch.float32)
        l1, l2 = _supervised_loss(cfg, _activate(cfg, o), mask, sm)
        loss = l1 + l2
        vert_loss = torch.full((), -1.0, device=device)
        if cfg.point_head:
            vert_loss = _chamfer(pv, b["vert"], sm)
            if cfg.workload == "mscmrseg" and cfg.d4:
                # MS-CMRSeg adds the chamfer term to the reported valid loss
                # (train_mscmrseg.py:72-78); MM-WHS does not (train_mmwhs.py:81)
                loss = loss + vert_loss
        pred_lbl = torch.argmax(o, dim=-1)
        true_lbl = torch.argmax(mask, dim=-1)
        dices = torch.stack([binary_dice(pred_lbl, true_lbl, c, sm) for c in range(1, cfg.n_class)])
        return {"loss": loss, "dice": torch.sum(dices) / (cfg.n_class - 1), "vert_loss": vert_loss, "logits": o}

    return collectives.within(mesh, eval_step)
