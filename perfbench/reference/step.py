"""Frozen copy of ``pointcloududa_torch/train/step.py`` (the train step only),
with the plain Chamfer loss in the kernels' place.

The 5-phase alternating UDA train step (counterpart of
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
target (phases 3-4). Batches are NHWC (``img_s``, one-hot ``mask_s``,
``img_t``) with (B, 300, 3) clouds (``vert_s``, ``vert_t``) and an optional
(B,) ``sample_mask``; numpy arrays or tensors. Metrics are 0-d tensors on the
models' device, under the JAX step's keys. One process: the port's
data-parallel averaging of gradients is left out.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import torch

from perfbench.reference import losses
from perfbench.reference.config import UDAConfig
from perfbench.reference.state import UDATrainState

SOURCE_LABEL = 1.0  # reference train_mscmrseg.py:160-161
TARGET_LABEL = 0.0


def _chamfer(cfg: UDAConfig):
    """The plain loss, whatever ``cfg.chamfer_impl`` selects in the port."""
    return losses.chamfer_loss


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
    o_s, o_t = forward(src), forward(tgt)
    loss = losses.bce_with_logits(o_s, SOURCE_LABEL, sample_mask) + losses.bce_with_logits(
        o_t, TARGET_LABEL, sample_mask
    )
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return {
        f"dis{k}_acc1": _disc_accuracy(o_s, True, sample_mask),
        f"dis{k}_acc2": _disc_accuracy(o_t, False, sample_mask),
        f"d{k}_loss": loss,
    }


def make_train_step(cfg: UDAConfig, models, optimizers):
    """Build ``step(state, batch) -> (state, metrics)`` that trains ``models``
    = (gen, d1, d2, d4) (None where disabled) in place with ``optimizers``;
    ``state`` supplies the step count and the dropout generator."""
    gen, d1, d2, d4 = models
    gen_opt, d1_opt, d2_opt, d4_opt = optimizers
    chamfer = _chamfer(cfg)
    device = _device_of(gen)
    gen_params = list(gen.parameters())
    discs = [d for d in (d1, d2, d4) if d is not None]

    def step(state: UDATrainState, batch):
        b = _tensors(batch, device)
        img_s, mask_s, img_t = b["img_s"], b["mask_s"].to(torch.float32), b["img_t"]
        vert_s, vert_t = b.get("vert_s"), b.get("vert_t")
        sm = b.get("sample_mask")
        chamfer_m = chamfer if sm is None else partial(losses.chamfer_loss, sample_mask=sm)
        rng = state.generator
        for m in (gen, *discs):
            m.train()

        # ---- phases 1+2: generator loss (supervised + adversarial) -------
        o_s, _, pv_s = gen(img_s, rng)
        probs_s = _activate(cfg, o_s)
        l1, l2 = _supervised_loss(cfg, probs_s, mask_s, sm)
        metrics = {}
        sup = l1 + l2
        if cfg.point_head:
            l3 = chamfer_m(pv_s, vert_s)
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
                metrics["ver_t_loss"] = chamfer_m(pv_t.detach(), vert_t)
        if cfg.d2:
            adv = adv + cfg.w2 * cfg.dr * losses.bce_with_logits(d2(unc_t), SOURCE_LABEL, sm)
        if cfg.d4:
            out4, _, _ = d4(pv_t, rng)
            adv = adv + cfg.w4 * cfg.dr * losses.bce_with_logits(out4, SOURCE_LABEL, sm)
        if cfg.d1:
            out1 = d1(probs_t if cfg.d1_on_probs else o_t)
            adv = adv + cfg.w1 * cfg.dr * losses.bce_with_logits(out1, SOURCE_LABEL, sm)
        gen_total = sup + adv
        gen_opt.zero_grad(set_to_none=True)
        gen_total.backward(inputs=gen_params)  # the discriminators take no gradient
        if cfg.sgd:
            # a parameter no output depends on (the encoder's unused conv1_1)
            # has no gradient, and torch's SGD would skip it; the reference
            # numerics decay every parameter, so give it a zero gradient and
            # let weight decay and momentum act on it too
            for p in gen_params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        gen_opt.step()

        metrics.update(
            seg_loss=l1 + l2, adv_loss=adv, gen_total_loss=gen_total,
            entropy_loss=ent_s, entropy_loss_T=ent_t,
        )
        with torch.no_grad():
            hard = (o_s == torch.amax(o_s, dim=-1, keepdim=True)).to(torch.float32)
            metrics["seg_dice"] = losses.dice_coef_multilabel(mask_s, hard, num_labels=4, sample_mask=sm)

        # ---- phases 3+4: discriminators on detached outputs --------------
        if cfg.d1:
            src_in, tgt_in = (probs_s, probs_t) if cfg.d1_on_probs else (o_s, o_t)
            metrics.update(discriminator_phase(d1, d1_opt, src_in.detach(), tgt_in.detach(), sm, 1))
        if cfg.d2:
            metrics.update(discriminator_phase(d2, d2_opt, unc_s.detach(), unc_t.detach(), sm, 2))
        if cfg.d4:
            # stats order: target (phase 2) -> source -> target
            d4_logits = lambda p: d4(p, rng)[0]  # noqa: E731
            metrics.update(discriminator_phase(d4_logits, d4_opt, pv_s.detach(), pv_t.detach(), sm, 4))

        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step

