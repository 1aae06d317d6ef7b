"""Losses and uncertainty maps, the PyTorch counterpart of
``pointcloududa_tpu/ops/losses.py``.

Same formulas, epsilons and quirks, on NHWC tensors with the class axis last
(``class_axis=-1``), so the two packages compare like with like:

- ``bce_from_probs`` is ``torch.nn.BCELoss``: log terms clamped at -100 in the
  forward, ``p (1 - p)`` clamped at 1e-12 in the backward;
- ``cross_entropy`` is the standard CE; the trainer feeds it softmax outputs
  under ``cfg.softmax`` (the reference's double softmax);
- ``chamfer_loss`` clamps the pairwise term at 0 (PARITY.md deviation 4);
- ``dice_coef_multilabel`` keeps ``num_labels=4``.

Every reduction takes an optional (B,) ``sample_mask`` that drops the padded
entries of a tail batch. Under a data mesh every reduction over the batch is
the global batch's (``parallel/collectives.py``): sums are all-reduced before
a ratio is formed, and a mean over the rank's rows is averaged over the
ranks, which hold as many rows each.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pointcloududa_torch.parallel import collectives

_LOG_CLAMP = -100.0


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.log(x), _LOG_CLAMP)


def _expand_mask(sample_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) 0/1 validity mask -> broadcastable (B, 1, ..., 1) float32."""
    m = sample_mask.to(torch.float32)
    return m.reshape(m.shape + (1,) * (ndim - m.ndim))


def masked_mean(x: torch.Tensor, sample_mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over all elements, counting only batch entries whose mask is 1."""
    if sample_mask is None:
        return collectives.global_mean(torch.mean(x))
    x = x.to(torch.float32)
    w = torch.broadcast_to(_expand_mask(sample_mask, x.ndim), x.shape)
    num, den = collectives.global_sums(torch.sum(x * w), torch.sum(w))
    return num / den


def bce_from_probs(
    probs: torch.Tensor, targets: torch.Tensor, sample_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Binary cross-entropy on probabilities with torch ``BCELoss`` numerics
    (forward and backward clamps), mean-reduced over valid samples."""
    probs = probs.to(torch.float32)
    targets = targets.to(torch.float32)
    if sample_mask is None:
        return collectives.global_mean(F.binary_cross_entropy(probs, targets))
    w = torch.broadcast_to(_expand_mask(sample_mask, probs.ndim), probs.shape)
    num, den = collectives.global_sums(F.binary_cross_entropy(probs, targets, weight=w, reduction="sum"), torch.sum(w))
    return num / den


def bce_with_logits(
    logits: torch.Tensor, targets, sample_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Stable BCE on logits; ``targets`` may be a scalar domain label, which
    is filled on the logits' device (no copy from the host, so the loss can
    be captured in a CUDA graph)."""
    logits = logits.to(torch.float32)
    if isinstance(targets, (int, float)):
        targets = torch.full((), targets, dtype=torch.float32, device=logits.device)
    targets = torch.broadcast_to(torch.as_tensor(targets, dtype=torch.float32, device=logits.device), logits.shape)
    loss = torch.clamp_min(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    return masked_mean(loss, sample_mask)


def cross_entropy(
    inputs: torch.Tensor,
    labels: torch.Tensor,
    class_axis: int = -1,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-class CE with integer labels (log-softmax applied here)."""
    logp = torch.log_softmax(inputs.to(torch.float32), dim=class_axis)
    nll = -torch.gather(logp, class_axis, labels.long().unsqueeze(class_axis)).squeeze(class_axis)
    return masked_mean(nll, sample_mask)


def jaccard_loss(
    true: torch.Tensor,
    probs: torch.Tensor | None = None,
    *,
    logits: torch.Tensor | None = None,
    eps: float = 1e-7,
    class_axis: int = -1,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft Jaccard loss ``1 - mean_c(inter / (union + eps))``, sums over
    batch and space per class (reference ``src/utils/loss.py:5-37``)."""
    if (probs is None) == (logits is None):
        raise ValueError("pass exactly one of probs= or logits=")
    true = true.to(torch.float32)
    if logits is not None:
        logits = logits.to(torch.float32)
        if logits.shape[class_axis] == 1:
            pos = torch.sigmoid(logits)
            probs = torch.cat([pos, 1.0 - pos], dim=class_axis)
            true = torch.cat([true, 1.0 - true], dim=class_axis)
        else:
            probs = torch.softmax(logits, dim=class_axis)
    probs = probs.to(torch.float32)
    if sample_mask is not None:
        m = _expand_mask(sample_mask, probs.ndim)
        probs = probs * m
        true = true * m
    axis = class_axis % probs.ndim
    reduce_dims = tuple(d for d in range(probs.ndim) if d != axis)
    # per-class sums over the global batch before the ratio (a mean of the
    # ranks' Jaccards would be another loss)
    intersection, cardinality = collectives.global_sums(
        torch.sum(probs * true, dim=reduce_dims), torch.sum(probs + true, dim=reduce_dims)
    )
    union = cardinality - intersection
    return 1.0 - torch.mean(intersection / (union + eps))


def weighted_self_information(
    probs: torch.Tensor, *, eps: float = 1e-7, num_classes: int | None = None
) -> torch.Tensor:
    """``-P log(P + eps)``, divided by ``log C`` when ``num_classes`` is set."""
    probs = probs.to(torch.float32)
    out = -1.0 * probs * torch.log(probs + eps)
    if num_classes is not None:
        out = out / math.log(num_classes)
    return out


def batch_pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N, D), (B, M, D) -> (B, N, M) squared distances as
    ``|x|^2 + |y|^2 - 2 x.y``.

    Each sum over D is written out term by term, so every product and partial
    sum is rounded on its own in a fixed order; the CUDA Chamfer kernel
    (csrc/chamfer.cu) rounds the same way and so picks the same argmins."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = x[..., 0] * x[..., 0]
    yy = y[..., 0] * y[..., 0]
    zz = x[:, :, None, 0] * y[:, None, :, 0]
    for d in range(1, x.shape[-1]):
        xx = xx + x[..., d] * x[..., d]
        yy = yy + y[..., d] * y[..., d]
        zz = zz + x[:, :, None, d] * y[:, None, :, d]
    return (xx[:, :, None] + yy[:, None, :]) - 2.0 * zz


def chamfer_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    eps: float = 1e-5,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Symmetric Chamfer distance (reference ``batch_NN_loss``), with the
    pairwise term clamped at 0 before ``sqrt(. + eps)``."""
    p = torch.clamp_min(batch_pairwise_dist(x, y), 0.0)
    d = torch.sqrt(p + eps)
    forward = torch.mean(torch.amin(d, dim=2), dim=1)  # x -> nearest y
    backward = torch.mean(torch.amin(d, dim=1), dim=1)  # y -> nearest x
    return masked_mean(forward, sample_mask) + masked_mean(backward, sample_mask)


def dice_coef_multilabel(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    class_axis: int = -1,
    num_labels: int = 4,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean foreground Dice over classes 1..num_labels-1 with +1 smoothing."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    if sample_mask is not None:
        m = _expand_mask(sample_mask, y_true.ndim)
        y_true = y_true * m
        y_pred = y_pred * m
    y_true = torch.movedim(y_true, class_axis, -1)
    y_pred = torch.movedim(y_pred, class_axis, -1)
    n_class = y_true.shape[-1]
    flat_t = y_true.reshape(-1, n_class)
    flat_p = y_pred.reshape(-1, n_class)
    inter, denom = collectives.global_sums(
        torch.sum(flat_t * flat_p, dim=0), torch.sum(flat_t, dim=0) + torch.sum(flat_p, dim=0)
    )
    dice = (2.0 * inter + 1.0) / (denom + 1.0)
    return torch.mean(dice[1:num_labels])
