"""Every loss of ``pointcloududa_torch/ops/losses.py`` against its JAX
counterpart in ``pointcloududa_tpu/ops/losses.py``, with and without a
``sample_mask``, on inputs made from a numpy seed.

Tolerance: rtol 1e-5, atol 1e-6 on values and gradients (f32 reductions in
another order); the saturated-BCE case checks the clamps exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import losses as jl
from pointcloududa_torch.ops import losses as tl
from test_torch_port_step import one_torch_thread  # noqa: F401

MASKS = [None, np.array([1, 0, 1], np.float32)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


def _probs(rng, shape):
    e = np.exp(rng.normal(size=shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, shape):
    return np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1], size=shape[:-1])]


def _jm(m):
    return None if m is None else jnp.asarray(m)


def _tm(m):
    return None if m is None else torch.tensor(m)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", MASKS)
def test_masked_mean(mask):
    x = _rng(0).normal(size=(3, 4, 5)).astype(np.float32)
    _close(tl.masked_mean(torch.tensor(x), _tm(mask)), jl.masked_mean(jnp.asarray(x), _jm(mask)))


@pytest.mark.parametrize("mask", MASKS)
def test_bce_from_probs_value_and_gradient(mask):
    rng = _rng(1)
    p = rng.uniform(0.01, 0.99, size=(3, 6, 6, 4)).astype(np.float32)
    p[0, 0, 0] = [0.0, 1.0, 0.0, 1.0]  # saturated: forward -100 clamp, backward 1e-12 clamp
    t = _onehot(rng, (3, 6, 6, 4))
    want, want_g = jax.value_and_grad(lambda a: jl.bce_from_probs(a, jnp.asarray(t), _jm(mask)))(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = tl.bce_from_probs(pt, torch.tensor(t), _tm(mask))
    got.backward()
    _close(got, want)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    assert np.isfinite(pt.grad.numpy()).all()


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits(mask, target):
    x = (_rng(2).normal(size=(3, 4, 4, 1)) * 5).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda a: jl.bce_with_logits(a, target, _jm(mask)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tl.bce_with_logits(xt, target, _tm(mask))
    got.backward()
    _close(got, want)
    _close(xt.grad, want_g)


@pytest.mark.parametrize("mask", MASKS)
def test_cross_entropy_double_softmax(mask):
    """The MM-WHS composition: CE fed softmax outputs."""
    rng = _rng(3)
    probs = _probs(rng, (3, 5, 5, 5))
    labels = rng.integers(0, 5, size=(3, 5, 5))
    want = jl.cross_entropy(jnp.asarray(probs), jnp.asarray(labels), sample_mask=_jm(mask))
    _close(tl.cross_entropy(torch.tensor(probs), torch.tensor(labels), sample_mask=_tm(mask)), want)


@pytest.mark.parametrize("mask", MASKS)
def test_jaccard_probs_and_logits(mask):
    rng = _rng(4)
    true = _onehot(rng, (3, 6, 6, 4))
    probs = _probs(rng, (3, 6, 6, 4))
    logits = rng.normal(size=(3, 6, 6, 4)).astype(np.float32)
    _close(tl.jaccard_loss(torch.tensor(true), torch.tensor(probs), sample_mask=_tm(mask)),
           jl.jaccard_loss(jnp.asarray(true), jnp.asarray(probs), sample_mask=_jm(mask)))
    _close(tl.jaccard_loss(torch.tensor(true), logits=torch.tensor(logits), sample_mask=_tm(mask)),
           jl.jaccard_loss(jnp.asarray(true), logits=jnp.asarray(logits), sample_mask=_jm(mask)))
    # the single-channel sigmoid branch (reference loss.py:15-23)
    t1 = true[..., :1]
    l1 = logits[..., :1]
    _close(tl.jaccard_loss(torch.tensor(t1), logits=torch.tensor(l1), sample_mask=_tm(mask)),
           jl.jaccard_loss(jnp.asarray(t1), logits=jnp.asarray(l1), sample_mask=_jm(mask)))
    with pytest.raises(ValueError):
        tl.jaccard_loss(torch.tensor(true))


@pytest.mark.parametrize("num_classes", [None, 5])
def test_weighted_self_information(num_classes):
    p = _probs(_rng(5), (2, 4, 4, 5))
    p[0, 0, 0, 0] = 0.0  # the 1e-7 keeps log finite
    _close(tl.weighted_self_information(torch.tensor(p), num_classes=num_classes),
           jl.weighted_self_information(jnp.asarray(p), num_classes=num_classes))


def test_batch_pairwise_dist():
    rng = _rng(6)
    x = rng.uniform(size=(2, 7, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 5, 3)).astype(np.float32)
    _close(tl.batch_pairwise_dist(torch.tensor(x), torch.tensor(y)), jl.batch_pairwise_dist(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("mask", MASKS)
def test_chamfer_loss(mask):
    rng = _rng(7)
    x = rng.uniform(size=(3, 20, 3)).astype(np.float32)
    y = rng.uniform(size=(3, 25, 3)).astype(np.float32)
    _close(tl.chamfer_loss(torch.tensor(x), torch.tensor(y), sample_mask=_tm(mask)),
           jl.chamfer_loss(jnp.asarray(x), jnp.asarray(y), sample_mask=_jm(mask)))


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("n_class", [4, 5])
def test_dice_coef_multilabel(mask, n_class):
    """num_labels=4 also for 5 classes: the reference's quirk."""
    rng = _rng(8)
    true = _onehot(rng, (3, 6, 6, n_class))
    pred = _onehot(rng, (3, 6, 6, n_class))
    _close(tl.dice_coef_multilabel(torch.tensor(true), torch.tensor(pred), num_labels=4, sample_mask=_tm(mask)),
           jl.dice_coef_multilabel(jnp.asarray(true), jnp.asarray(pred), num_labels=4, sample_mask=_jm(mask)))
