"""The port's Chamfer loss (``ops/chamfer_kernel.py`` on the CPU, i.e. its
plain versions, and ``ops/losses.chamfer_loss``) against the JAX package's
``chamfer_loss_pallas`` in TPU interpret mode and its jnp ``chamfer_loss``.

Tolerances: loss rtol 1e-5 (f32 sums in another order); argmins equal (the
same |x|^2 + |y|^2 - 2 x.y expansion, so near-ties resolve alike); gradients
atol 1e-6 (the same per-pair unit vectors, summed in index order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import chamfer_pallas
from pointcloududa_tpu.ops import losses as jlosses
from pointcloududa_torch.ops import chamfer_kernel as ck
from pointcloududa_torch.ops import losses
from test_torch_port_step import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _clouds(seed, b, n, m):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(b, n, 3)).astype(np.float32), rng.uniform(size=(b, m, 3)).astype(np.float32)


def _check_against_jax(x, y):
    want_loss, want_i1, want_i2 = chamfer_pallas._chamfer_fwd_any(jnp.asarray(x), jnp.asarray(y))
    want_dx, want_dy = jax.grad(chamfer_pallas.chamfer_loss_pallas, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    loss, i1, i2 = ck.chamfer_forward(xt.detach(), yt.detach())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want_i1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(want_i2))
    ck.chamfer_loss(xt, yt).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_dy), atol=1e-6)
    # the plain loss (chamfer_impl="jnp") agrees too
    np.testing.assert_allclose(float(losses.chamfer_loss(xt.detach(), yt.detach())), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("b,n,m", [(3, 40, 40), (2, 300, 300), (2, 57, 33)])
def test_small_clouds_match_jax(b, n, m):
    """n*m <= 512^2: the JAX kernel holds the whole matrix per item."""
    _check_against_jax(*_clouds(b * n + m, b, n, m))


def test_tiled_regime_matches_jax():
    """n*m > 512^2: the JAX tiled kernels and segment_sum backward."""
    x, y = _clouds(6, 2, 600, 530)
    assert 600 * 530 > chamfer_pallas._SMALL_LIMIT
    _check_against_jax(x, y)


def test_ties_take_the_lowest_index():
    """Every point appears twice: both argmins pick the first copy, as
    jnp.argmin does."""
    base, _ = _clouds(7, 2, 50, 1)
    dup = np.concatenate([base, base], axis=1)
    _, i1, i2 = ck.chamfer_forward(torch.tensor(dup), torch.tensor(dup))
    want = np.tile(np.arange(100) % 50, (2, 1))
    np.testing.assert_array_equal(i1.numpy(), want)
    np.testing.assert_array_equal(i2.numpy(), want)
    _check_against_jax(dup, dup)


def _fused_case(kind):
    if kind == "n_above_m":
        return _clouds(21, 2, 57, 33)
    if kind == "n_below_m":
        return _clouds(22, 3, 20, 75)
    base, _ = _clouds(23, 2, 40, 1)  # every point twice: each argmin is a tie
    dup = np.concatenate([base, base], axis=1)
    return dup, dup.copy()


@pytest.mark.parametrize("kind", ["n_above_m", "n_below_m", "duplicated_points"])
def test_fused_forward_matches_the_jax_kernel(kind):
    """The one-launch forward's three outputs against ``_chamfer_fwd`` (the
    Pallas kernel, interpret mode): per-item means rtol 1e-5 (f32 sums in
    another order), argmins equal."""
    x, y = _fused_case(kind)
    want_parts, want_i1, want_i2 = chamfer_pallas._chamfer_fwd(jnp.asarray(x), jnp.asarray(y))
    ck.reset_launches()
    parts, i1, i2 = ck.forward_fused(torch.tensor(x), torch.tensor(y))
    assert ck.forward_fused.launches == 0  # CPU tensors: the plain version, no launch
    assert tuple(parts.shape) == (x.shape[0], 2) and parts.dtype == torch.float32
    assert i1.dtype == torch.int32 and i2.dtype == torch.int32
    np.testing.assert_allclose(parts.numpy(), np.asarray(want_parts), rtol=1e-5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want_i1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(want_i2))
    if kind == "duplicated_points":
        half = x.shape[1] // 2
        np.testing.assert_array_equal(i1.numpy(), np.tile(np.arange(2 * half) % half, (x.shape[0], 1)))
    # the loss is one reduction over the (B, 2) means, as the JAX package takes it
    loss, _, _ = ck.chamfer_forward(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(parts[:, 0].mean() + parts[:, 1].mean()), rtol=1e-6)


def test_sample_mask_matches_jax():
    """The padded-tail path: the masked plain loss, value and gradients."""
    x, y = _clouds(8, 4, 30, 30)
    sm = np.array([1, 0, 1, 1], np.float32)

    def jf(a, b):
        return jlosses.chamfer_loss(a, b, sample_mask=jnp.asarray(sm))

    want = jf(jnp.asarray(x), jnp.asarray(y))
    want_dx, want_dy = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    got = losses.chamfer_loss(xt, yt, sample_mask=torch.tensor(sm))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_dy), atol=1e-6)
    assert not xt.grad[1].any()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    ck.reset_launches()
    x, y = (torch.tensor(a) for a in _clouds(9, 2, 20, 20))
    mins, idx = ck.nn_directional(x, y)
    want_mins, want_idx = ck.nn_directional_plain(x, y)
    assert torch.equal(mins, want_mins) and torch.equal(idx, want_idx) and idx.dtype == torch.int32
    g = torch.tensor(1.0)
    _, idx2 = ck.nn_directional(y, x)
    assert torch.equal(ck.side_grad(x, y, idx, idx2, g), ck.side_grad_plain(x, y, idx, idx2, g))
    parts, f1, f2 = ck.forward_fused(x, y)
    assert torch.equal(f1, idx) and torch.equal(f2, idx2)
    assert torch.equal(parts, ck.forward_fused_plain(x, y)[0])
    assert ck.nn_directional.launches == 0 and ck.side_grad.launches == 0 and ck.forward_fused.launches == 0


def _grad_case(kind):
    rng = np.random.default_rng(31)
    if kind == "n_above_m":
        return _clouds(32, 2, 57, 33)
    if kind == "n_below_m":
        return _clouds(33, 3, 20, 75)
    if kind == "duplicated_points":  # half of the points are chosen twice, the other half never
        base, _ = _clouds(34, 2, 40, 1)
        dup = np.concatenate([base, base], axis=1)
        return dup, dup.copy()
    a = (rng.uniform(size=(2, 30, 3)) + 10.0).astype(np.float32)  # one point of a chosen by every point of c
    a[:, 0] = 0.5
    return a, rng.uniform(size=(2, 17, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["n_above_m", "n_below_m", "duplicated_points", "one_point_chosen_by_all"])
def test_side_grad_plain_matches_the_jax_gradient(kind):
    """``side_grad_plain``, which the card holds the backward kernel against,
    is ``jax.grad`` of ``chamfer_loss_pallas`` (interpret mode) in both clouds,
    at atol 1e-6 and with an upstream gradient other than 1."""
    x, y = _grad_case(kind)
    want_dx, want_dy = jax.grad(lambda a, b: 0.7 * chamfer_pallas.chamfer_loss_pallas(a, b), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.tensor(x), torch.tensor(y)
    _, i1, i2 = ck.forward_fused_plain(xt, yt)
    g = torch.tensor(0.7)
    np.testing.assert_allclose(ck.side_grad_plain(xt, yt, i1, i2, g).numpy(), np.asarray(want_dx), atol=1e-6)
    np.testing.assert_allclose(ck.side_grad_plain(yt, xt, i2, i1, g).numpy(), np.asarray(want_dy), atol=1e-6)
    if kind == "one_point_chosen_by_all":
        assert not i2.any() and float(np.abs(np.asarray(want_dx)[:, 0]).max()) > 10 * float(np.abs(np.asarray(want_dx)[:, 1:]).max())
