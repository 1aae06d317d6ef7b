"""The port's BN statistics (``ops/bn_kernel.py`` on the CPU, i.e. its plain
versions) and ``TwinBatchNorm`` against the JAX package's ``bn_stats`` in TPU
interpret mode and its ``_TwinBatchNorm``.

Tolerances: mean atol 1e-6, mean of squares atol 1e-5, gradients atol 1e-6
(f32 sums of a few thousand values in another order); BatchNorm outputs and
running statistics atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.models.unet import _TwinBatchNorm
from pointcloududa_tpu.ops import bn_pallas
from pointcloududa_torch.models.unet import TwinBatchNorm
from pointcloududa_torch.ops import bn_kernel
from test_torch_port_step import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("c", [128, 32])
def test_stats_and_gradient_match_jax(c):
    """(rows, C) matrices; the JAX kernel runs at C=128 and falls back to
    jnp at C=32, the port takes both."""
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(512, c)) * 0.7 + 0.3).astype(np.float32)
    w_m = rng.normal(size=c).astype(np.float32)
    w_q = rng.normal(size=c).astype(np.float32)

    def jloss(a):
        m, q = bn_pallas.bn_stats(a)
        return jnp.sum(m * w_m) + jnp.sum(q * w_q)

    want_m, want_q = bn_pallas.bn_stats(jnp.asarray(x))
    want_g = jax.grad(jloss)(jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    m, q = bn_kernel.bn_stats(xt)
    (torch.sum(m * torch.tensor(w_m)) + torch.sum(q * torch.tensor(w_q))).backward()
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(want_m), atol=1e-6)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), atol=1e-6)


def test_nchw_batch_stats_match_jax_nhwc():
    """The model's NCHW activations against JAX's NHWC statistics."""
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 32)).astype(np.float32)
    want_mean, want_var = bn_pallas.batch_stats_nhwc(jnp.asarray(x))
    xt = torch.tensor(x.transpose(0, 3, 1, 2).copy())
    for use_kernel in (True, False):
        mean, var = bn_kernel.batch_stats(xt, use_kernel=use_kernel)
        np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(want_var), atol=1e-5)


def test_kernel_and_plain_gradients_agree():
    """The custom backward equals autograd of the plain forward."""
    x = torch.randn(4, 16, 5, 5, requires_grad=True)
    w_m, w_q = torch.randn(16), torch.randn(16)
    m, q = bn_kernel.bn_stats(x)
    (g1,) = torch.autograd.grad((m * w_m).sum() + (q * w_q).sum(), x)
    m, q = bn_kernel.stats_forward_plain(x)
    (g2,) = torch.autograd.grad((m * w_m).sum() + (q * w_q).sum(), x)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bn_kernel_on", [True, False])
def test_twin_batchnorm_matches_jax(bn_kernel_on):
    """Train forward and the running statistics after it (torch momentum 0.1
    = flax 0.9, unbiased running variance), then the eval forward."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 6, 16)).astype(np.float32) * 1.5 + 0.5
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0.0, 0.3, 16).astype(np.float32)
    r_mean = rng.normal(0.0, 0.3, 16).astype(np.float32)
    r_var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    jm = _TwinBatchNorm(bn_pallas=bn_kernel_on, unbiased=True)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": r_mean, "var": r_var}}
    want, mut = jm.apply(variables, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])

    tm = TwinBatchNorm(16, bn_kernel=bn_kernel_on)
    tm.load_state_dict({
        "weight": torch.tensor(scale), "bias": torch.tensor(bias), "running_mean": torch.tensor(r_mean),
        "running_var": torch.tensor(r_var), "num_batches_tracked": torch.tensor(0),
    })
    xt = torch.tensor(x.transpose(0, 3, 1, 2).copy())
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-5)
    assert int(tm.num_batches_tracked) == 1

    tm.eval()
    want_eval = jm.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x),
                         use_running_average=True)
    np.testing.assert_allclose(tm(xt).detach().numpy().transpose(0, 2, 3, 1), np.asarray(want_eval), atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    bn_kernel.reset_launches()
    x = torch.randn(3, 8, 4, 4)
    m, q = bn_kernel.stats_forward(x)
    want_m, want_q = bn_kernel.stats_forward_plain(x)
    assert torch.equal(m, want_m) and torch.equal(q, want_q)
    g = torch.randn(8)
    assert torch.equal(bn_kernel.stats_backward(x, g, g), bn_kernel.stats_backward_plain(x, g, g))
    assert bn_kernel.stats_forward.launches == 0 and bn_kernel.stats_backward.launches == 0
