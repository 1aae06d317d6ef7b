"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device every test skips (the kernels have no
CPU mode). On the card: ``python -m pytest tests/test_torch_port_cuda.py -q``.
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances as in ``chip_smoke.py``: argmins equal, Chamfer minima and
gradients atol 1e-6, BN statistics 1e-5 (+1e-5 relative, f32 sums in another
order), BN gradients 1e-6 relative; farthest-point sampling exact.
"""

import numpy as np
import pytest
import torch

from pointcloududa_torch.ops import bn_kernel, chamfer_kernel
from pointcloududa_torch.ops.losses import chamfer_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _clouds(dev, b, n, m, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(size=(b, k, 3)), dtype=torch.float32, device=dev) for k in (n, m))


@pytest.mark.parametrize("b,n,m", [(16, 300, 300), (3, 257, 40), (2, 2048, 1500), (1, 1, 5)])
def test_chamfer_kernels_match_plain(dev, b, n, m):
    x, y = _clouds(dev, b, n, m, seed=n)
    before = (chamfer_kernel.nn_directional.launches, chamfer_kernel.side_grad.launches)
    (m1, i1), (m2, i2) = chamfer_kernel.nn_directional(x, y), chamfer_kernel.nn_directional(y, x)
    (p1, j1), (p2, j2) = chamfer_kernel.nn_directional_plain(x, y), chamfer_kernel.nn_directional_plain(y, x)
    assert torch.equal(i1, j1) and torch.equal(i2, j2)
    torch.testing.assert_close(m1, p1, rtol=0, atol=1e-6)
    torch.testing.assert_close(m2, p2, rtol=0, atol=1e-6)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    loss = chamfer_kernel.chamfer_loss(xg, yg)
    loss.backward()
    torch.testing.assert_close(loss, chamfer_loss(x, y), rtol=1e-5, atol=0)
    g = torch.ones((), device=dev)
    torch.testing.assert_close(xg.grad, chamfer_kernel.side_grad_plain(x, y, j1, j2, g), rtol=0, atol=1e-6)
    torch.testing.assert_close(yg.grad, chamfer_kernel.side_grad_plain(y, x, j2, j1, g), rtol=0, atol=1e-6)
    assert chamfer_kernel.nn_directional.launches - before[0] == 4
    assert chamfer_kernel.side_grad.launches - before[1] == 2


def test_chamfer_backward_is_deterministic(dev):
    x, y = _clouds(dev, 4, 300, 300, seed=1)
    _, i1 = chamfer_kernel.nn_directional(x, y)
    _, i2 = chamfer_kernel.nn_directional(y, x)
    g = torch.ones((), device=dev)
    assert torch.equal(chamfer_kernel.side_grad(x, y, i1, i2, g), chamfer_kernel.side_grad(x, y, i1, i2, g))


def test_chamfer_wrappers_reject_what_the_kernel_does_not_take(dev):
    x, y = _clouds(dev, 2, 10, 10)
    with pytest.raises(ValueError):
        chamfer_kernel.nn_directional(x.double(), y.double())
    with pytest.raises(ValueError):
        chamfer_kernel.nn_directional(x.transpose(0, 1), y.transpose(0, 1))
    with pytest.raises(ValueError):
        chamfer_kernel.nn_directional(x[..., :2].contiguous(), y[..., :2].contiguous())


@pytest.mark.parametrize("shape", [(16, 32, 56, 56), (4, 24, 7, 9), (1000, 32), (8, 64, 28, 28), (8, 16, 20, 20)])
def test_bn_stats_kernels_match_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2
    c = shape[1]
    m, q = bn_kernel.stats_forward(x)
    pm, pq = bn_kernel.stats_forward_plain(x)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5)
    m2, q2 = bn_kernel.stats_forward(x)
    assert torch.equal(m, m2) and torch.equal(q, q2)
    gm = torch.randn(c, generator=gen, device=dev)
    gq = torch.randn(c, generator=gen, device=dev)
    dx = bn_kernel.stats_backward(x, gm, gq)
    torch.testing.assert_close(dx, bn_kernel.stats_backward_plain(x, gm, gq), rtol=1e-6, atol=1e-7)


def test_bn_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(4, 8, 6, 6, device=dev)
    with pytest.raises(ValueError):
        bn_kernel.stats_forward(x.transpose(2, 3))
    with pytest.raises(ValueError):
        bn_kernel.stats_forward(x.to(torch.bfloat16))


def test_generator_with_kernel_bn_matches_plain_bn(dev):
    from pointcloududa_torch.models import SegmentationPointModel

    torch.backends.cudnn.deterministic = True
    try:
        a = SegmentationPointModel(filters=8, pointnet=True, fc_inch=1, generator=torch.Generator().manual_seed(0))
        b = SegmentationPointModel(filters=8, pointnet=True, fc_inch=1, bn_kernel=True)
        b.load_state_dict(a.state_dict())
        a, b = a.to(dev), b.to(dev)
        x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        outs = []
        for model in (a, b):
            logits, _, pts = model(x)
            (logits.square().mean() + pts.mean()).backward()
            outs.append((logits.detach(), model.classifier.weight.grad))
        for u, w in zip(*outs):
            torch.testing.assert_close(u, w, rtol=1e-4, atol=1e-5)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("b,p,k,share", [(16, 3 * 64 * 64, 300, 0.3), (3, 5000, 64, 0.7), (1, 1, 4, 1.0), (2, 777, 50, 0.01)])
def test_fps_kernel_equals_plain(dev, b, p, k, share):
    """Exact: kernel and plain version sum the three squares in one order
    and break argmax ties at the lowest index. The last case has fewer valid
    candidates than ``k``; the grid case repeats coordinates, so ties abound."""
    from pointcloududa_torch.ops import fps_kernel

    rng = np.random.default_rng(p)
    if p % (64 * 64) == 0:  # integer grid shared by all clouds: batch stride 0
        from pointcloududa_torch.ops.pointcloud_device import grid_coords

        coords = grid_coords(64, 64, dev).expand(b, -1, -1)
    else:
        coords = torch.tensor(rng.normal(size=(b, p, 3)), dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.uniform(size=(b, p)) < share, device=dev)
    valid[:, 0] = True
    starts = torch.argmax(valid.to(torch.int32), dim=1).to(torch.int32)
    before = fps_kernel.fps.launches
    got = fps_kernel.fps(valid, coords, starts, k)
    torch.cuda.synchronize()
    assert fps_kernel.fps.launches == before + 1 and not got.requires_grad
    assert torch.equal(got, fps_kernel.fps_plain(valid, coords, starts, k))


def test_fps_kernel_stays_in_bounds_without_valid_points(dev):
    from pointcloududa_torch.ops import fps_kernel

    valid = torch.zeros((2, 100), dtype=torch.bool, device=dev)
    coords = torch.arange(600, dtype=torch.float32, device=dev).reshape(2, 100, 3)
    starts = torch.tensor([7, 99], dtype=torch.int32, device=dev)
    got = fps_kernel.fps(valid, coords, starts, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_kernel.fps_plain(valid, coords, starts, 5)) and bool(torch.isfinite(got).all())
    with pytest.raises(ValueError):
        fps_kernel.fps(valid, coords.double(), starts, 5)
