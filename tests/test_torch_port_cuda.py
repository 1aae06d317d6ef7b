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
    before = (chamfer_kernel.nn_directional.launches, chamfer_kernel.side_grad.launches, chamfer_kernel.forward_fused.launches)
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
    # the loss makes one fused forward launch, not two one-direction launches
    assert chamfer_kernel.nn_directional.launches - before[0] == 2
    assert chamfer_kernel.side_grad.launches - before[1] == 2
    assert chamfer_kernel.forward_fused.launches - before[2] == 1


@pytest.mark.parametrize("b,n,m", [(16, 300, 300), (2, 2048, 2048), (3, 300, 77), (2, 77, 1500), (1, 1, 5), (5, 3, 2)])
def test_chamfer_fused_forward_matches_plain(dev, b, n, m):
    """One launch gives both argmin lists (equal to the plain version's) and
    the per-item means (atol 1e-6: the same minima, summed in another order),
    and gives the same bits again."""
    x, y = _clouds(dev, b, n, m, seed=n + m)
    before = chamfer_kernel.forward_fused.launches
    parts, i1, i2 = chamfer_kernel.forward_fused(x, y)
    torch.cuda.synchronize()
    assert chamfer_kernel.forward_fused.launches == before + 1
    want_parts, j1, j2 = chamfer_kernel.forward_fused_plain(x, y)
    assert torch.equal(i1, j1) and torch.equal(i2, j2)
    torch.testing.assert_close(parts, want_parts, rtol=0, atol=1e-6)
    again = chamfer_kernel.forward_fused(x, y)
    assert all(torch.equal(u, v) for u, v in zip(again, (parts, i1, i2)))
    loss, _, _ = chamfer_kernel.chamfer_forward(x, y)
    torch.testing.assert_close(loss, chamfer_loss(x, y), rtol=1e-5, atol=0)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 6, 7, 8])
def test_chamfer_fused_forward_in_every_cluster_size(dev, cluster):
    """Whatever the blocks per item (and so the lanes per query: 1 to 32 over
    these sizes), the argmins are the plain version's on clouds full of exact
    ties, and a cluster the card cannot launch raises."""
    rng = np.random.default_rng(cluster)
    for b, n, m in ((3, 300, 300), (2, 700, 90), (4, 9, 5)):
        x = torch.tensor(np.round(rng.uniform(size=(b, n, 3)) * 8) / 8, dtype=torch.float32, device=dev)
        y = torch.tensor(np.round(rng.uniform(size=(b, m, 3)) * 8) / 8, dtype=torch.float32, device=dev)
        parts, i1, i2 = chamfer_kernel._launch_fused(x, y, cluster=cluster)
        want_parts, j1, j2 = chamfer_kernel.forward_fused_plain(x, y)
        assert torch.equal(i1, j1) and torch.equal(i2, j2)
        torch.testing.assert_close(parts, want_parts, rtol=0, atol=1e-6)
    before = chamfer_kernel.forward_fused.launches
    with pytest.raises(RuntimeError):
        chamfer_kernel._launch_fused(x, y, cluster=9)
    assert chamfer_kernel.forward_fused.launches == before
    assert torch.equal(chamfer_kernel.forward_fused(x, y)[1], j1)  # the error does not linger


def test_chamfer_fused_forward_breaks_ties_at_the_lowest_index(dev):
    base, _ = _clouds(dev, 2, 100, 1, seed=3)
    dup = torch.cat([base, base], dim=1).contiguous()
    _, i1, i2 = chamfer_kernel.forward_fused(dup, dup)
    want = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    assert torch.equal(i1, want) and torch.equal(i2, want)


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
    with pytest.raises(ValueError):
        chamfer_kernel.forward_fused(x.double(), y.double())
    with pytest.raises(ValueError):
        chamfer_kernel.forward_fused(x, y[:1])


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


def _fps_case(dev, kind):
    """(valid, coords, starts, k) of the cases the cluster design puts at risk."""
    from pointcloududa_torch.ops.pointcloud_device import grid_coords

    rng = np.random.default_rng(11)
    if kind == "ties_1024_and_8192_apart":
        # three far points at one distance from the rest and from each other,
        # at indices 5, 5 + 1024 (the next block's chunk) and 5 + 8 * 1024
        p = 10 * 1024
        coords = np.round(rng.uniform(-1, 1, size=(2, p, 3)) * 8) / 8
        coords[:, 0] = 0.0
        coords[:, 5], coords[:, 5 + 1024], coords[:, 5 + 8192] = (16, 0, 0), (0, 16, 0), (0, 0, 16)
        return (torch.ones((2, p), dtype=torch.bool, device=dev), torch.tensor(coords, dtype=torch.float32, device=dev),
                torch.zeros(2, dtype=torch.int32, device=dev), 6)
    if kind == "all_valid_beyond_shared_memory":  # 196,608 candidates a cloud: more than a cluster's shared memory
        coords = grid_coords(256, 256, dev).expand(16, -1, -1)
        starts = torch.tensor(rng.integers(0, 3 * 256 * 256, size=16), dtype=torch.int32, device=dev)
        return torch.ones((16, 3 * 256 * 256), dtype=torch.bool, device=dev), coords, starts, 60
    b, p = (40, 9000) if kind == "more_clouds_than_one_wave" else (3, 6000)
    coords = torch.tensor(rng.normal(size=(b, p, 3)), dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.uniform(size=(b, p)) < 0.4, device=dev)
    if kind == "invalid_start":
        starts = torch.argmin(valid.to(torch.int32), dim=1).to(torch.int32)
    else:
        starts = torch.argmax(valid.to(torch.int32), dim=1).to(torch.int32)
    return valid, coords, starts, 50


@pytest.mark.parametrize(
    "kind", ["ties_1024_and_8192_apart", "all_valid_beyond_shared_memory", "invalid_start", "more_clouds_than_one_wave"]
)
def test_fps_kernel_equals_plain_where_a_shared_cloud_is_at_risk(dev, kind):
    from pointcloududa_torch.ops import fps_kernel

    valid, coords, starts, k = _fps_case(dev, kind)
    before = fps_kernel.fps.launches
    got = fps_kernel.fps(valid, coords, starts, k)
    torch.cuda.synchronize()
    assert fps_kernel.fps.launches == before + 1
    assert torch.equal(got, fps_kernel.fps_plain(valid, coords, starts, k))
    geometry = fps_kernel.launch_geometry(valid.shape[0], valid.shape[1], dev)
    assert 1 <= geometry["cluster"] <= 8 and geometry["clusters_at_once"] >= min(valid.shape[0], 132)
    if kind == "all_valid_beyond_shared_memory":
        assert geometry["overflow"] > 0 and valid.shape[1] > geometry["cluster"] * geometry["capacity"]
    if kind == "ties_1024_and_8192_apart":
        assert torch.equal(got[:, 1:4], coords[:, [5, 5 + 1024, 5 + 8192]])


@pytest.mark.parametrize("kind", ["ties_1024_and_8192_apart", "invalid_start"])
def test_fps_kernel_beyond_a_forced_small_capacity(dev, kind):
    """One block-wide pass of shared memory only: most candidates take the
    branch through the global scratch row, and the result stays exact."""
    from pointcloududa_torch.ops import fps_kernel

    valid, coords, starts, k = _fps_case(dev, kind)
    geometry = fps_kernel.launch_geometry(valid.shape[0], 64 * 1024, dev, capacity=fps_kernel.CHUNK)
    assert geometry["overflow"] > 0
    wide = torch.zeros((valid.shape[0], 64 * 1024), dtype=torch.bool, device=dev)
    wide[:, : valid.shape[1]] = valid
    wide[:, valid.shape[1] :] = torch.rand((valid.shape[0], 64 * 1024 - valid.shape[1]), device=dev) < 0.9
    far = torch.cat([coords, torch.rand((valid.shape[0], 64 * 1024 - valid.shape[1], 3), device=dev) / 4], dim=1)
    got = fps_kernel._launch(wide, far, starts, k, capacity=fps_kernel.CHUNK)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_kernel.fps_plain(wide, far, starts, k))


def test_fps_refused_launch_raises_and_the_next_one_runs(dev):
    """More shared memory than a block may have: the launch is refused, the
    wrapper raises (no smaller retry), and the error does not linger."""
    from pointcloududa_torch.ops import fps_kernel

    valid, coords, starts, k = _fps_case(dev, "invalid_start")
    before = fps_kernel.fps.launches
    with pytest.raises(RuntimeError):
        fps_kernel._launch(valid, coords, starts, k, capacity=1 << 20)
    with pytest.raises(ValueError):
        fps_kernel._launch(valid, coords, starts, k, capacity=100)  # not a whole number of block-wide passes
    assert fps_kernel.fps.launches == before
    got = fps_kernel.fps(valid, coords, starts, k)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_kernel.fps_plain(valid, coords, starts, k))
