"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device every test skips (the kernels have no
CPU mode). On the card: ``python -m pytest tests/test_torch_port_cuda.py -q``.
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances as in ``chip_smoke.py``: argmins equal, the one-direction
search's minima bit-equal (its own tests; atol 1e-6 where the older test
checks them beside the loss), loss parts and gradients atol 1e-6 (the
backward also bit-equal on a repeat, whatever its
lane count), BN statistics 1e-5 (+1e-5 relative, f32 sums in another
order; a bfloat16 input too), BN gradients 1e-6 relative (float32) and
within 1 bfloat16 ulp (bfloat16); farthest-point sampling exact.
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
    assert chamfer_kernel.nn_directional.launches - before[0] == 2
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    before = (chamfer_kernel.nn_directional.launches, chamfer_kernel.side_grad.launches, chamfer_kernel.forward_fused.launches)
    loss = chamfer_kernel.chamfer_loss(xg, yg)
    loss.backward()
    torch.testing.assert_close(loss, chamfer_loss(x, y), rtol=1e-5, atol=0)
    g = torch.ones((), device=dev)
    torch.testing.assert_close(xg.grad, chamfer_kernel.side_grad_plain(x, y, j1, j2, g), rtol=0, atol=1e-6)
    torch.testing.assert_close(yg.grad, chamfer_kernel.side_grad_plain(y, x, j2, j1, g), rtol=0, atol=1e-6)
    # the loss takes the TPU package's route: one fused forward launch up to 512 x 512 pairs (2048 x 1500
    # is above: two one-direction launches and no fused one), and the backward kernel twice either way
    fused = n * m <= 512 * 512
    assert chamfer_kernel.nn_directional.launches - before[0] == (0 if fused else 2)
    assert chamfer_kernel.side_grad.launches - before[1] == 2
    assert chamfer_kernel.forward_fused.launches - before[2] == (1 if fused else 0)


# the shapes chip_smoke.py phase (a) holds nn_kernel at (its NN_SHAPES)
NN_SHAPES = [(2, 2048, 2048), (16, 2048, 2048), (1, 8192, 8192), (2, 600, 530), (16, 300, 300), (3, 257, 40), (1, 1, 5)]


def _grid_clouds(dev, b, n, m, seed):
    """Clouds snapped to a grid of 1/8: many distances tie exactly."""
    rng = np.random.default_rng(seed)
    return (torch.tensor(np.round(rng.uniform(size=(b, k, 3)) * 8) / 8, dtype=torch.float32, device=dev) for k in (n, m))


@pytest.mark.parametrize("grid", [False, True], ids=["uniform", "grid"])
@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_nn_kernel_matches_plain(dev, b, n, m, grid):
    """The one-direction search in its own plan: argmins equal, minima bit-equal
    (the plain version's arithmetic, product by product), and a repeat run
    gives the same bits."""
    x, y = (_grid_clouds if grid else _clouds)(dev, b, n, m, seed=n + m)
    before = chamfer_kernel.nn_directional.launches
    mins, idx = chamfer_kernel.nn_directional(x, y)
    assert chamfer_kernel.nn_directional.launches == before + 1
    want_mins, want_idx = chamfer_kernel.nn_directional_plain(x, y)
    assert torch.equal(idx, want_idx) and torch.equal(mins, want_mins)
    again = chamfer_kernel.nn_directional(x, y)
    assert torch.equal(again[0], mins) and torch.equal(again[1], idx)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_nn_kernel_in_every_plan(dev, lanes):
    """Every plan the kernel takes (clusters of 1 to 8 here) gives the plain
    version's bits on a tie-heavy cloud and the lowest index on duplicated
    points; a plan that does not cover the partners, or a cluster of 9, is
    refused and not counted."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, y = _grid_clouds(dev, 2, 600, 530, seed=lanes)
    want_mins, want_idx = chamfer_kernel.nn_directional_plain(x, y)
    base, _ = _clouds(dev, 2, 100, 1, seed=5)
    dup = torch.cat([base, base], dim=1).contiguous()
    want_dup = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    for cluster in range(1, 9):
        plan = chamfer_kernel.nn_plan(2, 600, 530, sms, lanes=lanes, cluster=cluster)
        mins, idx = chamfer_kernel._launch_nn(x, y, plan)
        assert torch.equal(idx, want_idx) and torch.equal(mins, want_mins)
        _, idx_dup = chamfer_kernel._launch_nn(dup, dup, chamfer_kernel.nn_plan(2, 200, 200, sms, lanes=lanes, cluster=cluster))
        assert torch.equal(idx_dup, want_dup)
    before = chamfer_kernel.nn_directional.launches
    # the last plan has clusters of 8 (chunk 67: 66 x 8 < 530) and tiles = ceil(600 / block_queries)
    for bad in (plan._replace(cluster=9), plan._replace(chunk=plan.chunk - 1), plan._replace(tiles=plan.tiles - 1)):
        with pytest.raises(RuntimeError):
            chamfer_kernel._launch_nn(x, y, bad)
    assert chamfer_kernel.nn_directional.launches == before
    assert torch.equal(chamfer_kernel.nn_directional(x, y)[1], want_idx)  # the error does not linger


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


@pytest.mark.parametrize("shape,offset", [((16, 32, 56, 56), 0), ((4, 24, 7, 9), 0), ((1000, 32), 0), ((8, 64, 28, 28), 0),
                                          ((8, 16, 20, 20), 0), ((8, 64, 28, 28), 1), ((16, 256, 28, 28), 0), ((3, 1, 45, 45), 0)],
                         ids=["vectors", "inner-63", "rows", "vectors-64", "small", "misaligned", "one-block", "one-channel"])
def test_bn_stats_kernels_match_plain(dev, shape, offset):
    """float32 x: the statistics at 1e-5 (f32 sums in another order), dx at
    1e-6 relative, both bit-equal on a repeat, one launch a wrapper call.
    ``inner`` divisible by 4 on an aligned tensor reads and writes 16-byte
    vectors; 63, 1, 2025 and a tensor that starts 4 bytes past an aligned
    address one value at a time. The plans take clusters of 8 (32 channels),
    4 (64) and 1 (256 channels: one block a channel)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = int(np.prod(shape))
    x = (torch.randn(n + offset, generator=gen, device=dev) * 0.7 + 0.2)[offset:].view(shape)
    c = shape[1]
    before = (bn_kernel.stats_forward.launches, bn_kernel.stats_backward.launches)
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
    assert torch.equal(dx, bn_kernel.stats_backward(x, gm, gq))
    assert (bn_kernel.stats_forward.launches - before[0], bn_kernel.stats_backward.launches - before[1]) == (2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_bn_stats_forward_in_every_cluster_size(dev, cluster, dtype):
    """Whatever the blocks a channel (the ranks' ranges ending inside a
    plane, on the vector and the scalar path, ranks with 2 groups each), the
    statistics are the plain version's at 1e-5 and the same bits on a
    repeat; a cluster of 16 is refused and raises."""
    gen = torch.Generator(device=dev).manual_seed(cluster)
    for shape in ((16, 32, 56, 56), (3, 5, 37, 41), (2, 7, 8, 8)):
        x = (torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2).to(dtype)
        outer, c, inner = bn_kernel._layout(x)
        plan = bn_kernel.forward_plan(outer, c, inner, dtype, bn_kernel._aligned(x), cluster=cluster)
        m, q = bn_kernel._launch_forward(x, plan)
        pm, pq = bn_kernel.stats_forward_plain(x)
        torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5)
        m2, q2 = bn_kernel._launch_forward(x, plan)
        assert torch.equal(m, m2) and torch.equal(q, q2)
    before = bn_kernel.stats_forward.launches
    with pytest.raises(RuntimeError):
        bn_kernel._launch_forward(x, bn_kernel.forward_plan(outer, c, inner, dtype, True, cluster=16))
    assert bn_kernel.stats_forward.launches == before
    assert torch.equal(bn_kernel._launch_forward(x, plan)[0], m)  # the error does not linger


def test_bn_forward_plans_fit_one_wave(dev):
    """At every BatchNorm shape of both paths the card runs all C clusters of
    the plan's size at once (the occupancy calculator on the forward kernel
    itself, with its block size and shared memory)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for size in (224, 256):
        for k in range(4):
            outer, c, inner = 16, 32 << k, (size >> k) ** 2
            for dtype in (torch.float32, torch.bfloat16):
                plan = bn_kernel.forward_plan(outer, c, inner, dtype, True, sms=sms)
                assert plan.cluster == 8 >> k
                assert bn_kernel.forward_clusters(dtype, plan.vec, plan.cluster, dev) >= c


def _bf16_ulps(got, want):
    """|got - want| in units of the last place of bfloat16 at ``want``."""
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0**-126))) - 7)
    return (got.float() - want.float()).abs() / ulp


@pytest.mark.parametrize("shape,offset", [((16, 32, 56, 56), 0), ((4, 24, 7, 9), 0), ((1000, 32), 0), ((8, 64, 28, 28), 1),
                                          ((2, 16, 8, 8), 0), ((16, 256, 28, 28), 0), ((3, 1, 45, 45), 0)],
                         ids=["vectors", "inner-63", "rows", "misaligned", "small", "one-block", "one-channel"])
def test_bn_stats_bf16_kernels_match_plain(dev, shape, offset):
    """bfloat16 x, widened in registers: the statistics at the float32
    tolerance, dx within 1 bfloat16 ulp of the plain version's (both compute
    it in float32 and round once), both bit-equal on a repeat. ``inner``
    divisible by 8 on an aligned tensor reads 16-byte vectors; 63, 1 and a
    tensor that starts 2 bytes past an aligned address read one value at a
    time."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n = int(np.prod(shape))
    x = (torch.randn(n + offset, generator=gen, device=dev) * 0.7 + 0.2).to(torch.bfloat16)[offset:].view(shape)
    c = shape[1]
    before = (bn_kernel.stats_forward.bf16_launches, bn_kernel.stats_backward.bf16_launches)
    m, q = bn_kernel.stats_forward(x)
    pm, pq = bn_kernel.stats_forward_plain(x)
    assert m.dtype == q.dtype == torch.float32
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5)
    m2, q2 = bn_kernel.stats_forward(x)
    assert torch.equal(m, m2) and torch.equal(q, q2)
    gm = torch.randn(c, generator=gen, device=dev)
    gq = torch.randn(c, generator=gen, device=dev)
    dx = bn_kernel.stats_backward(x, gm, gq)
    want = bn_kernel.stats_backward_plain(x, gm, gq)
    assert dx.dtype == torch.bfloat16 and float(_bf16_ulps(dx, want).max()) <= 1.0
    assert torch.equal(dx, bn_kernel.stats_backward(x, gm, gq))
    assert (bn_kernel.stats_forward.bf16_launches - before[0], bn_kernel.stats_backward.bf16_launches - before[1]) == (2, 2)


def test_bn_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(4, 8, 6, 6, device=dev)
    with pytest.raises(ValueError):
        bn_kernel.stats_forward(x.transpose(2, 3))
    with pytest.raises(ValueError):
        bn_kernel.stats_forward(x.to(torch.float16))
    with pytest.raises(ValueError):
        bn_kernel.stats_backward(x.to(torch.float16), torch.zeros(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        bn_kernel.stats_forward(x.double())


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_statistics_and_dx_over_two_gloo_ranks_on_one_card(dev, dtype):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device) and each runs the kernel-route BatchNorm on its 8 rows of a
    global batch of 16 at the generator's first shape, through the kernels:
    the statistics of the global batch (rtol 1e-5, atol 1e-5), and the rows
    of the output and of dx (each rank's dx divided by the world size: see
    ``tests/torch_port_ranks.py:bn_case``) equal to one process's within
    1e-5 relative (float32) or one bfloat16 ulp (bfloat16), plus 1e-6 of
    the largest; one forward launch for the statistics, one in the forward
    and one backward launch on every rank."""
    import torch_port_ranks as ranks
    from pointcloududa_torch.parallel import launch

    shape = (16, 32, 56, 56)
    want = ranks.bn_case(None, "cuda:0", dtype, shape)
    got = launch.spawn(ranks.bn_case, ["cuda:0"] * 2, ("cuda:0", dtype, shape), backend="gloo")
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for rank, g in enumerate(got):
        assert g["launches"] == want["launches"] == (2, 1)
        for k in ("mean", "var", "running_var"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("y", "dx"):
            w = want[k][8 * rank:8 * rank + 8]
            assert (np.abs(g[k] - w) <= rel * np.abs(w) + 1e-6 * np.abs(w).max()).all(), k


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


def _backward_case(dev, kind):
    """(a, c) clouds for the cases the several-lanes backward puts at risk."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "duplicated":  # points 0..99 are each chosen by two partners, points 100..199 by none
        base = torch.tensor(rng.uniform(size=(2, 100, 3)), dtype=torch.float32, device=dev)
        dup = torch.cat([base, base], dim=1).contiguous()
        return dup, dup.clone()
    if kind == "one_point_chosen_by_all":  # a's point 0 among c's points, the rest of a far away: 77 hits on one point
        a = torch.tensor(rng.uniform(size=(2, 300, 3)), dtype=torch.float32, device=dev) + 10.0
        a[:, 0] = 0.5
        return a, torch.tensor(rng.uniform(size=(2, 77, 3)), dtype=torch.float32, device=dev)
    b, n, m = {"path": (16, 300, 300), "long": (2, 2048, 2048), "n_above_m": (3, 300, 77), "n_below_m": (3, 77, 300),
               "beyond_one_wave": (40, 300, 300), "n_below_a_warps_share": (1, 1, 5), "tiles": (2, 700, 1100)}[kind]
    return tuple(_clouds(dev, b, n, m, seed=n + m))


@pytest.mark.parametrize("kind", ["path", "long", "n_above_m", "n_below_m", "beyond_one_wave", "n_below_a_warps_share", "tiles",
                                  "duplicated", "one_point_chosen_by_all"])
def test_chamfer_backward_matches_plain(dev, kind):
    """Both clouds' gradients against ``side_grad_plain`` at atol 1e-6 (the
    same unit vectors, summed by strided lanes and a tree instead of in index
    order), and the same bits on a repeat."""
    a, c = _backward_case(dev, kind)
    _, i_ac, i_ca = chamfer_kernel.forward_fused(a, c)
    g = torch.full((), 0.7, device=dev)
    before = chamfer_kernel.side_grad.launches
    for x, y, ixy, iyx in ((a, c, i_ac, i_ca), (c, a, i_ca, i_ac)):
        got = chamfer_kernel.side_grad(x, y, ixy, iyx, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, chamfer_kernel.side_grad_plain(x, y, ixy, iyx, g), rtol=0, atol=1e-6)
        assert torch.equal(got, chamfer_kernel.side_grad(x, y, ixy, iyx, g))
    assert chamfer_kernel.side_grad.launches == before + 4
    if kind == "one_point_chosen_by_all":
        assert not bool(i_ca.any())


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_chamfer_backward_with_every_lane_count(dev, lanes):
    for kind in ("path", "n_above_m", "n_below_a_warps_share", "one_point_chosen_by_all"):
        a, c = _backward_case(dev, kind)
        _, i_ac, i_ca = chamfer_kernel.forward_fused(a, c)
        g = torch.ones((), device=dev)
        got = chamfer_kernel._launch_side_grad(a, c, i_ac, i_ca, g, lanes=lanes)
        torch.testing.assert_close(got, chamfer_kernel.side_grad_plain(a, c, i_ac, i_ca, g), rtol=0, atol=1e-6)
        assert torch.equal(got, chamfer_kernel._launch_side_grad(a, c, i_ac, i_ca, g, lanes=lanes))
    assert chamfer_kernel.backward_lanes(16, 300, dev) in (8, 16, 32)


def test_chamfer_backward_refused_launch_raises_and_the_next_one_runs(dev):
    """A lane count that is not a power of two up to 32 is refused by the
    entry point: the wrapper raises, counts nothing, and the error does not
    linger; index lists of the wrong type or shape never reach the kernel."""
    a, c = _backward_case(dev, "n_above_m")
    _, i_ac, i_ca = chamfer_kernel.forward_fused(a, c)
    g = torch.ones((), device=dev)
    before = chamfer_kernel.side_grad.launches
    for lanes in (3, 64, 0):
        with pytest.raises(RuntimeError):
            chamfer_kernel._launch_side_grad(a, c, i_ac, i_ca, g, lanes=lanes)
    with pytest.raises(ValueError):
        chamfer_kernel.side_grad(a, c, i_ac.long(), i_ca, g)
    with pytest.raises(ValueError):
        chamfer_kernel.side_grad(a, c, i_ca, i_ac, g)
    assert chamfer_kernel.side_grad.launches == before
    got = chamfer_kernel.side_grad(a, c, i_ac, i_ca, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, chamfer_kernel.side_grad_plain(a, c, i_ac, i_ca, g), rtol=0, atol=1e-6)


def test_trainer_epoch_on_the_card_with_a_prefetcher(dev, tmp_path):
    """Two steps of ``UDATrainer.train_epoch`` on the card (light augmentation,
    D2 + D4, every kernel on): the raw batches are copied by the prefetcher's
    thread on its own stream, the metrics are finite, and every kernel of the
    path was launched."""
    from pointcloududa_torch.config import mmwhs_default
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks
    from pointcloududa_torch.ops import fps_kernel
    from pointcloududa_torch.train.loop import UDATrainer

    cfg = mmwhs_default(softmax=True, d2=True, d4=True, aug="light", filters=8, crop_size=96, fc_inch=1, bs=4, vert_t_every=2,
                        chamfer_impl="pallas", bn_stats_impl="pallas")
    placed_in = []

    class Batches:
        steps_per_epoch = 2

        def epoch(self):
            rng = np.random.default_rng(0)
            for s in range(2):
                yield {"img_s": rng.normal(size=(4, 96, 96, 3)).astype(np.float32), "mask_s": synthetic_blob_masks(4, 96, seed=s),
                       "img_t": rng.normal(size=(4, 96, 96, 3)).astype(np.float32), "mask_t": synthetic_blob_masks(4, 96, seed=9 + s)}

    trainer = UDATrainer(cfg, Batches(), {}, workdir=str(tmp_path / "w"), logdir=str(tmp_path / "r"))
    assert trainer.device.type == "cuda"
    place = trainer.place
    trainer.place = lambda b: placed_in.append(torch.cuda.current_stream().cuda_stream) or place(b)
    counts = lambda: (chamfer_kernel.forward_fused.launches, chamfer_kernel.side_grad.launches,  # noqa: E731
                      bn_kernel.stats_forward.launches, bn_kernel.stats_backward.launches, fps_kernel.fps.launches)
    before = counts()
    metrics = trainer.train_epoch()
    torch.cuda.synchronize()
    trainer.writer.close()
    assert len(metrics) == 14 and all(np.isfinite(v) for v in metrics.values()), metrics
    assert [b - a for a, b in zip(before, counts())] == [3, 2, 64, 64, 3]
    main_stream = torch.cuda.current_stream().cuda_stream
    assert len(placed_in) == 2 and all(s != main_stream for s in placed_in)  # copied on the prefetcher's own stream


# the benchmark's two paper configurations (perfbench/configs/), the kernels selected
PAPER = {
    "mscmrseg": dict(d1=True, d2=True, d4=True, lr=1e-3, d1lr=2.5e-5, d2lr=2.5e-5, d4lr=2.5e-5, dr=0.01),
    "mmwhs": dict(d1=True, d2=True, d4=True, ft=True, extd4=True, softmax=True, d1_on_probs=True, entropy_norm=True,
                  lr=2e-4, d1lr=1e-4, d2lr=5e-5, d4lr=1e-4, dr=1.0),
}


@pytest.fixture
def deterministic(dev):
    """cuDNN's deterministic algorithms: two runs of one program from one
    seed part ways within an epoch without them."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield dev
    torch.backends.cudnn.deterministic = before


def _paper_cfg(name, **kw):
    from pointcloududa_torch.cli.common import with_kernels
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default

    make = mscmrseg_default if name == "mscmrseg" else mmwhs_default
    return with_kernels(make(**{**PAPER[name], "compute_dtype": "bfloat16", **kw}))


def _graph_run(cfg, batches, graphed):
    """Steps from one seed on the card, the blocks named in ``graphed``
    (``"gen"``: phases 1-2, ``"disc"``: phases 3-5) replayed from their
    graphs and the others run eagerly; the state, each step's metrics and the
    span totals."""
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils import timer

    st = create_train_state(cfg, seed=5)
    step = make_train_step(cfg, st.models, st.optimizers)
    step.gen_graphs.on_card = "gen" in graphed
    step.disc_graphs.on_card = "disc" in graphed
    timer.reset_spans()
    metrics = []
    for b in batches:
        st, m = step(st, b)
        metrics.append(m)
    torch.cuda.synchronize()
    return st, metrics, timer.span_totals()


def _largest_differences(a, b):
    """{what: largest absolute difference} of two runs' states and metrics
    where they are not bit-equal: every network's parameters and buffers,
    every optimiser's state, the dropout generator, each step's metrics."""
    (sa, ma), (sb, mb) = a, b
    out = {}

    def cmp(name, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if not torch.equal(x, y):
            out[name] = float((x.double() - y.double()).abs().max()) if x.is_floating_point() else "differs"

    for i, (na, nb) in enumerate(zip(sa.models, sb.models)):
        if na is not None:
            for (k, va), (_, vb) in zip(na.state_dict().items(), nb.state_dict().items()):
                cmp(f"net{i}.{k}", va, vb)
    for i, (oa, ob) in enumerate(zip(sa.optimizers, sb.optimizers)):
        if oa is not None:
            for j, (pa, pb) in enumerate(zip(oa.state.values(), ob.state.values())):
                for k in pa:
                    cmp(f"opt{i}.{j}.{k}", pa[k], pb[k])
    cmp("dropout generator", sa.generator.get_state(), sb.generator.get_state())
    for i, (x, y) in enumerate(zip(ma, mb)):
        assert list(x) == list(y)
        for k in x:
            cmp(f"step{i}.{k}", x[k], y[k])
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PAPER))
def test_graphed_discriminator_phases_equal_eager_ones(deterministic, name, dtype):
    """Six steps of a paper configuration at bs 4 (in the CLIs' bfloat16 and
    in float32) with phases 3-5 from one CUDA graph (the first eager, the
    second captures, then replays) against six eager steps from the same
    weights, batches and generator seed: parameters, momentum buffers, D4's
    running statistics, each step's metrics and the dropout generator's state
    bit-equal."""
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.utils import timer

    cfg = _paper_cfg(name, bs=4, compute_dtype=dtype)
    batches = [synthetic_batch(cfg, 4, seed=s) for s in range(6)]
    eager = _graph_run(cfg, batches, graphed=())
    graphed = _graph_run(cfg, batches, graphed=("disc",))
    assert graphed[2][timer.DISC_CAPTURE][1] == 1 and graphed[2][timer.DISC_REPLAY][1] == 5
    assert timer.DISC_REPLAY not in eager[2]
    assert _largest_differences(eager[:2], graphed[:2]) == {}


def test_a_padded_tail_runs_eagerly_between_replays(deterministic):
    """Full, full, a tail with a ``sample_mask``, full: the tail runs eagerly
    (its key seen once), the last step replays the graph captured at the
    second, and the run equals the eager one bit for bit."""
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.utils import timer

    cfg = _paper_cfg("mscmrseg", bs=4)
    batches = [synthetic_batch(cfg, 4, seed=s) for s in range(4)]
    batches[2]["sample_mask"] = np.array([1, 1, 0, 0], np.float32)
    eager = _graph_run(cfg, batches, graphed=())
    graphed = _graph_run(cfg, batches, graphed=("gen", "disc"))
    assert graphed[2][timer.DISC_CAPTURE][1] == 1 and graphed[2][timer.DISC_REPLAY][1] == 2
    assert graphed[2][timer.GEN_CAPTURE][1] == 1 and graphed[2][timer.GEN_REPLAY][1] == 2
    assert graphed[2]["uda.step.d4.forward"][1] == 3  # the first step, the capture's pass and the tail; no replay
    assert _largest_differences(eager[:2], graphed[:2]) == {}


def test_a_restore_mid_run_recaptures_and_matches_the_uninterrupted_run(deterministic, tmp_path):
    """``save_full`` after one epoch, another epoch, then ``restore_full``
    back to the snapshot (new momentum buffers: the graph is captured again)
    and the epoch again: the state equals that of two epochs straight."""
    from pointcloududa_torch.config import mmwhs_default
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks
    from pointcloududa_torch.train.loop import UDATrainer
    from pointcloududa_torch.utils import timer

    cfg = mmwhs_default(**{**PAPER["mmwhs"], "aug": "light", "filters": 8, "crop_size": 96, "fc_inch": 1, "bs": 4,
                           "chamfer_impl": "pallas", "bn_stats_impl": "pallas", "compute_dtype": "bfloat16"})

    class Batches:
        steps_per_epoch = 3

        def epoch(self):
            rng = np.random.default_rng(0)
            for s in range(3):
                yield {"img_s": rng.normal(size=(4, 96, 96, 3)).astype(np.float32), "mask_s": synthetic_blob_masks(4, 96, seed=s),
                       "img_t": rng.normal(size=(4, 96, 96, 3)).astype(np.float32), "mask_t": synthetic_blob_masks(4, 96, seed=9 + s)}

    def trainer(d):
        return UDATrainer(cfg, Batches(), {}, workdir=str(tmp_path / d / "w"), logdir=str(tmp_path / d / "r"))

    straight = trainer("a")
    straight.train_epoch()
    straight.train_epoch()
    assert timer.span_totals()[timer.DISC_REPLAY][1] == 3 and timer.DISC_CAPTURE not in timer.span_totals()
    resumed = trainer("b")
    resumed.train_epoch()
    resumed.save_full(str(tmp_path / "snap"), 1)
    resumed.train_epoch()
    resumed.restore_full(str(tmp_path / "snap"))
    resumed.train_epoch()
    assert timer.span_totals()[timer.DISC_CAPTURE][1] == 1 and timer.span_totals()[timer.DISC_REPLAY][1] == 3
    torch.cuda.synchronize()
    for t in (straight, resumed):
        t.writer.close()
    assert _largest_differences((straight.state, []), (resumed.state, [])) == {}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PAPER))
def test_graphed_generator_phases_equal_eager_ones(deterministic, name, dtype):
    """Six steps of a paper configuration at bs 4 (in the CLIs' bfloat16 and
    in float32) with phases 1-2 from one CUDA graph (the first eager, the
    second captures, then replays; the generator's Adam update eager after
    each replay) against six eager steps from the same weights, batches and
    generator seed: parameters, Adam's moments, the U-Net's and D4's running
    statistics, each step's metrics and the dropout generator's state
    bit-equal; then with phases 3-5 graphed too, as the step runs on the
    card."""
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.utils import timer

    cfg = _paper_cfg(name, bs=4, compute_dtype=dtype)
    batches = [synthetic_batch(cfg, 4, seed=s) for s in range(6)]
    eager = _graph_run(cfg, batches, graphed=())
    for graphed in (("gen",), ("gen", "disc")):
        got = _graph_run(cfg, batches, graphed=graphed)
        assert got[2][timer.GEN_CAPTURE][1] == 1 and got[2][timer.GEN_REPLAY][1] == 5
        assert _largest_differences(eager[:2], got[:2]) == {}, graphed
    assert timer.GEN_REPLAY not in eager[2]
    assert got[2]["uda.step.gen_backward"][1] == 2  # the first step and the capture's pass; no replay


def test_the_cadence_keeps_two_generator_graphs_and_a_tail_runs_eagerly(deterministic):
    """``vert_t`` every other step and a padded tail among them: phases 1-2
    capture each cadence key once (steps 2 and 3) and replay it after; the
    tail (its key seen once) runs eagerly between replays; bit-equal to the
    eager run, both blocks graphed."""
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.utils import timer

    cfg = _paper_cfg("mscmrseg", bs=4)
    batches = [synthetic_batch(cfg, 4, seed=s) for s in range(7)]
    for s in (1, 3, 5):
        del batches[s]["vert_t"]
    batches[4]["sample_mask"] = np.array([1, 1, 0, 0], np.float32)
    eager = _graph_run(cfg, batches, graphed=())
    graphed = _graph_run(cfg, batches, graphed=("gen", "disc"))
    assert graphed[2][timer.GEN_CAPTURE][1] == 2 and graphed[2][timer.GEN_REPLAY][1] == 4  # steps 2, 3, 5, 6
    assert graphed[2][timer.DISC_CAPTURE][1] == 1 and graphed[2][timer.DISC_REPLAY][1] == 5
    assert _largest_differences(eager[:2], graphed[:2]) == {}


def _raw_batches(cfg, n):
    """``n`` raw host batches at the configuration's size: MS-CMRSeg's uint8
    slices and stored clouds, MM-WHS's float slices with anatomy-like masks
    (the clouds are regenerated from them)."""
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks, synthetic_raw_batch

    out = []
    for s in range(n):
        raw = synthetic_raw_batch(cfg, cfg.bs, seed=s)
        if cfg.workload == "mmwhs":
            raw["mask_s"] = synthetic_blob_masks(cfg.bs, cfg.crop_size, seed=s)
            raw["mask_t"] = synthetic_blob_masks(cfg.bs, cfg.crop_size, seed=9 + s)
        out.append(raw)
    return out


@pytest.mark.parametrize("name,aug", [("mscmrseg", "heavy"), ("mscmrseg", "aug2"), ("mmwhs", "light")])
def test_the_side_stream_preprocess_hands_the_step_the_main_streams_batches(deterministic, tmp_path, name, aug):
    """Three steps of ``UDATrainer.train_epoch`` (every kernel on; phases 1-2
    and 3-5 eager, captured, replayed) with the preprocess on the trainer's
    side stream, against the same epoch with the preprocess forced onto the
    main stream: the batches ``pre_train`` hands the step bit for bit, the
    epoch's metrics and the state after it bit-equal; the preprocess ran on
    the side stream, the step on the main one."""
    from pointcloududa_torch.cli.common import with_kernels
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
    from pointcloududa_torch.train.loop import UDATrainer

    make = mscmrseg_default if name == "mscmrseg" else mmwhs_default
    cfg = with_kernels(make(**{**PAPER[name], "aug": aug, "filters": 8, "crop_size": 96, "fc_inch": 1, "bs": 4,
                               "compute_dtype": "float32"}))
    raws = _raw_batches(cfg, 3)

    class Batches:
        steps_per_epoch = 3

        def epoch(self):
            return iter(raws)

    def run(d, force_main):
        trainer = UDATrainer(cfg, Batches(), {}, workdir=str(tmp_path / d / "w"), logdir=str(tmp_path / d / "r"))
        main = torch.cuda.current_stream(dev).cuda_stream
        if force_main:
            trainer._pre_stream = torch.cuda.current_stream(dev)
        handed, streams = [], []
        pre, step = trainer.pre_train, trainer.train_step

        def recorded_pre(*args, **kwargs):
            batch = pre(*args, **kwargs)
            streams.append(torch.cuda.current_stream(dev).cuda_stream)
            handed.append({k: v.clone() for k, v in batch.items()})  # on the preprocess's stream, after its work
            return batch

        def recorded_step(state, batch):
            assert torch.cuda.current_stream(dev).cuda_stream == main
            return step(state, batch)

        trainer.pre_train, trainer.train_step = recorded_pre, recorded_step
        metrics = trainer.train_epoch()
        torch.cuda.synchronize()
        trainer.writer.close()
        return trainer, handed, streams, metrics, main

    dev = deterministic
    side, on_main = run("side", False), run("main", True)
    assert all(s == side[0]._pre_stream.cuda_stream != side[4] for s in side[2]) and len(side[2]) == 3
    assert all(s == on_main[4] for s in on_main[2])
    for a, b in zip(side[1], on_main[1]):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert side[3] == on_main[3] and all(np.isfinite(v) for v in side[3].values())
    assert _largest_differences((side[0].state, []), (on_main[0].state, [])) == {}


def test_garbage_that_holds_a_graph_is_freed_before_a_capture(deterministic):
    """A dropped step whose graphs sit in a reference cycle (as a dropped
    trainer's do: its ``place`` lambda refers to it) is freed before a capture
    begins, not during it, where freeing a graph invalidates the capture (and
    leaves the dropout generator unusable): with such garbage made just before
    each capture and the collector run inside it, the step still captures both
    blocks, replays them, and equals the eager run."""
    import gc

    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.train import step_graph
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils import timer

    cfg = _paper_cfg("mscmrseg", bs=2, compute_dtype="float32")
    batches = [synthetic_batch(cfg, 2, seed=s) for s in range(4)]

    def garbage():
        st = create_train_state(cfg, seed=1)
        step = make_train_step(cfg, st.models, st.optimizers)
        for b in batches[:2]:  # the second step captures both blocks
            st, _ = step(st, b)
        cycle = [step, st]
        cycle.append(cycle)

    class Collecting(step_graph.CudaGraph):
        def __init__(self, body, generator, pool=None):
            garbage()

            def collecting():
                gc.collect()  # inside the capture: frees whatever cyclic garbage the capture began with
                return body()

            super().__init__(collecting, generator, pool)

    eager = _graph_run(cfg, batches, graphed=())
    st = create_train_state(cfg, seed=5)
    step = make_train_step(cfg, st.models, st.optimizers)
    step.gen_graphs.make_graph = step.disc_graphs.make_graph = Collecting
    timer.reset_spans()
    metrics = []
    for b in batches:
        st, m = step(st, b)
        metrics.append(m)
    torch.cuda.synchronize()
    totals = timer.span_totals()
    # each block: this step's capture and 3 replays, and each of the two garbage steps' capture and replay
    assert totals[timer.GEN_CAPTURE][1] == 3 and totals[timer.GEN_REPLAY][1] == 5
    assert totals[timer.DISC_CAPTURE][1] == 3 and totals[timer.DISC_REPLAY][1] == 5
    assert _largest_differences(eager[:2], (st, metrics)) == {}
