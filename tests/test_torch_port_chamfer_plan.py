"""The one-direction nearest-neighbour search's launch plan and the Chamfer
loss's two routes (``ops/chamfer_kernel.py``), on the CPU.

* ``nn_plan``, pure Python: at every shape ``chip_smoke.py`` phase (a) runs
  and at the edges (N = 1, M = 1, a ragged last pass, B = 65535), each
  query lies in one block's share and each partner in one rank's range, the
  plan's lanes and cluster are ones the kernel is built for, and a
  split never leaves a lane fewer than NN_MIN_PARTNERS partners.
* The kernel's walk (``csrc/chamfer.cu:nn_kernel``) transcribed: lane s of
  rank r walks partners s, s + L, ... of its range pass by pass with strict
  '<', the lanes settle (distance, index) by the xor-shuffle tree, the ranks
  are merged in order with strict '<'. On tie-heavy clouds (every point
  equal, duplicated clouds, integer grids) it must give ``torch.min``'s
  value and lowest-index argmin, in every plan. The kernel itself is held
  against the plain version on the card (``tests/test_torch_port_cuda.py``).
* The route chooser against ``chamfer_pallas._SMALL_LIMIT``, and the port's
  ``chamfer_loss`` at the boundary on both sides (n*m = 512^2: fused;
  512 x 513: two one-direction searches) against JAX's ``_chamfer_fwd_any``
  and ``jax.grad`` of ``chamfer_loss_pallas`` in interpret mode, each JAX
  function compiled once per module: loss rtol 1e-5 (f32 means in another
  order), argmins equal, gradients atol 1e-6 (the same unit vectors, summed
  in another order).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import chamfer_pallas
from pointcloududa_torch.ops import chamfer_kernel as ck
from pointcloududa_torch.ops.losses import batch_pairwise_dist
from pointcloududa_torch.utils import native
from test_torch_port_step import one_torch_thread  # noqa: F401

NN_TILE = 1024  # partners a block stages per pass (csrc/chamfer.cu: kNNTile)
H100_SMS = 132
# the shapes chip_smoke.py phase (a) holds nn_kernel at (its NN_SHAPES)
NN_SHAPES = [(2, 2048, 2048), (16, 2048, 2048), (1, 8192, 8192), (2, 600, 530), (16, 300, 300), (3, 257, 40), (1, 1, 5)]
EDGES = [(2, 1, 2048), (2, 2048, 1), (1, 1, 1), (3, 1025, 2100), (2, 5000, 40), (65535, 300, 300), (65535, 1, 1)]


def _ceil(u, v):
    return -(-u // v)


def _check_plan(plan, b, n, m, forced=False):
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and 1 <= plan.cluster <= native.MAX_CLUSTER
    # every query in one block: tiles x block_queries covers n, one tile fewer would not
    assert plan.block_queries == ck.NN_THREADS // plan.lanes * ck.NN_QUERIES
    assert plan.tiles * plan.block_queries >= n > (plan.tiles - 1) * plan.block_queries
    # every partner in one rank's range, in order
    ranges = plan.ranges(m)
    assert ranges[0][0] == 0 and ranges[-1][1] == m and all(u[1] == v[0] for u, v in zip(ranges, ranges[1:]))
    assert plan.chunk == _ceil(m, plan.cluster)
    assert 1 <= b <= 65535 and plan.tiles * plan.cluster < 2**31
    if not forced and (plan.lanes > 1 or plan.cluster > 1):  # a split keeps a lane's share
        assert _ceil(plan.chunk, plan.lanes) >= ck.NN_MIN_PARTNERS


@pytest.mark.parametrize("b,n,m", list(NN_SHAPES) + EDGES)
def test_plan_covers_every_query_and_partner(b, n, m):
    plan = ck.nn_plan(b, n, m, H100_SMS)
    _check_plan(plan, b, n, m)
    if b * plan.tiles * plan.cluster < H100_SMS:  # the card is not filled only where no split keeps NN_MIN_PARTNERS
        assert plan.lanes == 32 or _ceil(plan.chunk, 2 * plan.lanes) < ck.NN_MIN_PARTNERS
        assert plan.cluster == 8 or _ceil(_ceil(m, 2 * plan.cluster), plan.lanes) < ck.NN_MIN_PARTNERS


def test_plan_at_the_timed_shapes():
    """The plans chip_smoke.py times (PERF.md): a grid of at least one block
    an SM where the clouds allow it."""
    assert ck.nn_plan(2, 2048, 2048, H100_SMS) == ck.NNPlan(32, 2, 64, 1024)
    assert ck.nn_plan(16, 2048, 2048, H100_SMS) == ck.NNPlan(8, 1, 16, 2048)
    assert ck.nn_plan(1, 8192, 8192, H100_SMS) == ck.NNPlan(32, 1, 256, 8192)
    assert ck.nn_plan(16, 300, 300, H100_SMS) == ck.NNPlan(16, 1, 5, 300)


@pytest.mark.parametrize("lanes,cluster", list(itertools.product((1, 2, 4, 8, 16, 32), range(1, 9))))
def test_forced_plans(lanes, cluster):
    """Every plan chip_smoke.py forces on (2, 600, 530) keeps what was forced
    and covers every query and partner."""
    plan = ck.nn_plan(2, 600, 530, H100_SMS, lanes=lanes, cluster=cluster)
    assert (plan.lanes, plan.cluster) == (lanes, cluster)
    _check_plan(plan, 2, 600, 530, forced=True)


@pytest.mark.parametrize("name,value", [("kNNThreads", ck.NN_THREADS), ("kNNQueries", ck.NN_QUERIES),
                                        ("kNNTile", NN_TILE), ("kMaxCluster", native.MAX_CLUSTER)])
def test_plan_constants_are_the_kernels(name, value):
    """The plan's block shape is the one csrc/chamfer.cu builds."""
    src = (Path(ck.__file__).parents[1] / "csrc" / "chamfer.cu").read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


def _walk(p: torch.Tensor, plan) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's walk over the clamped (B, N, M) distances ``p``, as
    csrc/chamfer.cu:nn_kernel does it, every query at once."""
    b, n, m = p.shape
    lanes = plan.lanes
    inf = torch.full((b, n), float("inf"))
    per_rank = []
    for lo, hi in plan.ranges(m):
        best = [inf.clone() for _ in range(lanes)]
        best_j = [torch.zeros((b, n), dtype=torch.int64) for _ in range(lanes)]
        for t0 in range(lo, hi, NN_TILE):  # one pass of staged partners
            cnt = min(NN_TILE, hi - t0)
            for s in range(lanes):
                for k in range(s, cnt, lanes):  # increasing k, strict '<'
                    better = p[:, :, t0 + k] < best[s]
                    best[s] = torch.where(better, p[:, :, t0 + k], best[s])
                    best_j[s] = torch.where(better, torch.full_like(best_j[s], t0 + k), best_j[s])
        off = lanes >> 1
        while off:  # the xor-shuffle tree: every lane takes (distance, index) lexicographically
            other, other_j = [best[s ^ off] for s in range(lanes)], [best_j[s ^ off] for s in range(lanes)]
            for s in range(lanes):
                take = (other[s] < best[s]) | ((other[s] == best[s]) & (other_j[s] < best_j[s]))
                best[s] = torch.where(take, other[s], best[s])
                best_j[s] = torch.where(take, other_j[s], best_j[s])
            off >>= 1
        per_rank.append((best[0], best_j[0]))
    d, j = inf.clone(), torch.zeros((b, n), dtype=torch.int64)
    for od, oj in per_rank:  # rank order, strict '<'
        take = od < d
        d, j = torch.where(take, od, d), torch.where(take, oj, j)
    return d, j


def _write_coverage(plan, n):
    """Each query written once: query i of group g of tile t is t *
    block_queries + i * groups + g, and rank r writes the block's queries r *
    NN_THREADS + thread, + cluster * NN_THREADS, ..."""
    written = []
    for t in range(plan.tiles):
        slots = sorted(i * plan.groups + g for i in range(ck.NN_QUERIES) for g in range(plan.groups))
        assert slots == list(range(plan.block_queries))
        for r in range(plan.cluster):
            for th in range(ck.NN_THREADS):
                written += [t * plan.block_queries + lq for lq in range(r * ck.NN_THREADS + th, plan.block_queries,
                                                                         plan.cluster * ck.NN_THREADS)]
    written = [q for q in written if q < n]
    assert sorted(written) == list(range(n))


def _tie_clouds(kind):
    rng = np.random.default_rng(11)
    if kind == "all_equal":  # every distance equal: every argmin is 0
        return np.full((2, 37, 3), 0.25, np.float32), np.full((2, 70, 3), 0.5, np.float32)
    if kind == "duplicated":  # every partner twice: the first copy wins
        base = rng.uniform(size=(2, 45, 3)).astype(np.float32)
        return rng.uniform(size=(2, 33, 3)).astype(np.float32), np.concatenate([base, base], axis=1)
    if kind == "integer_grid":
        return (rng.integers(0, 3, size=(2, 50, 3)).astype(np.float32),
                rng.integers(0, 3, size=(2, 90, 3)).astype(np.float32))
    return rng.uniform(size=(1, 3, 3)).astype(np.float32), rng.uniform(size=(1, 2100, 3)).astype(np.float32)  # ragged


@pytest.mark.parametrize("kind", ["all_equal", "duplicated", "integer_grid", "ragged_passes"])
def test_walk_and_merge_give_the_lowest_index(kind):
    a, c = (torch.tensor(v) for v in _tie_clouds(kind))
    b, n, _ = a.shape
    m = c.shape[1]
    p = torch.clamp_min(batch_pairwise_dist(a, c), 0.0)
    want_d, want_j = torch.min(p, dim=2)
    plans = {ck.nn_plan(b, n, m, H100_SMS)}
    if kind == "ragged_passes":  # one rank's 2100 partners in passes of 1024, 1024, 52; and split ranges
        plans |= {ck.nn_plan(b, n, m, lanes=lanes, cluster=size) for lanes, size in ((1, 1), (8, 1), (32, 3))}
    else:
        plans |= {ck.nn_plan(b, n, m, lanes=lanes, cluster=size)
                  for lanes, size in itertools.product((1, 2, 8, 32), (1, 3, 8))}
    for plan in plans:
        _write_coverage(plan, n)
        d, j = _walk(p, plan)
        assert torch.equal(d, want_d), plan
        assert torch.equal(j, want_j), plan
    if kind == "all_equal":
        assert not want_j.any()
    if kind == "duplicated":
        assert bool((want_j < 45).all())


@pytest.mark.parametrize("n,m", [(512, 512), (512, 513), (513, 512), (1, 512 * 512), (1, 512 * 512 + 1), (300, 300),
                                 (2048, 2048), (600, 530)])
def test_route_matches_jax(n, m):
    assert ck.SMALL_LIMIT == chamfer_pallas._SMALL_LIMIT
    assert ck.fused_route(n, m) == (n * m <= chamfer_pallas._SMALL_LIMIT)


@pytest.fixture(scope="module")
def jax_boundary():
    """JAX's forward and gradient at n*m = 512^2 (fused kernel) and 512 x
    513 (tiled), each shape compiled once."""
    from jax.experimental.pallas import tpu as pltpu

    def both(x, y):
        return chamfer_pallas._chamfer_fwd_any(x, y), jax.grad(chamfer_pallas.chamfer_loss_pallas, argnums=(0, 1))(x, y)

    out = {}
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(both)
        for n, m in ((512, 512), (512, 513)):
            rng = np.random.default_rng(n + m)
            x, y = rng.uniform(size=(2, n, 3)).astype(np.float32), rng.uniform(size=(2, m, 3)).astype(np.float32)
            (loss, i1, i2), (dx, dy) = fn(jnp.asarray(x), jnp.asarray(y))
            out[(n, m)] = (x, y, float(loss), np.asarray(i1), np.asarray(i2), np.asarray(dx), np.asarray(dy))
    return out


@pytest.mark.parametrize("n,m,route", [(512, 512, "fused"), (512, 513, "large")])
def test_boundary_matches_jax(jax_boundary, monkeypatch, n, m, route):
    x, y, want_loss, want_i1, want_i2, want_dx, want_dy = jax_boundary[(n, m)]
    calls = {"fused": 0, "nn": 0}
    fused, nn = ck.forward_fused, ck.nn_directional

    def spy_fused(*args):
        calls["fused"] += 1
        return fused(*args)

    def spy_nn(*args):
        calls["nn"] += 1
        return nn(*args)

    monkeypatch.setattr(ck, "forward_fused", spy_fused)
    monkeypatch.setattr(ck, "nn_directional", spy_nn)
    xt, yt = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    loss, i1, i2 = ck.chamfer_forward(xt.detach(), yt.detach())
    assert calls == ({"fused": 1, "nn": 0} if route == "fused" else {"fused": 0, "nn": 2})
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    np.testing.assert_array_equal(i1.numpy(), want_i1)
    np.testing.assert_array_equal(i2.numpy(), want_i2)
    ck.chamfer_loss(xt, yt).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), want_dy, atol=1e-6)
