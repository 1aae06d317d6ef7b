"""The port's farthest-point sampling and device point-cloud maker against
the JAX package's, on the CPU.

``fps_plain`` (the plain PyTorch version the FPS kernel is held against on
the card) must equal both JAX routes **exactly**: ``fps_pallas`` in interpret
mode, as ``tests/test_pointcloud_device.py`` runs it, and the XLA loop
(``impl="xla"``). Coordinates are integers on the pixel grid, so every
squared distance is an integer that f32 holds exactly and no rounding can
separate the packages; what can is the argmax tie rule (lowest index), which
ties on this grid test constantly.

The random start cannot be shared through a seed (``jax.random`` and
``torch.Generator`` draw different numbers), so the tests transcribe the JAX
draw (``pointcloud_device.py:125,131-135``: per-item keys, ``uniform + 2 *
candidate``, ``argmax``) and feed the resulting ``starts`` to the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import pointcloud_device as jpc
from pointcloududa_tpu.ops.fps_pallas import fps_pallas
from pointcloududa_torch.ops import fps_kernel
from pointcloududa_torch.ops import pointcloud_device as tpc
from test_torch_port_step import one_torch_thread  # noqa: F401


def _masks(kind):
    m = np.zeros((2, 64, 64), np.uint8)
    if kind == "rectangles":  # the masks of tests/test_pointcloud_device.py
        m[0, 20:44, 20:44] = 1
        m[1, 5:30, 10:50] = 1
    elif kind == "few_candidates":  # 55 and 60 foreground pixels: fewer than k=200 candidates
        m[0, 3:8, 3:14] = 1
        m[1, 40:46, 20:30] = 2
    elif kind == "labels":  # several labels, holes: every label > 0 is foreground
        rng = np.random.default_rng(0)
        m = (rng.integers(0, 5, size=(2, 64, 64)) * (rng.uniform(size=(2, 64, 64)) < 0.3)).astype(np.uint8)
    elif kind == "empty_and_small":  # zero cloud: no pixel, and exactly 50 pixels
        m[1, 0, :50] = 1
    return m


def _jax_starts(masks, key):
    """The start indices ``masks_to_point_clouds`` draws from ``key``
    (transcribed from ``pointcloud_device.py:119-135``)."""
    fg = jnp.asarray(masks) > 0
    b = fg.shape[0]

    def candidates(mask):
        flat = mask.reshape(-1)
        ring = (mask & ~jpc._interior4(mask)).reshape(-1)
        return jnp.concatenate([flat, ring, flat])

    cand = jax.vmap(candidates)(fg)
    keys = jax.random.split(key, b)
    score = jax.vmap(lambda k, c: jax.random.uniform(k, c.shape) + c * 2.0)(keys, cand.astype(jnp.float32))
    return np.asarray(cand), np.asarray(jnp.argmax(score, axis=1).astype(jnp.int32))


@pytest.mark.parametrize("kind,k", [("rectangles", 50), ("few_candidates", 200), ("labels", 50), ("empty_and_small", 20)])
def test_clouds_from_starts_equal_both_jax_routes(kind, k):
    from jax.experimental.pallas import tpu as pltpu

    masks = _masks(kind)
    key = jax.random.PRNGKey(3)
    want_xla = np.asarray(jpc.masks_to_point_clouds(masks, key, number_points=k, impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(jpc.masks_to_point_clouds(masks, key, number_points=k, impl="pallas"))
    cand, starts = _jax_starts(masks, key)
    np.testing.assert_array_equal(tpc.candidates(torch.tensor(masks) > 0).numpy(), cand)
    got = tpc.masks_to_point_clouds_from_starts(torch.tensor(masks), torch.tensor(starts), number_points=k).numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    if kind == "empty_and_small":
        assert not got.any()
    else:
        assert got.any(axis=(1, 2)).all()


def test_fps_plain_equals_fps_pallas_on_a_first_round_tie():
    """A 9 x 9 square ring started at its centre row's left end: the far
    corners tie on the first round, and later rounds tie by symmetry. The
    lowest index must win each time, as ``jnp.argmax`` decides."""
    from jax.experimental.pallas import tpu as pltpu

    h = w = 16  # P = 3 * 256, a multiple of the TPU kernel's 128 lanes
    mask = np.zeros((1, h, w), bool)
    mask[0, 3:12, 3:12] = True
    cand = tpc.candidates(torch.tensor(mask))
    coords = tpc.grid_coords(h, w, "cpu")
    start = 1 * h * w + 7 * w + 3  # z=1 ring, row 7, column 3
    assert bool(cand[0, start])
    starts = np.array([start], np.int32)
    d0 = ((coords - coords[start]) ** 2).sum(-1)
    d0[~cand[0]] = -1.0
    assert int((d0 == d0.max()).sum()) >= 2  # the first argmax is a tie
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fps_pallas(jnp.asarray(cand.numpy()), jnp.asarray(coords.numpy())[None], jnp.asarray(starts), 40))
    got = fps_kernel.fps_plain(cand, coords[None], torch.tensor(starts), 40).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(torch.nonzero(d0 == d0.max())[0])
    np.testing.assert_array_equal(got[0, 1], coords[first].numpy())


def _xla_fps_from_start(candidate, coords, k, start):
    """The XLA route's loop (``pointcloud_device.py:_fps_grid``, lines 66-84)
    from a given start instead of its own draw."""
    candidate, coords = jnp.asarray(candidate), jnp.asarray(coords)

    def sq_dist(idx):
        diff = coords - coords[idx]
        return jnp.sum(diff * diff, axis=-1)

    d0 = jnp.where(candidate, sq_dist(start), jpc.NEG)
    out0 = jnp.zeros((k, 3), jnp.float32).at[0].set(coords[start])

    def body(i, carry):
        d, out = carry
        idx = jnp.argmax(d)
        out = out.at[i].set(coords[idx])
        return jnp.where(candidate, jnp.minimum(d, sq_dist(idx)), jpc.NEG), out

    return np.asarray(jax.lax.fori_loop(1, k, body, (d0, out0))[1])


def _risky_case(kind):
    """(valid (1, P) bool, coords (P, 3) f32, start, k): the cases that a
    kernel which shares a cloud among blocks, in chunks of 1024 original
    indices dealt round-robin to 8 blocks, could get wrong."""
    rng = np.random.default_rng(11)
    if kind == "ties_1024_and_8192_apart":
        # a cluster of points near the origin and three far points at one
        # distance from it and from each other, at indices 5, 5 + 1024 (the
        # next block's chunk) and 5 + 8 * 1024 (the same block's next chunk):
        # the lowest original index must win each tie
        p = 10 * 1024
        coords = np.round(rng.uniform(-1, 1, size=(p, 3)) * 8) / 8
        coords[0] = 0.0
        coords[5], coords[5 + 1024], coords[5 + 8192] = (16, 0, 0), (0, 16, 0), (0, 0, 16)
        return np.ones((1, p), bool), coords.astype(np.float32), 0, 6
    if kind == "invalid_start":
        p = 1280
        valid = rng.uniform(size=(1, p)) < 0.5
        valid[0, 7] = False
        return valid, rng.normal(size=(p, 3)).astype(np.float32), 7, 12
    if kind == "all_valid":
        p = 2304
        return np.ones((1, p), bool), rng.normal(size=(p, 3)).astype(np.float32), 100, 20
    if kind == "one_valid":
        p = 1152
        valid = np.zeros((1, p), bool)
        valid[0, 1100] = True
        return valid, rng.normal(size=(p, 3)).astype(np.float32), 1100, 5
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ties_1024_and_8192_apart", "invalid_start", "all_valid", "one_valid"])
def test_fps_plain_equals_both_jax_routes_where_a_shared_cloud_is_at_risk(kind):
    from jax.experimental.pallas import tpu as pltpu

    valid, coords, start, k = _risky_case(kind)
    starts = np.array([start], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(fps_pallas(jnp.asarray(valid), jnp.asarray(coords)[None], jnp.asarray(starts), k))
    want_xla = _xla_fps_from_start(valid[0], coords, k, start)
    got = fps_kernel.fps_plain(torch.tensor(valid), torch.tensor(coords)[None], torch.tensor(starts), k).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got[0], want_xla)
    np.testing.assert_array_equal(got[0, 0], coords[start])
    if kind == "ties_1024_and_8192_apart":
        np.testing.assert_array_equal(got[0, 1:4], coords[[5, 5 + 1024, 5 + 8192]])
    if kind == "invalid_start":
        chosen = {tuple(pt) for pt in got[0, 1:]}
        assert tuple(coords[start]) not in chosen and chosen <= {tuple(pt) for pt in coords[valid[0]]}
    if kind == "one_valid":
        np.testing.assert_array_equal(got[0], np.tile(coords[1100], (k, 1)))


def test_fps_takes_a_broadcast_grid_and_general_coordinates():
    """``coords`` with batch stride 0 gives what B copies give; on float
    coordinates with P not a multiple of 128 the sequence matches a direct
    numpy transcription of the greedy rule; the result carries no gradient."""
    rng = np.random.default_rng(1)
    b, p, k = 3, 333, 17
    coords = torch.tensor(rng.normal(size=(p, 3)), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=(b, p)) < 0.6)
    starts = torch.tensor([int(np.flatnonzero(v)[i]) for i, v in enumerate(valid.numpy())], dtype=torch.int32)
    got = fps_kernel.fps(valid, coords.expand(b, -1, -1), starts, k)
    assert not got.requires_grad and got.dtype == torch.float32
    assert torch.equal(got, fps_kernel.fps_plain(valid, coords.expand(b, -1, -1).contiguous(), starts, k))
    c = coords.numpy()
    for i in range(b):
        v = valid[i].numpy()
        idx, dist, want = int(starts[i]), None, []
        for _ in range(k):
            want.append(c[idx])
            d = c - c[idx]
            nd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            dist = np.where(v, nd if dist is None else np.minimum(dist, nd), np.float32(-1e30))
            idx = int(np.argmax(dist))  # numpy: the first maximum
        np.testing.assert_array_equal(got[i].numpy(), np.stack(want))


def test_fps_stays_in_bounds_without_valid_points():
    valid = torch.zeros((1, 10), dtype=torch.bool)
    coords = torch.arange(30, dtype=torch.float32).reshape(1, 10, 3)
    out = fps_kernel.fps(valid, coords, torch.tensor([7], dtype=torch.int32), 4)
    assert torch.equal(out[0, 0], coords[0, 7]) and torch.equal(out[0, 1:], coords[0, :1].expand(3, -1))


@pytest.mark.parametrize(
    "bad",
    [
        lambda v, c, s: (v.float(), c, s),
        lambda v, c, s: (v, c.double(), s),
        lambda v, c, s: (v, c[:, :-1], s),
        lambda v, c, s: (v, c, s.long()),
    ],
)
def test_fps_rejects_what_it_does_not_take(bad):
    v, c, s = torch.ones((2, 8), dtype=torch.bool), torch.zeros((2, 8, 3)), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fps_kernel.fps(*bad(v, c, s), 3)


def test_masks_to_point_clouds_draws_a_candidate_start():
    """The outer function only adds the draw: every cloud starts on a
    candidate, lands on candidates, and a seed repeats."""
    masks = torch.tensor(_masks("rectangles"))
    gen = torch.Generator().manual_seed(5)
    a = tpc.masks_to_point_clouds(masks, gen, number_points=30)
    b = tpc.masks_to_point_clouds(masks, torch.Generator().manual_seed(5), number_points=30)
    assert torch.equal(a, b)
    cand = tpc.candidates(masks > 0).reshape(2, 3, 64, 64)
    z, y, x = a.long().unbind(-1)
    assert bool(cand[torch.arange(2)[:, None], z, y, x].all())
    firsts = {tuple(tpc.masks_to_point_clouds(masks, gen, number_points=1)[0, 0].tolist()) for _ in range(8)}
    assert len(firsts) > 1  # the start is random
    assert torch.equal(a, tpc.masks_to_point_clouds(masks, torch.Generator().manual_seed(5), number_points=30, impl="plain"))
    with pytest.raises(ValueError):
        tpc.masks_to_point_clouds(masks, gen, impl="pallas")
