"""The port's light augmentation family against the JAX package's
``ops/augment.py``, on the CPU.

``jax.random`` and ``torch.Generator`` draw different numbers from a seed, so
each comparison transcribes the JAX function's key splits to obtain the
values it drew, and feeds those to the port's arithmetic
(``child_matrices_from_params``, ``_warp_one``, ``augment_from_draws``). The
port's own sampler is held by distribution gates in the style of
``tests/test_augment_distribution.py``.

Tolerances: the 3x3 matrices atol 1e-5 (f32 sin/cos/tan and 2x2 products in
another order; entries reach ~50 at 32 pixels, where one f32 ulp is 4e-6);
warped images atol 1e-3 on the 0..255 scale (f32 bilinear weights and
coordinates computed in another order: a coordinate off by one ulp at 32
moves a bilinear sample by up to 255 * 4e-6). Nearest-neighbour outputs (the
mask plane, ``snap`` and ``order=0``) must be **equal**, except at pixels
whose sample coordinate lies within 1e-4 of a rounding boundary, where an ulp
decides the tap; such pixels are counted and bounded, not waved through.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import augment as jaug
from pointcloududa_torch.ops import augment as taug
from test_torch_port_step import one_torch_thread  # noqa: F401

H = W = 32
MATRIX_ATOL = 1e-5
IMAGE_ATOL = 1e-3
BOUNDARY = 1e-4  # distance of a sample coordinate from a rounding boundary
# every child fires often, so the matrices are interesting
BUSY = dict(fliplr=0.5, flipud=0.5, croppad_prob=0.7, affine_prob=0.8)


def _jcfg(**kw):
    return dataclasses.replace(jaug.light(), **kw)


def _tcfg(**kw):
    return dataclasses.replace(taug.light(), **kw)


def _jax_child_draws(key, cfg):
    """The values ``_child_matrices(key, cfg, h, w)`` draws, by its own key
    splits (``pointcloududa_tpu/ops/augment.py:253-309``)."""
    ks = jax.random.split(key, 11)
    u = lambda k: jax.random.uniform(k)  # noqa: E731
    tx_range = cfg.translate_x if cfg.translate_x is not None else cfg.translate
    u2 = jax.random.uniform(ks[9], (2,))
    return dict(
        gates=np.array([u(ks[0]) < cfg.fliplr, u(ks[1]) < cfg.flipud, u(ks[2]) < cfg.croppad_prob,
                        u(ks[4]) < cfg.affine_prob]),
        p4=np.asarray(jaug._u(ks[3], cfg.croppad, (4,))),
        sy=np.asarray(jaug._u(ks[5], cfg.scale)),
        sx=np.asarray(jaug._u(ks[6], cfg.scale)),
        theta_deg=np.asarray(jaug._u(ks[7], cfg.rotate)),
        shear_deg=np.asarray(jaug._u(ks[8], cfg.shear)),
        t=np.asarray(jnp.stack([
            cfg.translate[0] + u2[0] * (cfg.translate[1] - cfg.translate[0]),
            tx_range[0] + u2[1] * (tx_range[1] - tx_range[0]),
        ])),
        snap_u=np.asarray(u(ks[10])),
    )


def _stack(dicts):
    return {k: torch.tensor(np.stack([d[k] for d in dicts])) for k in dicts[0]}


@pytest.fixture(scope="module")
def busy_children():
    """16 samples of the four child matrices under ``BUSY``: JAX's matrices,
    gates and the draws behind them."""
    cfg = _jcfg(**BUSY)
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    mats, any_warp, snap = jax.jit(jax.vmap(lambda k: jaug._child_matrices(k, cfg, H, W)))(keys)
    draws = _stack([_jax_child_draws(k, cfg) for k in keys])
    return np.asarray(mats), np.asarray(any_warp), np.asarray(snap), draws


def test_child_matrices_match_jax(busy_children):
    mats, any_warp, snap, d = busy_children
    got, got_warp, got_snap = taug.child_matrices_from_params(
        d["gates"], d["p4"], d["sy"], d["sx"], d["theta_deg"], d["shear_deg"], d["t"], d["snap_u"], H, W)
    np.testing.assert_allclose(got.numpy(), mats, rtol=0, atol=MATRIX_ATOL)
    np.testing.assert_array_equal(got_warp.numpy(), any_warp)
    np.testing.assert_array_equal(got_snap.numpy(), snap)
    fired = d["gates"].numpy()
    assert fired.any(0).all() and not fired.all(0).any()  # every child both fires and rests
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (16, 4, 3, 3))
    np.testing.assert_array_equal(got.numpy()[~fired], eye[~fired])  # a resting child is the identity


@pytest.mark.parametrize("mode", range(5))
def test_fold_helpers_match_jax(mode):
    i = np.arange(-40, 60)
    want = np.asarray(jaug._border_fold(jnp.asarray(i), 13, jnp.int32(mode)))
    np.testing.assert_array_equal(taug._border_fold(torch.tensor(i), 13, torch.tensor(mode)).numpy(), want)
    t = np.random.default_rng(mode).uniform(-40, 60, size=200).astype(np.float32)
    want = np.asarray(jaug._fold_coord(jnp.asarray(t), 13, jnp.int32(mode)))
    np.testing.assert_allclose(taug._fold_coord(torch.tensor(t), 13, torch.tensor(mode)).numpy(), want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------- #
# _warp_one
@pytest.fixture(scope="module")
def warp_inputs(busy_children):
    """8 images with composite matrices (all four children, in order), a
    non-zero displacement field, a label plane and fill values."""
    mats = busy_children[0][:8]
    M = mats[:, 0] @ mats[:, 1] @ mats[:, 2] @ mats[:, 3]
    rng = np.random.default_rng(2)
    return dict(
        img=rng.uniform(0, 255, size=(8, H, W, 3)).astype(np.float32),
        M=M.astype(np.float32),
        disp=rng.uniform(-1.5, 1.5, size=(8, H, W, 2)).astype(np.float32),
        nn=rng.integers(0, 5, size=(8, H, W)).astype(np.float32),
        cval=rng.uniform(0, 255, size=8).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_warps():
    """The JAX ``_warp_one`` vmapped over the batch, compiled once per static
    variant: (order, with the nn plane)."""
    def build(order, with_nn):
        def one(img, M, disp, cval, mode, snap, nn):
            return jaug._warp_one(img, M, disp, order, cval, mode=mode, snap=snap, nn=nn if with_nn else None)
        return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None, None, 0)))
    return {(order, with_nn): build(order, with_nn) for order in (0, 1) for with_nn in (False, True)}


def _near_boundary(x, snap):
    """Pixels whose sample coordinate (float64, from the shared matrix) lies
    within BOUNDARY of a half-integer, where round-half-down switches taps."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    M = x["M"].astype(np.float64)[:, :, :, None, None]
    dnm = M[:, 2, 0] * yy + M[:, 2, 1] * xx + M[:, 2, 2]
    iy = (M[:, 0, 0] * yy + M[:, 0, 1] * xx + M[:, 0, 2]) / dnm + x["disp"][..., 0]
    ix = (M[:, 1, 0] * yy + M[:, 1, 1] * xx + M[:, 1, 2]) / dnm + x["disp"][..., 1]
    near = lambda t: np.abs(t - np.floor(t) - 0.5) < BOUNDARY  # noqa: E731
    return near(iy) | near(ix)


def _check_nearest(got, want, near, what):
    differ = got != want
    if differ.ndim > near.ndim:
        differ = differ.any(-1)
    assert not (differ & ~near).any(), f"{what}: {int((differ & ~near).sum())} pixels differ away from a rounding boundary"
    assert near.sum() <= 0.005 * near.size, f"{int(near.sum())} pixels near a rounding boundary"


@pytest.mark.parametrize("with_nn", [False, True], ids=["image", "image+mask"])
@pytest.mark.parametrize("snap", [False, True], ids=["bilinear", "snap"])
@pytest.mark.parametrize("mode", range(5), ids=["constant", "edge", "symmetric", "reflect", "wrap"])
def test_warp_order1_matches_jax(mode, snap, with_nn, warp_inputs, jax_warps):
    x = warp_inputs
    want = jax_warps[1, with_nn](x["img"], x["M"], x["disp"], x["cval"], jnp.int32(mode), jnp.bool_(snap), x["nn"])
    t = {k: torch.tensor(v) for k, v in x.items()}
    got = taug._warp_one(t["img"], t["M"], t["disp"], 1, t["cval"], mode=torch.full((8,), mode),
                         snap=torch.full((8,), snap), nn=t["nn"] if with_nn else None)
    near = _near_boundary(x, snap)
    got_img, want_img = (got[0], want[0]) if with_nn else (got, want)
    got_img, want_img = got_img.numpy(), np.asarray(want_img)
    if snap:  # a snapped coordinate is a nearest-neighbour fetch
        got_img = np.where(near[..., None], want_img, got_img)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=IMAGE_ATOL)
    if with_nn:
        _check_nearest(got[1].numpy(), np.asarray(want[1]), near, "mask plane")
        assert set(np.unique(got[1].numpy())) <= set(np.unique(x["nn"])) | {0.0}  # labels are never invented


@pytest.mark.parametrize("mode", range(5), ids=["constant", "edge", "symmetric", "reflect", "wrap"])
def test_warp_order0_matches_jax(mode, warp_inputs, jax_warps):
    x = warp_inputs
    want = np.asarray(jax_warps[0, False](x["img"], x["M"], x["disp"], x["cval"], jnp.int32(mode), jnp.bool_(False), x["nn"]))
    t = {k: torch.tensor(v) for k, v in x.items()}
    got = taug._warp_one(t["img"], t["M"], t["disp"], 0, t["cval"], mode=torch.full((8,), mode)).numpy()
    _check_nearest(got, want, _near_boundary(x, False), "order-0 image")


def test_warp_identity_and_flip_are_exact():
    """Integer maps sample on the grid: no interpolation, no fill."""
    rng = np.random.default_rng(4)
    img = torch.tensor(rng.uniform(0, 255, size=(2, H, W, 3)).astype(np.float32))
    lab = torch.tensor(rng.integers(0, 4, size=(2, H, W)).astype(np.float32))
    eye = torch.eye(3)
    flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, W - 1.0], [0.0, 0.0, 1.0]])
    out, m = taug._warp_one(img, torch.stack([eye, flip]), None, 1, 7.0, nn=lab)
    assert torch.equal(out[0], img[0]) and torch.equal(m[0], lab[0])
    assert torch.equal(out[1], img[1].flip(1)) and torch.equal(m[1], lab[1].flip(1))


# --------------------------------------------------------------------- #
# make_augment_fn, end to end with JAX's draws
def _jax_augment_draws(rng, cfg, b):
    """The draws of ``make_augment_fn(cfg)(rng, ...)`` in the port's format
    (key splits of ``pointcloududa_tpu/ops/augment.py:1066-1151``)."""
    k_order, _, _, kb = jax.random.split(rng, 4)
    keys = jax.random.split(kb, b)
    per = []
    for key in keys:
        ks = jax.random.split(key, 12)
        d = _jax_child_draws(ks[2], cfg)
        d["cval"] = np.asarray(jax.random.uniform(ks[6], minval=0.0, maxval=255.0))
        d["mode"] = np.asarray(jax.random.randint(ks[11], (), 0, 5))
        per.append(d)
    draws = _stack(per)
    draws["order5"] = torch.tensor(np.asarray(jax.random.permutation(k_order, 5)))
    return draws


@pytest.mark.parametrize("variant", ["light", "light+croppad+all_borders"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_augment_matches_jax_on_its_draws(variant, with_mask):
    extra = {} if variant == "light" else dict(croppad_prob=0.6, border_mode_all=True, fliplr=0.5, affine_prob=0.6)
    jcfg, tcfg = _jcfg(**extra), _tcfg(**extra)
    jfn = jaug.make_augment_fn(jcfg)
    tfn_draws = partial(taug.augment_from_draws, tcfg)
    rng_np = np.random.default_rng(7)
    b = 8
    fired = np.zeros(4, int)
    for seed in range(3):
        images = rng_np.integers(0, 256, size=(b, H, W, 3), dtype=np.uint8)
        masks = rng_np.integers(0, 4, size=(b, H, W), dtype=np.uint8) if with_mask else None
        key = jax.random.PRNGKey(seed)
        want_img, want_mask = jfn(key, images, masks)
        draws = _jax_augment_draws(key, jcfg, b)
        fired += draws["gates"].numpy().sum(0)
        got_img, got_mask = tfn_draws(torch.tensor(images), None if masks is None else torch.tensor(masks), draws)
        assert got_img.dtype == torch.float32
        want_img, got_img = np.asarray(want_img), got_img.numpy()
        # a sample whose affine snapped (order 0) or whose mask tap sits on a
        # rounding boundary may differ there: bound those pixels
        differ = np.abs(got_img - want_img).max(-1) > IMAGE_ATOL
        if with_mask:
            assert got_mask.dtype == torch.int32
            differ |= got_mask.numpy() != np.asarray(want_mask)
        assert differ.sum() <= 2, f"seed {seed}: {int(differ.sum())} pixels differ"
        assert got_img.min() >= 0.0 and got_img.max() <= 255.0
    assert fired[0] and fired[1] and fired[3]  # flips and the affine were exercised


# --------------------------------------------------------------------- #
# the port's own sampler
def test_sampler_rates_and_ranges():
    """Gate firing rates within 5 sigma of their binomial means over 2000
    samples; every raw parameter inside its configured range; the batch
    order uniform over the five children."""
    cfg = taug.light()
    gen = torch.Generator().manual_seed(0)
    n = 2000
    d = taug.sample_draws(gen, cfg, n, "cpu")
    for j, p in enumerate((cfg.fliplr, cfg.flipud, cfg.croppad_prob, cfg.affine_prob)):
        rate = float(d["gates"][:, j].float().mean())
        assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12, (j, rate, p)
    for name, (lo, hi) in (("sy", cfg.scale), ("sx", cfg.scale), ("theta_deg", cfg.rotate), ("shear_deg", cfg.shear),
                           ("cval", (0.0, 255.0))):
        v = d[name]
        assert float(v.min()) >= lo and float(v.max()) <= hi and float(v.max() - v.min()) > 0.9 * (hi - lo), name
    ty, tx = d["t"].unbind(-1)
    assert cfg.translate[0] <= float(ty.min()) and float(ty.max()) <= cfg.translate[1]
    assert cfg.translate_x[0] <= float(tx.min()) and float(tx.max()) <= cfg.translate_x[1] < cfg.translate[1]
    assert abs(float((d["snap_u"] < 0.5).float().mean()) - 0.5) <= 5 * np.sqrt(0.25 / n)
    assert d["mode"] is None  # light pins constant borders
    modes = taug.sample_draws(gen, _tcfg(border_mode_all=True), n, "cpu")["mode"]
    assert sorted(modes.unique().tolist()) == [0, 1, 2, 3, 4]
    firsts = np.bincount([int(taug.sample_draws(gen, cfg, 1, "cpu")["order5"][0]) for _ in range(500)], minlength=5)
    assert (np.abs(firsts / 500 - 0.2) <= 5 * np.sqrt(0.2 * 0.8 / 500)).all(), firsts


def test_augment_fn_rates_and_labels():
    """Through ``make_augment_fn(light())`` itself: the share of samples a
    flip-or-affine changes is 1 - 0.8 * 0.8 * 0.7 within 5 sigma, untouched
    samples come back exactly, labels are never invented, images stay in
    [0, 255], and a seed repeats."""
    fn = taug.make_augment_fn(taug.light())
    rng = np.random.default_rng(1)
    images = torch.tensor(rng.integers(0, 256, size=(400, 16, 16, 3), dtype=np.uint8))
    masks = torch.tensor(rng.integers(0, 5, size=(400, 16, 16), dtype=np.uint8))
    out, m = fn(torch.Generator().manual_seed(3), images, masks)
    again, m2 = fn(torch.Generator().manual_seed(3), images, masks)
    assert torch.equal(out, again) and torch.equal(m, m2)
    changed = (m != masks).flatten(1).any(1)
    p = 1 - 0.8 * 0.8 * 0.7
    assert abs(float(changed.float().mean()) - p) <= 5 * np.sqrt(p * (1 - p) / 400)
    assert torch.equal(out[~changed], images[~changed].float())
    assert set(m.unique().tolist()) <= set(range(5))
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    only_img = fn(torch.Generator().manual_seed(3), images)
    assert only_img[1] is None and torch.equal(only_img[0], out)


@pytest.mark.parametrize("name", ["heavy", "medium"])
def test_heavy_and_medium_wait(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        taug.make_augment_fn(getattr(taug, name)())


@pytest.mark.parametrize("name", ["heavy", "medium", "light"])
def test_augment_configs_equal_the_jax_package(name):
    want, got = getattr(jaug, name)(), getattr(taug, name)()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        dataclasses.replace(got, median_blur_k=(3, 13))
