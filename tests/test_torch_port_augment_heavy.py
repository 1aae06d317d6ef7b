"""The port's heavy and medium augmentation pipelines against the JAX
package's ``ops/augment.py``, on the CPU.

``jax.random`` and ``torch.Generator`` draw different numbers from a seed, so
:func:`jax_heavy_draws` transcribes the JAX pipeline's key tree
(``split(rng, 4)``; per sample ``split(kb, B)``; the geometry's
``split(key, 12)``; ``fold_in(key, 11)`` for the piecewise grid; the entries'
``split(fold_in(key, 7), 40)``; the Perlin octaves' ``fold_in``) and hands the
values to the port's arithmetic (``augment_from_draws`` and the ops under it).
The port's own sampler is held by distribution gates.

Tolerances, on the 0..255 scale:

* the median blur is an integer and must be **bit-equal**;
* separable blurs, the 3x3 kernels and the noise, dropout, invert, add,
  multiply and grayscale entries: atol 1e-3 (f32 products summed in the same
  order; ``exp`` and the kernel blends may differ by an ulp, and a 3x3 sum
  reaches ~2,000 before the final clip, where an ulp is 1.2e-4);
* the HSV conversions: atol 1e-3 (a division by the channel range);
* Perlin noise atol 1e-5 on its [-0.71, 0.71] range, the shaped mask 1e-4;
* the perspective homography: relative 1e-4 on its entries (two LU solves of
  an 8x8 f32 system whose entries reach 6e4);
* ``jax.image.resize`` (linear, antialiased down and plain up; nearest): 1e-5
  on unit values;
* superpixels and the whole pipelines: what is discontinuous (the k-means
  argmin, the median's rounding, the snapped and nearest-neighbour fetches)
  turns a last-bit difference upstream into a different pixel, so images are
  held at atol 0.05 except a share of pixels, and masks equal except <= 0.5%
  of pixels. The k-means amplifies most: a pixel whose nearest two centres
  are within an ulp moves the next centres, and so on for two refinements.
  JAX against itself (the same call compiled and eager) differs in 1.9% of
  the pixels at 48^2 (11.5% in one sample of six, none in the others) and
  10.4% at 130^2 (22% in one sample of three)
  (``tests/diag_torch_port_superpixels_spread.py`` prints these). The port is held at 5% and
  15% there (it measured 2.7% and 12.4%); in a whole pipeline, a sample that the superpixels touched is held at 50%
  of its pixels and every other sample at 0.5%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.ops import augment as jaug
from pointcloududa_torch.ops import augment as taug
from test_torch_port_step import one_torch_thread  # noqa: F401

H = W = 48
B = 6
OP_ATOL = 1e-3
PIPE_ATOL, MASK_SHARE = 0.05, 0.005


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _images(seed, b=B, h=H, w=W, lo=0.0, hi=255.0):
    """Smooth structure plus noise (so blurs and superpixels have edges to
    find), in [lo, hi]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = 127.5 + 90 * np.sin(6 * yy[None, ..., None] + rng.uniform(0, 6, (b, 1, 1, 3))) * np.cos(5 * xx[None, ..., None])
    return np.clip(base + rng.normal(0, 25, (b, h, w, 3)), lo, hi).astype(np.float32)


# --------------------------------------------------------------------- #
# JAX's draws, in the port's format. Each helper takes one sample's key and
# returns JAX arrays, so that a batch is one eager ``jax.vmap`` (no compile).
def _u(key, lo_hi, shape=()):
    return jax.random.uniform(key, shape, minval=lo_hi[0], maxval=lo_hi[1])


def _child_draws(key, cfg):
    """``_child_matrices(key, cfg, h, w)``'s draws (``augment.py:253-309``)."""
    ks = jax.random.split(key, 11)
    u = jax.random.uniform
    tx = cfg.translate_x if cfg.translate_x is not None else cfg.translate
    u2 = u(ks[9], (2,))
    return dict(
        gates=jnp.stack([u(ks[0]) < cfg.fliplr, u(ks[1]) < cfg.flipud, u(ks[2]) < cfg.croppad_prob, u(ks[4]) < cfg.affine_prob]),
        p4=_u(ks[3], cfg.croppad, (4,)), sy=_u(ks[5], cfg.scale), sx=_u(ks[6], cfg.scale), theta_deg=_u(ks[7], cfg.rotate),
        shear_deg=_u(ks[8], cfg.shear),
        t=jnp.stack([cfg.translate[0] + u2[0] * (cfg.translate[1] - cfg.translate[0]), tx[0] + u2[1] * (tx[1] - tx[0])]),
        snap_u=u(ks[10]))


def _perlin_draws(key):
    """``_perlin_mask(key, ...)``'s draws (``augment.py:711-733``)."""
    ks = jax.random.split(key, 3)
    octaves = [jax.random.split(jax.random.fold_in(ks[1], i), 3) for i in range(3)]
    return dict(perlin_n=jax.random.randint(ks[0], (), 1, 4),
                perlin_g=jnp.stack([jax.random.randint(k[0], (), 2, jaug._PERLIN_G + 1) for k in octaves]),
                perlin_nearest=jnp.stack([jax.random.uniform(k[1]) < 0.5 for k in octaves]),
                perlin_theta=jnp.stack([jax.random.uniform(k[2], (18, 18), maxval=2.0 * jnp.pi) for k in octaves]),
                perlin_thresh=jax.random.normal(ks[2]) * 5.0)


def _superpixel_draws(key, cfg, h, w):
    """``_superpixels(key, img, cfg)``'s draws (``augment.py:811-865``)."""
    _, hs, ws = taug._superpixel_size(h, w)
    ks = jax.random.split(key, 6)
    return dict(sp_n=jax.random.randint(ks[0], (), cfg.superpixels_segments[0], cfg.superpixels_segments[1] + 1),
                sp_ys=jax.random.randint(ks[1], (200,), 0, hs), sp_xs=jax.random.randint(ks[2], (200,), 0, ws),
                sp_p=_u(ks[3], cfg.superpixels_replace), sp_u=jax.random.uniform(ks[4], (200,)))


def _entry_draws(ks, cfg, h, w, c):
    """The twelve entries' draws from the per-sample (40,) subkeys
    (``_entry_fns``, ``augment.py:881-970``)."""
    u = jax.random.uniform
    d = _superpixel_draws(ks[20], cfg, h, w)
    d.update(blur_sigma=_u(ks[21], cfg.blur_sigma),
             avg_k=jax.random.randint(ks[22], (), cfg.avg_blur_k[0], cfg.avg_blur_k[1] + 1),
             median_k=2 * jax.random.randint(ks[23], (), cfg.median_blur_k[0] // 2, cfg.median_blur_k[1] // 2 + 1) + 1,
             blur_choice=jax.random.randint(ks[24], (), 0, 3),
             sharpen_alpha=_u(ks[25], cfg.sharpen_alpha), sharpen_lightness=_u(ks[26], cfg.sharpen_lightness),
             emboss_alpha=_u(ks[27], cfg.emboss_alpha), emboss_strength=_u(ks[28], cfg.emboss_strength))
    ek = jax.random.split(ks[29], 4)
    d.update(edge_alpha=_u(ek[0], cfg.edge_alpha), edge_directed=u(ek[2]) < 0.5, edge_direction=u(ek[3]),
             **_perlin_draws(ek[1]))
    d.update(noise_scale=_u(ks[12], cfg.noise_scale),
             noise=jnp.where(u(ks[13]) < 0.5, jax.random.normal(ks[14], (h, w, c)), jax.random.normal(ks[14], (h, w, 1))))
    gmax = taug._coarse_grid(cfg, h, w)
    d.update(drop_p=_u(ks[15], cfg.dropout),
             drop_u=jnp.where(u(ks[30]) < 0.5, u(ks[16], (h, w, c)), u(ks[16], (h, w, 1))),
             coarse_p=_u(ks[17], cfg.coarse_dropout), coarse_size=_u(ks[38], cfg.coarse_size),
             coarse_u=jnp.where(u(ks[31]) < 0.2, u(ks[18], (*gmax, c)), u(ks[18], (*gmax, 1))),
             drop_fine=u(ks[32]) < 0.5)
    d.update(invert_ch=u(ks[33], (c,)) < cfg.invert_prob,
             add=jnp.where(u(ks[34]) < 0.5, _u(ks[19], cfg.add, (c,)), _u(ks[19], cfg.add)),
             hue=_u(ks[35], cfg.hue_sat),
             multiply=jnp.where(u(ks[36]) < 0.5, _u(ks[9], cfg.multiply, (c,)), _u(ks[9], cfg.multiply)),
             gray_alpha=_u(ks[37], cfg.grayscale_alpha))
    return d


def _sample_draws(key, cfg, h, w, c):
    """One sample's draws of ``geo_one`` and ``_apply_someof_exact``
    (``augment.py:1066-1126``, ``:1017``)."""
    ks = jax.random.split(key, 12)
    pk = jax.random.split(ks[7], 3)
    return dict(
        _child_draws(ks[2], cfg), cval=jax.random.uniform(ks[6], minval=0.0, maxval=255.0),
        mode=jax.random.randint(ks[11], (), 0, 5), active=jaug.someof_active(ks[10], cfg),
        persp_scale=_u(pk[1], cfg.perspective_scale), persp_jitter=jax.random.normal(pk[2], (4, 2)),
        elastic_alpha=_u(ks[4], cfg.elastic_alpha), elastic_field=jax.random.uniform(ks[5], (h, w, 2), minval=-1.0, maxval=1.0),
        pw_scale=_u(ks[9], cfg.piecewise_scale), pw_grid=jax.random.normal(jax.random.fold_in(key, 11), (4, 4, 2)),
        **_entry_draws(jax.random.split(jax.random.fold_in(key, 7), 40), cfg, h, w, c))


def _batch(fn, keys):
    """``fn(key)`` for every key, as torch tensors with a leading batch axis."""
    return {k: torch.tensor(np.asarray(v)) for k, v in jax.vmap(fn)(keys).items()}


def jax_heavy_draws(rng, cfg, b, h, w, c):
    """Every value ``make_augment_fn(cfg)(rng, images, masks)`` draws, in the
    port's format (``augment.py:1128-1191``)."""
    k_order, k_perm, k_coin, kb = jax.random.split(rng, 4)
    draws = _batch(lambda k: _sample_draws(k, cfg, h, w, c), jax.random.split(kb, b))
    draws.update(order5=_t(jax.random.permutation(k_order, 5)), perm12=_t(jax.random.permutation(k_perm, 12)),
                 coin=_t(jax.random.uniform(k_coin) < 0.5))
    return draws


# --------------------------------------------------------------------- #
# op goldens
@pytest.fixture(scope="module")
def jax_ops():
    """The JAX ops vmapped over a batch, each compiled once for this module."""
    v = lambda fn, axes: jax.jit(jax.vmap(fn, in_axes=axes))  # noqa: E731
    return dict(
        median=v(jaug._median_blur, (0, 0)), avg=v(jaug._avg_blur, (0, 0)), gauss=v(jaug._gaussian_blur, (0, 0)),
        sharpen=v(jaug._sharpen, (0, 0, 0)), emboss=v(jaug._emboss, (0, 0, 0)),
        directed=v(jaug._directed_edge_kernel, (0,)),
        hsv=v(jaug._rgb_to_hsv, (0,)), rgb=v(jaug._hsv_to_rgb, (0,)),
        hue=v(lambda k, im: jaug._add_hue_sat(k, im, jaug.heavy().hue_sat), (0, 0)),
        perlin=v(jaug._perlin_eval_sep, (0, 0, 0)), mask=v(lambda k: jaug._perlin_mask(k, H, W), (0,)),
        persp=v(lambda k, g: jaug._perspective_inverse(k, jaug.heavy(), H, W, gate=g), (0, 0)),
    )


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, "mixed"])
def test_median_blur_is_bit_equal_to_jax(k, jax_ops):
    """Inputs off the integers and outside [0, 255], with ties: the port's
    masked median over the unfolded window equals the bit descent."""
    rng = np.random.default_rng(1)
    img = np.round(_images(2, lo=-20, hi=275) * 4) / 4  # quarter steps: round-half-even ties
    img[0, :10, :10] = 37.0  # a flat patch
    kk = np.array([3, 5, 7, 9, 11, 3]) if k == "mixed" else np.full(B, k)
    kk = rng.permutation(kk)
    want = _np(jax_ops["median"](img, kk))
    got = taug._median_blur(torch.tensor(img), torch.tensor(kk)).numpy()
    np.testing.assert_array_equal(got, want)


def test_separable_blurs_match_jax(jax_ops):
    img = _images(3)
    k = np.array([1, 2, 3, 4, 5, 7])
    sigma = np.array([0.0, 0.3, 0.9, 1.5, 2.2, 3.0], np.float32)
    np.testing.assert_allclose(taug._avg_blur(torch.tensor(img), torch.tensor(k)).numpy(), _np(jax_ops["avg"](img, k)),
                               rtol=0, atol=OP_ATOL)
    np.testing.assert_allclose(taug._gaussian_blur(torch.tensor(img), torch.tensor(sigma)).numpy(),
                               _np(jax_ops["gauss"](img, sigma)), rtol=0, atol=OP_ATOL)


def test_3x3_kernels_match_jax(jax_ops):
    img = _images(4)
    rng = np.random.default_rng(4)
    a, s = rng.uniform(0, 1, B).astype(np.float32), rng.uniform(0, 2, B).astype(np.float32)
    lt = rng.uniform(0.75, 1.5, B).astype(np.float32)
    np.testing.assert_allclose(taug._sharpen(*map(torch.tensor, (img, a, lt))).numpy(), _np(jax_ops["sharpen"](img, a, lt)),
                               rtol=0, atol=OP_ATOL)
    np.testing.assert_allclose(taug._emboss(*map(torch.tensor, (img, a, s))).numpy(), _np(jax_ops["emboss"](img, a, s)),
                               rtol=0, atol=OP_ATOL)
    direction = np.concatenate([np.arange(0, 1, 1 / 64), [0.999999, 0.5]]).astype(np.float32)
    np.testing.assert_allclose(taug._directed_edge_kernel(torch.tensor(direction)).numpy(),
                               _np(jax_ops["directed"](direction)), rtol=0, atol=1e-6)


def test_perlin_matches_jax(jax_ops):
    """``_perlin_eval_sep`` on fixed lattices, and the shaped mask from JAX's draws."""
    rng = np.random.default_rng(5)
    theta = rng.uniform(0, 2 * np.pi, (B, 18, 18)).astype(np.float32)
    g = rng.integers(2, 17, B).astype(np.float32)
    u = (np.arange(H, dtype=np.float32)[None] * (g[:, None] / H)).astype(np.float32)
    v = np.floor(np.arange(W, dtype=np.float32)[None] * (g[:, None] / W)) + 0.5
    v = v.astype(np.float32)
    np.testing.assert_allclose(taug._perlin_eval_sep(*map(torch.tensor, (theta, u, v))).numpy(),
                               _np(jax_ops["perlin"](theta, u, v)), rtol=0, atol=1e-5)
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    d = _batch(_perlin_draws, keys)
    assert len(set(d["perlin_n"].tolist())) == 3 and d["perlin_nearest"].any() and not d["perlin_nearest"].all()
    got = taug._perlin_mask(d["perlin_n"], d["perlin_g"], d["perlin_nearest"], d["perlin_theta"], d["perlin_thresh"], H, W)
    np.testing.assert_allclose(got.numpy(), _np(jax_ops["mask"](keys)), rtol=0, atol=1e-4)


def test_hsv_matches_jax(jax_ops):
    """The cv2-convention HSV round trip and the hue/saturation entry, with
    grey pixels (no hue) and channel ties."""
    img = _images(6)
    img[:, :4] = img[:, :4, :, :1]  # grey rows
    img[:, 4:8, :, 1] = img[:, 4:8, :, 0]  # r == g
    hsv = _np(jax_ops["hsv"](img))
    np.testing.assert_allclose(taug._rgb_to_hsv(torch.tensor(img)).numpy(), hsv, rtol=0, atol=OP_ATOL)
    np.testing.assert_allclose(taug._hsv_to_rgb(torch.tensor(hsv)).numpy(), _np(jax_ops["rgb"](hsv)), rtol=0, atol=OP_ATOL)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    val = _np(jax.vmap(lambda k: _u(k, jaug.heavy().hue_sat))(keys))
    np.testing.assert_allclose(taug._add_hue_sat(torch.tensor(img), torch.tensor(val)).numpy(), _np(jax_ops["hue"](keys, img)),
                               rtol=0, atol=OP_ATOL)


def _share(a, b):
    return float((np.abs(a - b).max(-1) > PIPE_ATOL).mean())


@pytest.mark.parametrize("size,share", [(48, 0.05), (130, 0.15)], ids=["48px", "130px-downscaled"])
def test_superpixels_match_jax(size, share):
    """From JAX's draws; at 130 px the image is downscaled to 65 px (the
    antialiased linear resize) and the segments upscaled nearest. The port
    is held at the share of pixels JAX's own eager call of the function
    leaves from its compiled call on these inputs (1.9% and 10.4%), plus 3%
    and 5% (module docstring)."""
    cfg = jaug.heavy()
    b = 3 if size == 130 else B
    img = _images(7, b=b, h=size, w=size)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    want = _np(jax.jit(jax.vmap(lambda k, im: jaug._superpixels(k, im, cfg)))(keys, img))
    d = _batch(lambda k: _superpixel_draws(k, cfg, size, size), keys)
    got = taug.apply_op("superpixels", torch.tensor(img), d).numpy()
    assert _share(got, want) <= share, _share(got, want)
    assert (np.abs(got - img).max(-1) > 0).mean() > 0.2  # segments were replaced


@pytest.mark.parametrize("shape", [(4, 4, 48, 48), (48, 48, 24, 24), (130, 130, 65, 65), (40, 64, 13, 17), (13, 17, 40, 64)])
def test_resize_matches_jax_image_resize(shape):
    h0, w0, h1, w1 = shape
    x = np.random.default_rng(8).normal(size=(2, h0, w0, 2)).astype(np.float32)
    want = _np(jax.vmap(lambda a: jax.image.resize(a, (h1, w1, 2), "linear"))(x))
    np.testing.assert_allclose(taug._resize_linear(torch.tensor(x), h1, w1).numpy(), want, rtol=0, atol=1e-5)
    want = _np(jax.image.resize(x[0], (h1, w1, 2), "nearest"))
    got = x[0][taug._nearest_index(h0, h1, "cpu").numpy()][:, taug._nearest_index(w0, w1, "cpu").numpy()]
    np.testing.assert_array_equal(got, want)


def test_geometry_members_match_jax(jax_ops):
    """The perspective homography (gate on and off) and the piecewise-affine
    field, each from JAX's draws (the elastic field is JAX's raw U(-1, 1)
    draw times alpha, unsmoothed: held inside the whole pipelines below)."""
    cfg = jaug.heavy()
    keys = jax.random.split(jax.random.PRNGKey(9), 8)
    gate = np.array([True, False] * 4)
    pk = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    want = _np(jax_ops["persp"](keys, gate))
    scale, jitter = (_batch(lambda k: {"x": _u(k[1], cfg.perspective_scale)}, pk)["x"],
                     _batch(lambda k: {"x": jax.random.normal(k[2], (4, 2))}, pk)["x"])
    got = taug.perspective_from_params(torch.tensor(gate), scale, jitter, H, W).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.abs(got[~gate] - np.eye(3)).max() < 1e-4  # a resting member is the identity, to float error

    def jax_field(key):  # the piecewise field as geo_one builds it (augment.py:1094-1097)
        s = jaug._u(jax.random.split(key, 12)[9], cfg.piecewise_scale)
        grid = jax.random.normal(jax.random.fold_in(key, 11), (4, 4, 2))
        return jax.image.resize(grid, (H, W, 2), "linear") * s * jnp.array([H, W], jnp.float32), s, grid

    want, s, grid = map(_np, jax.vmap(jax_field)(keys))
    np.testing.assert_allclose(taug.piecewise_field(_t(grid), _t(s), H, W).numpy(), want, rtol=0, atol=1e-4)


# --------------------------------------------------------------------- #
# entries, the SomeOf block and the whole pipelines on JAX's draws
@pytest.fixture(scope="module")
def jax_someof():
    """``_apply_someof_exact`` compiled once for heavy() at 48^2."""
    cfg = jaug.heavy()
    return jax.jit(lambda keys, imgs, active, perm: jaug._apply_someof_exact(keys, imgs, active, perm, cfg))


@pytest.fixture(scope="module")
def someof_case():
    rng = jax.random.PRNGKey(10)
    draws = jax_heavy_draws(rng, jaug.heavy(), B, H, W, 3)
    keys = jax.random.split(jax.random.split(rng, 4)[3], B)
    return keys, _images(10), draws


def _held(got, want, share, what):
    differ = np.abs(got - want).max(-1) > PIPE_ATOL
    assert differ.mean() <= share, f"{what}: {differ.mean():.4%} of pixels beyond {PIPE_ATOL}"


@pytest.mark.parametrize("entry", range(12), ids=list(taug.ENTRIES))
def test_entry_matches_jax(entry, jax_someof, someof_case):
    """Each of the twelve intensity entries alone on every sample, through
    the port's plan (the blur entry split by its OneOf choice) against
    ``_apply_someof_exact`` with only that entry active."""
    keys, img, draws = someof_case
    active = np.zeros((B, 15), bool)
    active[:, entry] = True
    want = _np(jax_someof(keys, img, active, jnp.arange(12)))
    steps, _ = taug._plan({**draws, "active": torch.tensor(active)}, [entry], torch.device("cpu"))
    got = taug.apply_intensity(torch.tensor(img), draws, steps).numpy()
    if entry in (0, 1):  # the superpixels' argmin and the median's rounding are discontinuous
        _held(got, want, 0.005, taug.ENTRIES[entry])
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)
    if entry == 1:
        assert len({name for name, _ in steps}) >= 2  # more than one kind of blur ran


def test_someof_block_matches_jax_in_a_drawn_order(jax_someof, someof_case):
    """JAX's own SomeOf draw and per-batch order: several entries per sample,
    composed in that order."""
    keys, img, draws = someof_case
    active, perm = draws["active"].numpy(), draws["perm12"].numpy()
    assert active[:, :12].sum(1).max() >= 2 and sorted(perm.tolist()) == list(range(12))
    want = _np(jax_someof(keys, img, active, perm))
    steps, _ = taug._plan(draws, perm.tolist(), torch.device("cpu"))
    _held(taug.apply_intensity(torch.tensor(img), draws, steps).numpy(), want, 0.005, "SomeOf block")


def _held_pipeline(got, want, draws, what):
    """A sample that the superpixels entry touched differs where the k-means
    parted ways (module docstring) and is held at 50% of its pixels; every
    other sample at 0.5%."""
    differ = (np.abs(got - want).max(-1) > PIPE_ATOL).reshape(len(got), -1).mean(1)
    sp = draws["active"][:, 0].numpy()
    assert (differ[~sp] <= 0.005).all() and (differ[sp] <= 0.5).all(), \
        f"{what}: shares of pixels beyond {PIPE_ATOL}: {differ} (superpixels in {sp})"


@pytest.fixture(scope="module", params=["heavy", "medium"])
def jax_pipeline_runs(request):
    """JAX's ``augment`` (compiled once per pipeline) on three batches with
    masks, and its draws in the port's format."""
    name = request.param
    jfn, cfg = jaug.make_augment_fn(getattr(jaug, name)()), getattr(jaug, name)()
    rng_np = np.random.default_rng(11)
    runs = []
    for seed in range(3):
        img, masks = _images(20 + seed), rng_np.integers(0, 4, size=(B, H, W), dtype=np.uint8)
        key = jax.random.PRNGKey(100 + seed)
        runs.append((img, masks, *map(_np, jfn(key, img, masks)), jax_heavy_draws(key, cfg, B, H, W, 3)))
    return name, runs


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_pipeline_matches_jax_on_its_draws(with_mask, jax_pipeline_runs):
    """The whole ``augment`` over three batches: JAX's draws replayed through
    ``augment_from_draws``. JAX's images come from its run with masks (its
    images do not depend on them)."""
    name, runs = jax_pipeline_runs
    tcfg = getattr(taug, name)()
    fired, sides = np.zeros(15, int), set()
    for seed, (img, masks, want_img, want_mask, draws) in enumerate(runs):
        fired += draws["active"].numpy().sum(0)
        got_img, got_mask = taug.augment_from_draws(tcfg, torch.tensor(img), torch.tensor(masks) if with_mask else None, draws)
        _held_pipeline(got_img.numpy(), want_img, draws, f"{name} seed {seed}")
        if with_mask:
            assert got_mask.dtype == torch.int32
            assert (got_mask.numpy() != want_mask).mean() <= MASK_SHARE
        else:
            assert got_mask is None
        assert got_img.min() >= 0.0 and got_img.max() <= 255.0
        sides.add(int(torch.argsort(draws["order5"])[4]) < int(torch.argsort(draws["order5"])[2]))
    n = 15 if name == "heavy" else 12
    assert (fired[:n] > 0).sum() >= n // 2 and not fired[n:].any()  # many members fired, none beyond the list
    assert sides == {True, False}  # the SomeOf block ran before the crop&pad in one batch and after it in another


# --------------------------------------------------------------------- #
# the port's own sampler
def test_someof_count_and_rates():
    """k ~ U{0..5} (seen with the Sometimes coin at 1), never more than 5
    members, each plain member at 2.5/15 and each wrapped one at 1.25/15
    (medium: 2.5/12 and 1.25/12 for superpixels, none beyond 12), every
    check within 5 sigma of its binomial mean over 6000 samples."""
    n = 6000
    gen = torch.Generator().manual_seed(0)
    sure = dataclasses.replace(taug.heavy(), sometimes_p=1.0)
    counts = taug._sample_host_draws(gen, sure, n)["active"].sum(1).numpy()
    hist = np.bincount(counts, minlength=6)
    assert len(hist) == 6 and (np.abs(hist / n - 1 / 6) <= 5 * np.sqrt((1 / 6) * (5 / 6) / n)).all(), hist
    for cfg, m in ((taug.heavy(), 15), (taug.medium(), 12)):
        act = taug._sample_host_draws(gen, cfg, n)["active"].numpy()
        assert act.sum(1).max() <= 5 and not act[:, m:].any()
        for j in range(m):
            p = 2.5 / m * (0.5 if j in (0, 12, 13, 14) else 1.0)
            assert abs(act[:, j].mean() - p) <= 5 * np.sqrt(p * (1 - p) / n), (m, j, act[:, j].mean(), p)


def test_orders_are_uniform():
    """The first place of the per-batch SomeOf order over the 12 entries and
    of the outer order over the 5 children, and the placement coin, within
    5 sigma over 1200 batches; the blur choice over its three kinds."""
    gen = torch.Generator().manual_seed(1)
    draws = [taug._sample_host_draws(gen, taug.heavy(), 1) for _ in range(1200)]
    for values, m in (([int(d["perm12"][0]) for d in draws], 12), ([int(d["blur_choice"][0]) for d in draws], 3)):
        freq = np.bincount(values, minlength=m) / len(values)
        assert (np.abs(freq - 1 / m) <= 5 * np.sqrt((1 / m) * (1 - 1 / m) / len(values))).all(), freq
    assert abs(np.mean([bool(d["coin"]) for d in draws]) - 0.5) <= 5 * np.sqrt(0.25 / 1200)
    firsts = [int(taug.sample_draws(gen, taug.heavy(), 1, "cpu", (4, 4, 3))["order5"][0]) for _ in range(500)]
    freq = np.bincount(firsts, minlength=5) / 500
    assert (np.abs(freq - 0.2) <= 5 * np.sqrt(0.2 * 0.8 / 500)).all(), freq


ALL_OFF = dict(fliplr=0.0, flipud=0.0, croppad_prob=0.0, affine_prob=0.0, someof_n=0, intensity_gate=0.0,
               superpixels_prob=0.0, invert_prob=0.0, elastic_prob=0.0, piecewise_prob=0.0, perspective_prob=0.0)
NEUTRAL = dict(blur_sigma=(0.0, 0.0), avg_blur_k=(1, 1), median_blur_k=(1, 1), sharpen_alpha=(0.0, 0.0),
               emboss_alpha=(0.0, 0.0), edge_alpha=(0.0, 0.0), noise_scale=(0.0, 0.0), dropout=(0.0, 0.0),
               coarse_dropout=(0.0, 0.0), add=(0.0, 0.0), hue_sat=(0.0, 0.0), multiply=(1.0, 1.0),
               grayscale_alpha=(0.0, 0.0))


def _legacy(**kw):
    """The legacy mode with every gate at 1 and every entry neutral but ``kw``
    (the JAX package's tests/test_augment_distribution.py recipe)."""
    return dataclasses.replace(taug.AugmentConfig(**{**ALL_OFF, "intensity_gate": 1.0}), **{**NEUTRAL, **kw})


def test_add_and_noise_moments():
    """Add((-10, 10), per_channel=0.5): the shift of an image's mean has the
    spec's mean, mean absolute value and spread; AdditiveGaussianNoise(scale=
    (0, 12.75)): the per-image noise std averages 6.375. The bounds are the
    JAX package's own (test_augment_distribution.py:384-409)."""
    fn = taug.make_augment_fn(_legacy(add=(-10.0, 10.0)))
    out, _ = fn(torch.Generator().manual_seed(3), torch.full((400, 8, 8, 3), 128.0))
    shifts = out.mean((1, 2, 3)).numpy() - 128.0
    mc = np.random.default_rng(0).uniform(-10, 10, (200000, 3)).mean(axis=1)
    assert abs(shifts.mean()) < 0.8
    assert abs(np.abs(shifts).mean() - (0.5 * 5.0 + 0.5 * np.abs(mc).mean())) < 0.7
    assert abs(shifts.std() - np.sqrt(0.5 * (100 / 3) + 0.5 * mc.var())) < 0.8 and np.abs(shifts).max() <= 10.01
    fn = taug.make_augment_fn(_legacy(noise_scale=(0.0, 12.75)))
    out, _ = fn(torch.Generator().manual_seed(5), torch.full((300, 16, 16, 3), 128.0))
    stds = out.std((1, 2, 3)).numpy()
    assert abs(stds.mean() - 6.375) < 0.9 and stds.max() < 14.5


def test_neutral_entries_are_identities_and_fire_rate():
    """Every entry firing with neutral parameters gives the image back; with
    the heavy SomeOf draw, every member but multiply(1.3, 1.5) neutral (the
    geometry members at scale 0) and the outer children off, a share 2.5/15
    of the images change (5 sigma over 600)."""
    rng = np.random.default_rng(1)
    imgs = torch.tensor(rng.integers(0, 256, size=(16, 16, 16, 3)).astype(np.float32))
    out, _ = taug.make_augment_fn(_legacy())(torch.Generator().manual_seed(1), imgs)
    np.testing.assert_allclose(out.numpy(), imgs.numpy(), atol=0.3)
    cfg = dataclasses.replace(taug.heavy(), **{k: v for k, v in ALL_OFF.items() if k not in ("someof_n", "intensity_gate")},
                              **{**NEUTRAL, "multiply": (1.3, 1.5)}, superpixels_replace=(0.0, 0.0),
                              elastic_alpha=(0.0, 0.0), piecewise_scale=(0.0, 0.0), perspective_scale=(0.0, 0.0))
    imgs = torch.tensor(rng.integers(40, 216, size=(600, 8, 8, 3)).astype(np.float32))
    out, _ = taug.make_augment_fn(cfg)(torch.Generator().manual_seed(2), imgs)
    changed = ~torch.isclose(out, imgs, atol=0.5).flatten(1).all(1)
    p = 2.5 / 15
    assert abs(float(changed.float().mean()) - p) <= 5 * np.sqrt(p * (1 - p) / 600)


def test_a_seed_repeats_and_labels_are_kept():
    """The pipeline from its own sampler: the same generators give the same
    output; masks keep their labels; images stay in [0, 255]; without a host
    generator a CPU generator serves for both."""
    fn = taug.make_augment_fn(taug.heavy())
    img = torch.tensor(_images(12))
    masks = torch.tensor(np.random.default_rng(12).integers(0, 4, size=(B, H, W), dtype=np.uint8))
    a = fn(torch.Generator().manual_seed(4), img, masks, host_generator=torch.Generator().manual_seed(5))
    b = fn(torch.Generator().manual_seed(4), img, masks, host_generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert set(a[1].unique().tolist()) <= {0, 1, 2, 3} and float(a[0].min()) >= 0 and float(a[0].max()) <= 255
    c = fn(torch.Generator().manual_seed(4), img, masks)
    assert c[0].shape == a[0].shape
