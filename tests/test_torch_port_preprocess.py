"""The port's device preprocess (``train/loop.py:make_device_preprocess``)
against the JAX package's, on the CPU.

Without augmentation the transform is deterministic (normalise, centre crop,
one-hot, clouds / 255): images atol 1e-6, clouds atol 1e-7 (XLA turns the
division by 255 into a product with its reciprocal, which moves a value below
1 by one f32 ulp, 6e-8), everything else equal. With
``aug="light"`` the JAX function's draws are transcribed from its key splits
(``r1..r4 = split(rng, 4)``: source augmentation, target augmentation, source
cloud starts, target cloud starts) and replayed by the port through
``draws=``; images then agree at the warp's tolerance mapped back to the
MM-WHS value range, the one-hot masks exactly, and the regenerated clouds
exactly as voxel coordinates (times 255, rounded: the same one-ulp division).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from pointcloududa_tpu.config import mmwhs_default as j_mmwhs, mscmrseg_default as j_mscmrseg
from pointcloududa_tpu.data.synthetic import synthetic_eval_batch, synthetic_raw_batch
from pointcloududa_tpu.ops import augment as jaug
from pointcloududa_tpu.train import loop as jloop
from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
from pointcloududa_torch.data.synthetic import synthetic_blob_masks
from pointcloududa_torch.ops import augment as taug
from pointcloududa_torch.train.loop import make_device_preprocess
from test_torch_port_augment import IMAGE_ATOL, _jax_augment_draws
from test_torch_port_fps import _jax_starts
from test_torch_port_step import one_torch_thread  # noqa: F401

BS = 4
PRESETS = {"mscmrseg": (j_mscmrseg, mscmrseg_default), "mmwhs": (j_mmwhs, mmwhs_default)}


def _cfgs(workload, **kw):
    """The same configuration in both packages; raw batches are made at 40
    pixels and centre-cropped to 32."""
    jmk, tmk = PRESETS[workload]
    base = dict(crop_size=32, fc_inch=1, filters=8, bs=BS, aug="", d4=True)
    base.update(kw)
    return jmk(**base), tmk(**base)


def _raw(jcfg, size, seed=0):
    return synthetic_raw_batch(dataclasses.replace(jcfg, crop_size=size), BS, seed=seed)


def _assert_batches(got, want, image_atol=1e-6):
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key], np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, key
        if key.startswith("img"):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=image_atol, err_msg=key)
        elif key.startswith("vert"):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


@pytest.mark.parametrize("with_vert_t", [True, False], ids=["vert_t", "no_vert_t"])
@pytest.mark.parametrize("sample_mask", [False, True], ids=["full", "padded_tail"])
@pytest.mark.parametrize("workload", ["mscmrseg", "mmwhs"])
def test_train_preprocess_without_augmentation(workload, sample_mask, with_vert_t):
    jcfg, tcfg = _cfgs(workload)
    raw = _raw(jcfg, 40)
    if sample_mask:
        raw["sample_mask"] = np.array([1, 1, 0, 0], np.uint8)
    want = jloop.make_device_preprocess(jcfg, train=True, device_augment=True)(jax.random.PRNGKey(0), raw, with_vert_t=with_vert_t)
    got = make_device_preprocess(tcfg, train=True, device_augment=True, device="cpu")(None, raw, with_vert_t=with_vert_t)
    _assert_batches(got, want)
    assert ("vert_t" in got) == with_vert_t and ("sample_mask" in got) == sample_mask
    assert got["img_s"].shape == (BS, 32, 32, 3) and got["mask_s"].shape == (BS, 32, 32, tcfg.n_class)
    assert torch.equal(got["mask_s"].sum(-1), torch.ones(BS, 32, 32))


@pytest.mark.parametrize("sample_mask", [False, True], ids=["full", "padded_tail"])
@pytest.mark.parametrize("workload", ["mscmrseg", "mmwhs"])
def test_eval_preprocess(workload, sample_mask):
    jcfg, tcfg = _cfgs(workload)
    ev = synthetic_eval_batch(dataclasses.replace(jcfg, crop_size=40), BS)
    raw = {"img": (ev["img"] * 255).astype(np.uint8) if workload == "mscmrseg" else ev["img"],
           "mask": np.argmax(ev["mask"], -1).astype(np.uint8), "vert": ev["vert"] * 255.0}
    if sample_mask:
        raw["sample_mask"] = np.array([1, 0, 1, 1], np.float32)
    want = jloop.make_device_preprocess(jcfg, train=False, device_augment=False)(raw)
    got = make_device_preprocess(tcfg, train=False, device_augment=False, device="cpu")(raw)
    _assert_batches(got, want)


def test_vert_t_metric_off_and_no_point_head():
    """``vert_t_metric=False`` drops the target cloud whatever the cadence
    says; without a point head the raw batch has no clouds to pass on."""
    jcfg, tcfg = _cfgs("mmwhs", vert_t_metric=False)
    raw = _raw(jcfg, 32)
    got = make_device_preprocess(tcfg, True, True, device="cpu")(None, raw)
    _assert_batches(got, jloop.make_device_preprocess(jcfg, True, True)(jax.random.PRNGKey(0), raw))
    assert "vert_s" in got and "vert_t" not in got
    jcfg, tcfg = _cfgs("mmwhs", d4=False)
    got = make_device_preprocess(tcfg, True, True, device="cpu")(None, _raw(jcfg, 32))
    assert set(got) == {"img_s", "mask_s", "img_t"}


def blob_masks(b, size, seed):
    """Label masks of a few filled ellipses each: more than 50 foreground
    pixels, so that the regenerated clouds have candidates."""
    out = synthetic_blob_masks(b, size, seed=seed)
    assert ((out > 0).reshape(b, -1).sum(1) > 50).all()
    return out


def mmwhs_light_case(jcfg, key, size, seed):
    """A raw MM-WHS batch with blob masks, what the JAX preprocess makes of
    it under ``key``, and the same draws in the port's format."""
    raw = _raw(jcfg, size, seed=seed)
    raw["mask_s"], raw["mask_t"] = blob_masks(BS, size, seed), blob_masks(BS, size, seed + 100)
    want = jloop.make_device_preprocess(jcfg, train=True, device_augment=True)(key, raw)
    r1, r2, r3, r4 = jax.random.split(key, 4)
    light = jaug.light()
    draws = {"aug_s": _jax_augment_draws(r1, light, BS), "aug_t": _jax_augment_draws(r2, light, BS)}
    # the starts are drawn over the WARPED masks' candidates
    blank = torch.zeros(BS, size, size, 1)
    for name, side, r in (("starts_s", "s", r3), ("starts_t", "t", r4)):
        _, warped = taug.augment_from_draws(taug.light(), blank, torch.tensor(raw[f"mask_{side}"]), draws[f"aug_{side}"])
        draws[name] = torch.tensor(_jax_starts(warped.numpy(), r)[1])
    return raw, want, draws


@pytest.mark.parametrize("seed", [0, 1])
def test_mmwhs_light_preprocess_matches_jax_on_its_draws(seed):
    """Augment both streams, regenerate both clouds from the warped masks,
    normalise, crop, one-hot: the whole train preprocess at 64 pixels."""
    jcfg, tcfg = _cfgs("mmwhs", aug="light", crop_size=64)
    raw, want, draws = mmwhs_light_case(jcfg, jax.random.PRNGKey(seed), 64, seed)
    assert draws["aug_s"]["gates"].any() and draws["aug_t"]["gates"].any()  # something was warped
    got = make_device_preprocess(tcfg, True, True, device="cpu")(None, raw, draws=draws)
    # images are min-max mapped to 0..255 around the warp and back
    span = float(max(np.ptp(raw["img_s"]), np.ptp(raw["img_t"])))
    _assert_batches(got, want, image_atol=IMAGE_ATOL * span / 255.0 + 1e-6)
    for key in ("vert_s", "vert_t"):
        cloud = np.rint(got[key].numpy() * 255.0)
        np.testing.assert_array_equal(cloud, np.rint(np.asarray(want[key]) * 255.0), err_msg=key)
        assert cloud.any(axis=(1, 2)).all() and cloud.min() >= 0 and cloud.max() <= 63
    # the raw clouds were replaced, not passed through
    assert not np.allclose(got["vert_s"].numpy(), raw["vert_s"] / 255.0)


def test_light_preprocess_draws_by_itself():
    """Without ``draws`` the port draws from its generator: a seed repeats,
    shapes hold, MS-CMRSeg keeps its precomputed clouds under augmentation."""
    _, tcfg = _cfgs("mmwhs", aug="light", crop_size=64)
    jcfg = _cfgs("mmwhs", crop_size=64)[0]
    raw = _raw(jcfg, 64)
    raw["mask_s"], raw["mask_t"] = blob_masks(BS, 64, 5), blob_masks(BS, 64, 6)
    fn = make_device_preprocess(tcfg, True, True, device="cpu")
    a, b = fn(torch.Generator().manual_seed(2), raw), fn(torch.Generator().manual_seed(2), raw)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["vert_s"].shape == (BS, 300, 3) and float(a["vert_s"].max()) <= 63 / 255.0
    off = make_device_preprocess(tcfg, True, False, device="cpu")(None, raw)  # device_augment=False
    np.testing.assert_array_equal(off["vert_s"].numpy(), raw["vert_s"] / np.float32(255.0))
    jc, tc = _cfgs("mscmrseg", aug="light")
    raw = _raw(jc, 32)
    got = make_device_preprocess(tc, True, True, device="cpu")(torch.Generator().manual_seed(0), raw)
    np.testing.assert_array_equal(got["vert_s"].numpy(), raw["vert_s"] / np.float32(255.0))


@pytest.mark.parametrize("aug", ["heavy", "aug2"])
def test_unported_pipelines_raise(aug):
    _, tcfg = _cfgs("mscmrseg", aug=aug)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_device_preprocess(tcfg, True, True, device="cpu")
    make_device_preprocess(tcfg, True, False, device="cpu")  # no device augmentation asked: fine


def test_preprocess_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_preprocess(_cfgs("mmwhs")[1], True, True)
