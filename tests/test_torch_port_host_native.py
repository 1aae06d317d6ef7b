"""The port's host library (``pointcloududa_torch/utils/host_native.py`` over
``pointcloududa_torch/csrc/pcuda_host.cpp``) against the JAX package's
(``pointcloududa_tpu/utils/native.py`` over ``csrc/pcuda_host.cpp``) and
against plain numpy, bit for bit: farthest-point sampling on uniform and on
integer-grid (tie-heavy) points, the boundary voxels of random, full and
empty slabs, the largest component with equal-sized rivals and an absent
label, and whole clouds with a seed and with numpy's global generator seeded
alike. The library is built by g++ under the repository's ``build/``, and a
source that does not compile raises: nothing falls back to numpy.
"""

import os
import time

import numpy as np
import pytest
from scipy import ndimage

from pointcloududa_tpu.data import pointcloud as ref_pc
from pointcloududa_tpu.utils import native as ref_native
from pointcloududa_torch.data import pointcloud as pc
from pointcloududa_torch.data.synthetic import synthetic_blob_masks
from pointcloududa_torch.utils import host_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    """The JAX package's binding builds its library next to its source at
    first use, without a lock, and gives up for the process on a failed
    load: another test process may be writing the file. Load it again for
    a while before calling it missing."""
    for _ in range(120):
        if ref_native.available():
            return
        ref_native._tried = False
        time.sleep(0.5)
    pytest.fail("the JAX package's host library did not load")


def test_the_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "csrc", "pcuda_host.cpp"), "rb") as a, open(host_native.SOURCE, "rb") as b:
        assert a.read() == b.read()
    assert host_native.SOURCE == os.path.join(ROOT, "pointcloududa_torch", "csrc", "pcuda_host.cpp")


def test_the_library_is_built_under_build_and_is_not_the_jax_packages():
    lib = host_native.load()
    path = host_native.library_path()
    assert path.startswith(os.path.join(ROOT, "build", "pointcloududa_torch") + os.sep) and os.path.isfile(path)
    assert lib._name == path and os.path.realpath(path) != os.path.realpath(ref_native._LIB_PATH)


def _points(kind, rng):
    if kind == "uniform":
        return rng.uniform(-50, 50, size=(700, 3))
    # integer grid with repeats: many equal distances, so every pick is a tie broken on the first maximum
    return rng.integers(0, 6, size=(900, 3)).astype(np.float64)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("k,start", [(300, 0), (64, 511), (1, 17)])
def test_fps_equals_the_jax_library_and_numpy(kind, k, start):
    pts = _points(kind, np.random.default_rng(k + start))
    got = host_native.fps(pts, k, start)
    np.testing.assert_array_equal(got, ref_native.fps(pts, k, start))
    # the numpy versions draw their own start: hand them this one through a seed that gives it
    seed = next(s for s in range(10_000) if np.random.default_rng(s).integers(len(pts)) == start)
    np.testing.assert_array_equal(got, pc.farthest_point_sampling_plain(pts, k, seed=seed))
    np.testing.assert_array_equal(got, pc.farthest_point_sampling(pts, k, seed=seed))


def test_fps_of_no_points_is_zero():
    empty = np.zeros((0, 3))
    for fn in (pc.farthest_point_sampling, pc.farthest_point_sampling_plain, ref_pc.farthest_point_sampling):
        out = fn(empty, 300, seed=0)
        assert out.shape == (300, 3) and not out.any()


def _slab(kind, rng):
    if kind == "random":
        return (ndimage.gaussian_filter(rng.normal(size=(3, 40, 52)), 2) > 0).astype(np.uint8)
    return np.full((3, 17, 9), 1 if kind == "full" else 0, np.uint8)


@pytest.mark.parametrize("kind", ["random", "full", "empty"])
def test_boundary_voxels_equal_the_jax_library_and_numpy_in_c_order(kind):
    slab = _slab(kind, np.random.default_rng(1))
    got = host_native.boundary_voxels(slab)
    assert got.dtype == np.int64 and got.shape[1] == 3
    np.testing.assert_array_equal(got, ref_native.boundary_voxels(slab))
    np.testing.assert_array_equal(got, pc.boundary_voxels_plain(slab))
    np.testing.assert_array_equal(got, pc.boundary_voxels(slab))
    assert (len(got) == 0) == (kind == "empty")


def _largest_component_plain(mask, label):
    """scipy's 6-connected labelling; of blobs of the largest size, the one
    whose last voxel comes first in C order (the library counts voxels in C
    order and keeps the first blob to reach the largest count)."""
    labels, n = ndimage.label(np.asarray(mask) == label)
    out = np.zeros(np.shape(mask), np.uint8)
    if n == 0:
        return out
    sizes = np.bincount(labels.ravel())[1:]
    flat = labels.ravel()
    last = np.array([np.flatnonzero(flat == i + 1)[-1] for i in range(n)])
    best = min(np.flatnonzero(sizes == sizes.max()), key=lambda i: last[i])
    out[labels == best + 1] = 1
    return out


@pytest.mark.parametrize("case", ["random3d", "tie2d", "absent"])
def test_largest_component_equals_the_jax_library_and_scipy(case):
    rng = np.random.default_rng(2)
    if case == "random3d":
        mask = rng.integers(0, 3, size=(4, 20, 24)).astype(np.int32)
        label = 1
    else:
        mask = np.zeros((16, 16), np.int32)
        mask[1:4, 1:4] = 2  # two blobs of 9 voxels: the one completed first in C order is kept
        mask[10:13, 5:8] = 2
        mask[6, 12:15] = 2
        label = 2 if case == "tie2d" else 7
    got = host_native.largest_component(mask, label)
    assert got.dtype == np.uint8 and got.shape == mask.shape
    np.testing.assert_array_equal(got, ref_native.largest_component(mask, label))
    np.testing.assert_array_equal(got, _largest_component_plain(mask, label))
    assert got.any() == (case != "absent")


@pytest.mark.parametrize("seed", [None, 11])
def test_mask_to_point_cloud_equals_the_jax_package_and_numpy(seed):
    masks = list(synthetic_blob_masks(4, 96, seed=4))
    small = np.zeros((96, 96), np.uint8)
    small[10:16, 10:19] = 1  # 54 pixels: just above the threshold, fewer boundary voxels than points
    masks += [small, np.zeros((96, 96), np.uint8)]
    for mask in masks:
        np.random.seed(5)
        got = pc.mask_to_point_cloud(mask, seed=seed)
        np.random.seed(5)
        want = ref_pc.mask_to_point_cloud(mask, seed=seed)
        np.random.seed(5)
        binary = (mask > 0).astype(np.uint8)
        plain = np.zeros((300, 3))
        if binary.sum() > 50:
            pts = pc.boundary_voxels_plain(np.stack([binary] * 3)).astype(np.float64)
            plain = np.asarray(pc.farthest_point_sampling_plain(pts, 300, seed=seed), np.int64).astype(np.float64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
    assert not pc.mask_to_point_cloud(masks[-1]).any()


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "pcuda_host.cpp"
    bad.write_text('extern "C" int pcuda_fps( {\n')
    monkeypatch.setattr(host_native, "SOURCE", str(bad))
    monkeypatch.setattr(host_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        host_native.fps(np.ones((4, 3)), 2, 0)
    assert "error" in str(err.value) and "pcuda_host.cpp" in str(err.value)
    mask = np.zeros((32, 32), np.uint8)
    mask[4:20, 4:20] = 1
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):  # no numpy fallback behind the cloud either
        pc.mask_to_point_cloud(mask, seed=0)
    assert not os.listdir(tmp_path / "build") or all(not f.endswith(".so") for f in os.listdir(tmp_path / "build"))
