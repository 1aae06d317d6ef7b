"""The port's data layer (``pointcloududa_torch/data``, ``parallel.pad_batch``)
against the JAX package's: samplers, index sharding, batch padding and the
raw host batches of both `build_*_pipelines` on fabricated mini datasets.

Everything here is integer bookkeeping and file decoding in numpy, so every
comparison is exact (``assert_array_equal``, equal dtypes): no tolerance.
The mini datasets are made from a seed with numpy in the directory contracts
of ``data/mmwhs.py`` and ``data/mscmrseg.py``; ``make_mmwhs_dataset`` and
``make_mscmrseg_dataset`` also serve the trainer and CLI tests.
"""

import os
import threading

import numpy as np
import pytest
import torch

from pointcloududa_tpu.config import mmwhs_default as ref_mmwhs_default
from pointcloududa_tpu.config import mscmrseg_default as ref_mscmrseg_default
from pointcloududa_tpu.data import build as ref_build
from pointcloududa_tpu.data import loader as ref_loader
from pointcloududa_tpu.data.sampler import RingSampler as RefRingSampler
from pointcloududa_tpu.parallel import pad_batch as ref_pad_batch
from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
from pointcloududa_torch.data import build, loader
from pointcloududa_torch.data.sampler import RingSampler
from pointcloududa_torch.parallel import pad_batch
from test_torch_port_step import one_torch_thread  # noqa: F401


def make_mmwhs_dataset(root, size=32, n=6, seed=0):
    """``n`` slices per split under ``root`` in the MM-WHS contract; returns ``str(root)``."""
    rng = np.random.default_rng(seed)
    for split in ("mr_train", "mr_val", "ct_train", "ct_val"):
        base = os.path.join(root, "PnpAda_release_data", split)
        for sub in ("img", "mask", "vertices"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        ids = []
        for i in range(n):
            _id = f"{split}_slice{i}.tfrecords"
            ids.append(_id)
            np.save(os.path.join(base, "img", f"{_id}.npy"), rng.normal(size=(size, size, 3)).astype(np.float32))
            m = np.zeros((size, size, 1), np.uint8)
            lo, hi = size // 5, size - size // 5
            m[lo:hi, lo:hi] = rng.integers(1, 5)
            m[size // 3 : size // 2, size // 3 : size // 2] = rng.integers(1, 5)
            np.save(os.path.join(base, "mask", f"{_id}.npy"), m)
            np.save(os.path.join(base, "vertices", f"{_id}.npy"), rng.integers(0, size, (300, 3)).astype(np.float64))
        with open(os.path.join(root, f"{split}_list.csv"), "w") as f:
            f.write("img\n" + "\n".join(ids) + "\n")
    return str(root)


def make_mscmrseg_dataset(root, size=64, n=6, seed=0):
    """``n`` PNG slices per split under ``root`` in the MS-CMRSeg contract; returns ``str(root)``."""
    import cv2

    rng = np.random.default_rng(seed)
    for split, img_dir, mask_dir, vert_dir, csv in (
        ("trainA", "processed/trainA", "processed/trainAmask", "vertices/trainA", "aug_trainA.csv"),
        ("trainB", "processed/trainB", "processed/trainBmask", "vertices/trainB", "aug_trainB.csv"),
        ("testA", "processed/testA", "processed/testAmask", "vertices/testA", "testA.csv"),
        ("testB", "processed/trainB_orig", "processed/trainBmask_orig", "vertices/trainB_orig", "testB.csv"),
    ):
        for d in (img_dir, mask_dir, vert_dir):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        ids = []
        for i in range(n):
            _id = f"{split}_img_{i}"
            ids.append(_id)
            mask = np.zeros((size, size), np.uint8)
            q = size // 16
            mask[5 * q : 10 * q, 5 * q : 10 * q] = 85
            mask[6 * q : 9 * q, 6 * q : 9 * q] = 212
            mask[7 * q : 8 * q, 7 * q : 8 * q] = 255
            cv2.imwrite(os.path.join(root, img_dir, f"{_id}.png"), rng.integers(0, 255, size=(size, size, 3)).astype(np.uint8))
            cv2.imwrite(os.path.join(root, mask_dir, f"{_id}.png"), mask)
            np.save(os.path.join(root, vert_dir, f"{_id}.npy"), rng.integers(0, size, size=(300, 3)))
        with open(os.path.join(root, csv), "w") as f:
            f.write("img\n" + "\n".join(ids) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def mmwhs_root(tmp_path_factory):
    return make_mmwhs_dataset(tmp_path_factory.mktemp("mmwhs_mini"))


@pytest.fixture(scope="module")
def mscmrseg_root(tmp_path_factory):
    return make_mscmrseg_dataset(tmp_path_factory.mktemp("mscmrseg_mini"))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys in the same order
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize(
    "n_items,bs,ns,seed",
    [(10, 4, 6, 0), (7, 3, -1, 1), (5, 4, 11, None), (6, 2, 6, 3), (3, 8, 20, 2)],
    ids=["truncated-tail", "one-pass", "unshuffled-wraps-twice", "even", "batch-larger-than-data"],
)
def test_ring_sampler_sequences_equal_the_jax_package(n_items, bs, ns, seed):
    """Three epochs of index batches, the cursor carried from one to the
    next, the last batch of an epoch truncated where ``ns`` ends mid-batch."""
    got, want = RingSampler(n_items, bs, ns, seed), RefRingSampler(n_items, bs, ns, seed)
    assert len(got) == len(want) and got.steps_per_epoch == want.steps_per_epoch
    for _ in range(3):
        a, b = list(got.epoch()), list(want.epoch())
        assert a == b and all(isinstance(i, int) for batch in a for i in batch)
    if ns == 6 and bs == 4:
        assert [len(x) for x in a] == [4, 2]


def test_ring_sampler_state_restores_the_stream():
    a = RingSampler(9, 4, 10, shuffle_seed=5)
    list(a.epoch())
    state = a.state()
    b = RingSampler(9, 4, 10, shuffle_seed=77)  # another order and cursor until restored
    b.restore(state)
    assert list(a.epoch()) == list(b.epoch())
    ref = RefRingSampler(9, 4, 10, shuffle_seed=5)
    list(ref.epoch())
    assert state["cursor"] == ref.state()["cursor"]
    np.testing.assert_array_equal(state["order"], ref.state()["order"])
    with pytest.raises(ValueError):
        RingSampler(0, 4)


@pytest.mark.parametrize("idx,lo,hi,target", [([5, 1, 7], 0, 2, 4), ([5, 1, 7], 2, 4, 4), ([3, 2, 9, 4], 1, 3, 4), ([8], 0, 8, 8)])
def test_shard_index_batch_equals_the_jax_package(idx, lo, hi, target):
    got, want = loader.shard_index_batch(idx, lo, hi, target), ref_loader.shard_index_batch(idx, lo, hi, target)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _raw(n, seed, with_mask=False):
    rng = np.random.default_rng(seed)
    raw = {"img": rng.normal(size=(n, 4, 4, 3)).astype(np.float32), "mask": rng.integers(0, 5, (n, 4, 4)).astype(np.int32)}
    if with_mask:
        raw["sample_mask"] = (np.arange(n) % 2).astype(np.float32)
    return raw


@pytest.mark.parametrize("n,multiple,target,with_mask", [(3, 4, 0, False), (4, 4, 0, False), (2, 1, 4, False), (5, 2, 8, True), (3, 1, 0, False)])
def test_pad_batch_equals_the_jax_package(n, multiple, target, with_mask):
    raw = _raw(n, n, with_mask)
    got, want = pad_batch(raw, multiple, target), ref_pad_batch(raw, multiple, target)
    _same_batches([got], [want])
    if n in (4, 3) and target == 0 and multiple in (1, 4) and n % multiple == 0:
        assert got is raw  # nothing to pad: the batch itself, no mask attached


def test_batch_padder_equals_the_jax_package():
    """The padder remembers its stream's largest batch: the tail after a full
    batch is wrap-padded and masked; a short first batch is not."""
    sizes = [2, 4, 4, 2, 3]
    ours, theirs = loader.BatchPadder(1), ref_loader.BatchPadder(1)
    got = [ours(_raw(n, i)) for i, n in enumerate(sizes)]
    want = [theirs(_raw(n, i)) for i, n in enumerate(sizes)]
    _same_batches(got, want)
    assert "sample_mask" not in got[0] and got[3]["sample_mask"].tolist() == [1, 1, 0, 0]
    np.testing.assert_array_equal(got[3]["img"][2:], got[3]["img"][:2])


MMWHS_CASES = {
    "light-aug-point-head": dict(d4=True, aug="light"),
    "no-aug-point-head": dict(d4aux=True, aug=""),
    "no-point-head": dict(d2=True, aug=""),
    "histogram-matching": dict(d4=True, aug="", mh=True),
}


@pytest.mark.parametrize("case", list(MMWHS_CASES))
def test_mmwhs_raw_batches_equal_the_jax_package(mmwhs_root, case):
    """Two epochs of raw train batches (6 samples in batches of 4: a full
    batch and a tail of 2, the ring cursor carried over) and one pass of each
    validation stream, from each package's own `build_mmwhs_pipelines`."""
    kw = dict(bs=4, ns=6, data_dir=mmwhs_root, crop_size=32, **MMWHS_CASES[case])
    got_train, got_val, got_flag = build.build_mmwhs_pipelines(mmwhs_default(**kw), workers=2)
    want_train, want_val, want_flag = ref_build.build_mmwhs_pipelines(ref_mmwhs_default(**kw), workers=2)
    assert got_flag is want_flag is True and got_train.steps_per_epoch == want_train.steps_per_epoch == 2
    for _ in range(2):
        _same_batches(got_train.epoch(), want_train.epoch())
    for name in ("val", "val_lge", "test_lge"):
        _same_batches(got_val[name](), want_val[name]())
    first = next(iter(got_train.epoch()))
    if case == "light-aug-point-head":  # masks ride along for the device's cloud regeneration; no stored clouds
        assert "mask_t" in first and "vert_s" not in first and first["img_s"].dtype == np.float32
    if case == "no-aug-point-head":
        assert first["vert_s"].shape == (4, 300, 3) and first["vert_s"].dtype == np.float32


def test_mmwhs_row_sharded_batches_equal_the_jax_package(mmwhs_root):
    """``row_shard`` is kept: the second of two processes' rows of a global
    batch of 4, with the ``sample_mask`` of the wrap-padded tail."""
    kw = dict(bs=4, ns=6, data_dir=mmwhs_root, crop_size=32, d4aux=True)
    got_train, got_val, _ = build.build_mmwhs_pipelines(mmwhs_default(**kw), workers=0, row_shard=(2, 4, 4))
    want_train, want_val, _ = ref_build.build_mmwhs_pipelines(ref_mmwhs_default(**kw), workers=0, row_shard=(2, 4, 4))
    batches = list(got_train.epoch())
    _same_batches(batches, want_train.epoch())
    assert batches[0]["sample_mask"].tolist() == [1, 1] and batches[1]["sample_mask"].tolist() == [0, 0]
    _same_batches(got_val["val"](), want_val["val"]())


@pytest.mark.parametrize("point_head", [True, False], ids=["point-head", "no-point-head"])
def test_mscmrseg_raw_batches_equal_the_jax_package(mscmrseg_root, point_head):
    kw = dict(bs=4, ns=6, data_dir=mscmrseg_root, d4=point_head, d2=True)
    got_train, got_val = build.build_mscmrseg_pipelines(mscmrseg_default(**kw), workers=2)
    want_train, want_val = ref_build.build_mscmrseg_pipelines(ref_mscmrseg_default(**kw), workers=2)
    for _ in range(2):
        _same_batches(got_train.epoch(), want_train.epoch())
    for name in ("val", "val_lge", "test_lge"):
        _same_batches(got_val[name](), want_val[name]())
    first = next(iter(got_train.epoch()))
    assert first["img_s"].dtype == np.uint8 and set(np.unique(first["mask_s"])) <= {0, 1, 2, 3}
    assert ("vert_s" in first) is point_head


@pytest.mark.parametrize(
    "call",
    [
        lambda root: build.build_mmwhs_pipelines(mmwhs_default(data_dir=root, aug="light"), host_cloud_regen=True),
        lambda root: build.build_mmwhs_pipelines(mmwhs_default(data_dir=root, aug="light"), device_augment=False),
        lambda root: build.build_mscmrseg_pipelines(mscmrseg_default(data_dir=root), device_augment=False),
        lambda root: loader.BatchAssembler(None, host_augment=lambda imgs, masks, rng: (imgs, masks)),
        lambda root: loader.BatchAssembler(None, regen_vertices=True),
    ],
    ids=["mmwhs-host-cloud-regen", "mmwhs-host-aug", "mscmrseg-host-aug", "assembler-host-augment", "assembler-regen"],
)
def test_host_pipelines_are_refused_by_name(mmwhs_root, call):
    """The host augmentation route is not ported: asking for it raises at
    construction and names the ROADMAP items."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 items 9 and 10"):
        call(mmwhs_root)


def test_missing_datalist_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        build.build_mmwhs_pipelines(mmwhs_default(data_dir=str(tmp_path)))


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetcher_keeps_order(depth):
    """Batches come out in the order they went in, each through ``place``,
    which runs in another thread than the consumer."""
    threads = set()

    def place(batch):
        threads.add(threading.get_ident())
        return loader.to_device(batch, "cpu")

    items = [{"x": np.full((2, 3), i, np.float32)} for i in range(7)]
    out = list(loader.DevicePrefetcher(place, depth=depth, device="cpu")(iter(items)))
    assert [int(b["x"][0, 0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    assert threads and threading.get_ident() not in threads
    assert list(loader.DevicePrefetcher(place, depth=depth)(iter([]))) == []


def test_device_prefetcher_reraises_the_feeders_exception():
    """What was placed before the failure still arrives, in order; then the
    consumer gets the feeder's exception, as with the JAX package's."""

    def source():
        yield {"x": np.zeros(1)}
        yield {"x": np.ones(1)}
        raise FileNotFoundError("slice 3 is missing")

    for prefetcher in (loader.DevicePrefetcher(lambda b: b, depth=2, device="cpu"), ref_loader.DevicePrefetcher(lambda b: b, depth=2)):
        seen = []
        with pytest.raises(FileNotFoundError, match="slice 3"):
            for b in prefetcher(source()):
                seen.append(float(b["x"][0]))
        assert seen == [0.0, 1.0]

    def bad_place(batch):
        raise RuntimeError("copy failed")

    with pytest.raises(RuntimeError, match="copy failed"):
        list(loader.DevicePrefetcher(bad_place, device="cpu")(iter([{"x": np.zeros(1)}])))


def test_placed_tensors_pass_through_the_device_preprocess_untouched():
    """``to_device`` copies arrays and hands tensors that are already on the
    device on as they are, so what a prefetcher placed is not copied again by
    ``make_device_preprocess``."""
    from pointcloududa_torch.train.loop import make_device_preprocess

    raw = {"img": np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32), "mask": np.ones((2, 8, 8), np.int32)}
    placed = loader.to_device(raw, "cpu")
    again = loader.to_device(placed, torch.device("cpu"))
    assert all(again[k] is placed[k] for k in placed)
    out = make_device_preprocess(mmwhs_default(crop_size=8), train=False, device_augment=False, device="cpu")(placed)
    assert out["img"].data_ptr() == placed["img"].data_ptr()  # float32, no crop: the very tensor
    np.testing.assert_array_equal(out["img"].numpy(), raw["img"])
