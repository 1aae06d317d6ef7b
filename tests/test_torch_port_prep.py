"""The port's offline data layer (``pointcloududa_torch/prep/``) against the
repository's ``tools/`` scripts it counts as its counterpart: on one
fabricated raw tree, each tool and its port counterpart write into two
directories, and the files must be equal. PNGs are compared decoded by
``cv2.imread`` (the tools write them with OpenCV, the port with
``utils/png.py``: the bytes differ, the images may not); ``.npy`` and CSV
files are compared byte for byte. Then the runbooks: ``--print-only`` lists
the tools' stages with the module names mapped and the argv unchanged, and
``--check`` runs each whole chain on the CPU.

Raw trees: int16 NIfTI volumes made with numpy from a seed (written with the
port's ``save_nii``, which the JAX package's reads alike), and TFRecords
written by the JAX package's writer. Nothing here compiles JAX: the tools
import none of it.
"""

import filecmp
import importlib
import os
import shutil

import cv2
import numpy as np
import pytest

from pointcloududa_torch.prep import create_datalist, make_pointclouds, prepare_mmwhs, prepare_mscmrseg
from pointcloududa_torch.prep import reproduce, reproduce_mmwhs
from pointcloududa_torch.utils.nifti import save_nii


def _tool(name):
    return importlib.import_module(f"tools.{name}")


# raw MS-CMRSeg patients: (X, Y, Z) as the nii stores them; 1 takes no resize,
# 2 the nearest resize from a canvas that is neither 256 nor square
RAW_SHAPES = {1: (256, 256, 2), 2: (300, 280, 2)}
RAW_LABELS = np.array([0, 200, 500, 600], np.int16)


def _blob_labels(shape, rng):
    """(X, Y, Z) labels in the raw values: three nested boxes, placed from
    ``rng``, large enough that every slice's mask gives a cloud."""
    x, y, z = shape
    out = np.zeros(shape, np.int16)
    for k, frac in ((1, 0.35), (2, 0.22), (3, 0.12)):
        hx, hy = int(x * frac / 2), int(y * frac / 2)
        cx, cy = x // 2 + int(rng.integers(-8, 9)), y // 2 + int(rng.integers(-8, 9))
        out[cx - hx:cx + hx, cy - hy:cy + hy, :] = RAW_LABELS[k]
    return out


@pytest.fixture(scope="module")
def raw_mscmrseg(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw_mscmrseg")
    rng = np.random.default_rng(0)
    d = lambda *p: os.path.join(root, "raw_data", *p)  # noqa: E731
    for sub in ("dataset", "labels", os.path.join("labels", "lge_test_gt")):
        os.makedirs(d(sub), exist_ok=True)
    for pat, shape in RAW_SHAPES.items():
        labels = _blob_labels(shape, rng)
        img = (rng.normal(300.0, 80.0, shape) + 0.5 * labels).astype(np.int16)
        save_nii(d("dataset", f"patient{pat}_C0.nii.gz"), img)
        save_nii(d("dataset", f"patient{pat}_LGE.nii.gz"), img[::-1].copy())
        save_nii(d("labels", f"patient{pat}_C0_manual.nii.gz"), labels)
        save_nii(d("labels", "lge_test_gt", f"patient{pat}_LGE_manual.nii.gz"), labels[::-1].copy())
    return str(root)


def _same_pngs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        if name.endswith(".png"):
            x = cv2.imread(os.path.join(a, name), cv2.IMREAD_UNCHANGED)
            y = cv2.imread(os.path.join(b, name), cv2.IMREAD_UNCHANGED)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    return names


def _same_bytes(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name
    return names


@pytest.mark.parametrize(
    "modality,labels",
    [("bssfp", ""), ("bssfp", "labels"), ("lge", ""), ("lge", "lge_test_gt")],
)
def test_png_chain_equals_the_tools(raw_mscmrseg, tmp_path, modality, labels):
    """NIfTI -> rescale -> nearest resize where the side is not 256 -> crop ->
    CLAHE on images: the same slices, decoded, as the tool's."""
    argv = ["png", "--modality", modality, "--input", raw_mscmrseg, "--pat", "1", "3"]
    if labels:
        argv += ["--labels"] + (["--labels-subdir", labels] if labels != "labels" else [])
    _tool("prepare_mscmrseg").main(argv + ["--out", str(tmp_path / "tool")])
    prepare_mscmrseg.main(argv + ["--out", str(tmp_path / "port")])
    names = _same_pngs(tmp_path / "tool", tmp_path / "port")
    assert len(names) == sum(z for _, _, z in RAW_SHAPES.values())
    if labels:  # the raw label values land on the values the adapter decodes
        got = cv2.imread(str(tmp_path / "port" / names[0]), cv2.IMREAD_UNCHANGED)
        assert set(np.unique(got)) <= {0, 85, 212, 255} and len(np.unique(got)) == 4


@pytest.mark.parametrize("labels", [False, True])
def test_npy_chain_equals_the_tools_bit_for_bit(raw_mscmrseg, tmp_path, labels):
    argv = ["npy", "--modality", "lge", "--input", raw_mscmrseg, "--pat", "1", "3", "--crop", "160"]
    if labels:
        argv += ["--labels", "--labels-subdir", "lge_test_gt"]
    _tool("prepare_mscmrseg").main(argv + ["--out", str(tmp_path / "tool")])
    prepare_mscmrseg.main(argv + ["--out", str(tmp_path / "port")])
    _same_bytes(tmp_path / "tool", tmp_path / "port")


@pytest.fixture(scope="module")
def processed_mscmrseg(raw_mscmrseg, tmp_path_factory):
    """A processed split (images, masks, datalist) made by the port."""
    root = tmp_path_factory.mktemp("processed")
    for sub, extra in (("trainA", []), ("trainAmask", ["--labels"])):
        prepare_mscmrseg.main(["png", "--modality", "bssfp", "--input", raw_mscmrseg, "--pat", "1", "3",
                               "--out", str(root / "processed" / sub)] + extra)
    create_datalist.main(["--dir", str(root / "processed" / "trainA"), "--out", str(root / "aug_trainA.csv")])
    return root


def test_rotate_writes_the_tools_images_masks_vertices_and_datalist(processed_mscmrseg, tmp_path):
    runs = {}
    for who, main in (("tool", _tool("prepare_mscmrseg").main), ("port", prepare_mscmrseg.main)):
        root = tmp_path / who
        shutil.copytree(processed_mscmrseg, root)
        os.makedirs(root / "vertices")
        main(["rotate", "--csv", str(root / "aug_trainA.csv"), "--out-csv", str(root / "aug_trainA.csv"),
              "--img-dir", str(root / "processed" / "trainA"), "--mask-dir", str(root / "processed" / "trainAmask"),
              "--vert-dir", str(root / "vertices")])
        runs[who] = root
    tool, port = runs["tool"], runs["port"]
    names = _same_pngs(tool / "processed" / "trainA", port / "processed" / "trainA")
    assert sum(n.endswith(("_r1.png", "_r2.png")) for n in names) == 2 * sum(z for _, _, z in RAW_SHAPES.values())
    _same_pngs(tool / "processed" / "trainAmask", port / "processed" / "trainAmask")
    verts = _same_bytes(tool / "vertices", port / "vertices")
    assert all(np.load(port / "vertices" / v).any() for v in verts)
    assert filecmp.cmp(tool / "aug_trainA.csv", port / "aug_trainA.csv", shallow=False)
    # idempotent, as the tool: a rerun on its own datalist rotates the originals again, not the rotations
    before = open(port / "aug_trainA.csv").read()
    prepare_mscmrseg.main(["rotate", "--csv", str(port / "aug_trainA.csv"), "--out-csv", str(port / "aug_trainA.csv"),
                           "--img-dir", str(port / "processed" / "trainA"),
                           "--mask-dir", str(port / "processed" / "trainAmask")])
    assert open(port / "aug_trainA.csv").read() == before


SPLITS = ("ct_train", "ct_val", "mr_train", "mr_val")


@pytest.fixture(scope="module")
def raw_mmwhs(tmp_path_factory):
    """TFRecord slices in the release's layout, written by the JAX package's
    writer: 3 slices per split, 40^2 (the side is inferred from the payload)."""
    from pointcloududa_tpu.utils.tfrecord import write_example, write_tfrecord

    root = tmp_path_factory.mktemp("raw_mmwhs")
    rng = np.random.default_rng(1)
    for split in SPLITS:
        tf_dir = root / "PnpAda_release_data" / "train_n_val" / f"{split}_tfs"
        os.makedirs(tf_dir)
        ids = []
        for i in range(3):
            _id = f"{split}_slice{i}.tfrecords"
            lab = np.zeros((40, 40), "<f4")
            lab[8 + i:28 + i, 10:30] = 1 + i
            lab3 = np.repeat(lab[..., None], 3, axis=-1)
            img = rng.normal(size=(40, 40, 3)).astype("<f4")
            write_tfrecord(str(tf_dir / _id), [write_example({"data_vol": img.tobytes(), "label_vol": lab3.tobytes()})])
            ids.append(_id)
        (root / f"{split}_list.csv").write_text("img\n" + "\n".join(ids) + "\n")
    return root


def test_prepare_mmwhs_writes_the_tools_npys(raw_mmwhs, tmp_path):
    out = {}
    for who, main in (("tool", _tool("prepare_mmwhs").main), ("port", prepare_mmwhs.main)):
        root = tmp_path / who
        shutil.copytree(raw_mmwhs, root)
        main(["--input", str(root), "--splits", *SPLITS])
        out[who] = root / "PnpAda_release_data"
    for split in SPLITS:
        for sub in ("img", "mask"):
            _same_bytes(out["tool"] / split / sub, out["port"] / split / sub)
    img, mask = prepare_mmwhs.decode_slice(str(raw_mmwhs / "PnpAda_release_data" / "train_n_val" / "ct_val_tfs" /
                                               "ct_val_slice1.tfrecords"))
    assert img.shape == (40, 40, 3) and mask.shape == (40, 40, 1) and set(np.unique(mask)) == {0.0, 2.0}


@pytest.mark.parametrize("kind", ["npy", "png"])
@pytest.mark.parametrize("seed", ["-1", "0"])
@pytest.mark.parametrize("plots", [False, True])
def test_make_pointclouds_writes_the_tools_vertices(raw_mmwhs, processed_mscmrseg, tmp_path, kind, seed, plots):
    """``.npy`` (MM-WHS) and ``.png`` (MS-CMRSeg) masks, with ``--seed`` and
    with numpy's global generator seeded alike, with and without plots."""
    if kind == "npy":
        masks = tmp_path / "masks"
        prepare_mmwhs.main(["--input", str(shutil.copytree(raw_mmwhs, tmp_path / "raw")), "--splits", "ct_train"])
        shutil.copytree(tmp_path / "raw" / "PnpAda_release_data" / "ct_train" / "mask", masks)
    else:
        masks = processed_mscmrseg / "processed" / "trainAmask"
    for who, main in (("tool", _tool("make_pointclouds").main), ("port", make_pointclouds.main)):
        argv = ["--masks", str(masks), "--out", str(tmp_path / who / "vertices"), "--seed", seed]
        if plots:
            argv += ["--plots", str(tmp_path / who / "plots")]
        np.random.seed(3)
        main(argv)
    names = _same_bytes(tmp_path / "tool" / "vertices", tmp_path / "port" / "vertices")
    assert all(np.load(tmp_path / "port" / "vertices" / n).shape == (300, 3) for n in names)
    if plots:
        _same_bytes(tmp_path / "tool" / "plots", tmp_path / "port" / "plots")


def test_make_pointclouds_skips_existing_outputs(processed_mscmrseg, tmp_path):
    out = tmp_path / "vertices"
    argv = ["--masks", str(processed_mscmrseg / "processed" / "trainAmask"), "--out", str(out), "--seed", "0"]
    make_pointclouds.main(argv)
    names = sorted(os.listdir(out))
    np.save(out / names[0], np.zeros(1))
    os.remove(out / names[1])
    make_pointclouds.main(argv)
    assert sorted(os.listdir(out)) == names and np.load(out / names[0]).shape == (1,)
    assert np.load(out / names[1]).shape == (300, 3)


@pytest.mark.parametrize("pattern", [None, "*_1.png"])
def test_create_datalist_writes_the_tools_csv(processed_mscmrseg, tmp_path, pattern):
    for who, main in (("tool", _tool("create_datalist").main), ("port", create_datalist.main)):
        argv = ["--dir", str(processed_mscmrseg / "processed" / "trainA"), "--out", str(tmp_path / f"{who}.csv")]
        main(argv + (["--pattern", pattern] if pattern else []))
    assert filecmp.cmp(tmp_path / "tool.csv", tmp_path / "port.csv", shallow=False)
    with pytest.raises(SystemExit):
        create_datalist.main(["--dir", str(tmp_path), "--out", str(tmp_path / "none.csv"), "--pattern", "*.npy"])


# ---------------------------------------------------------------- runbooks

def _mapped(stages):
    """The tools' (name, module, argv) with their modules named as the port's."""
    def port_name(mod):
        if mod.startswith("tools."):
            return "pointcloududa_torch.prep." + mod[len("tools."):]
        assert mod.startswith("pointcloududa_tpu.cli."), mod
        return "pointcloududa_torch.cli." + mod[len("pointcloududa_tpu.cli."):]

    return [(name, port_name(mod), argv) for name, mod, argv in stages]


@pytest.mark.parametrize(
    "kw",
    [{}, dict(pats=(1, 4), val_pats=(3, 4), eval_pats=(1, 4), crop=32, train_args=["-aug2", "-d1", "-d2", "-d4"], epochs=2)],
)
def test_mscmrseg_stages_are_the_tools(kw):
    want = _mapped(_tool("reproduce").build_stages("/data", "/w", **kw))
    got = reproduce.build_stages("/data", "/w", **kw)
    assert got == want and len(got) == 20


@pytest.mark.parametrize("kw", [{}, dict(train_args=["-bs", "16", "-d2", "-d4", "-softmax"], pat_ids=[1003, 1008])])
def test_mmwhs_stages_are_the_tools(kw):
    want = _mapped(_tool("reproduce_mmwhs").build_stages("/data", "/w", **kw))
    got = reproduce_mmwhs.build_stages("/data", "/w", **kw)
    assert got == want and len(got) == 7


@pytest.mark.parametrize("runbook", ["reproduce", "reproduce_mmwhs"])
@pytest.mark.parametrize("extra", [[], ["--stage", "pointclouds"], ["--train-args", "-aug2 -d1 -d2 -d4", "--stage", "train"]])
def test_print_only_prints_the_tools_commands(capsys, runbook, extra):
    argv = ["--print-only", "--data-root", "/data", "--workdir", "/w", *extra]
    _tool(runbook).main(argv)
    want = capsys.readouterr().out.replace("python -m tools.", "python -m pointcloududa_torch.prep.")
    want = want.replace("python -m pointcloududa_tpu.cli.", "python -m pointcloududa_torch.cli.")
    getattr(reproduce if runbook == "reproduce" else reproduce_mmwhs, "main")(argv)
    got = capsys.readouterr().out
    assert got == want and got.count("== [") >= 1


@pytest.mark.parametrize("runbook", [reproduce, reproduce_mmwhs], ids=["mscmrseg", "mmwhs"])
def test_runbook_check_runs_on_the_cpu(runbook, capsys):
    """The whole chain on a fabricated mini dataset, its train and evaluate
    stages on the CPU, with the tools' artifact assertions."""
    runbook.main(["--check"], device="cpu")
    out = capsys.readouterr().out
    assert "--check OK: all " in out and f"all {20 if runbook is reproduce else 7} stages ran" in out


def test_runbooks_find_the_newest_best_checkpoint(tmp_path):
    from pointcloududa_torch.prep.runbook import find_best_checkpoint, parse_train_args

    for i, name in enumerate(("best_a.Scr0.9", "best_b.Scr0.10", "unet_model_checkpoint_c")):
        (tmp_path / name).write_text("")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    assert find_best_checkpoint(str(tmp_path)) == str(tmp_path / "best_b.Scr0.10")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit):
        find_best_checkpoint(str(tmp_path / "empty"))
    assert parse_train_args("-aug2 -d1 '-apdx' x", ["-d1"]) == ["-aug2", "-d1", "-apdx", "x"]
    assert parse_train_args(None, ["-d1"]) == ["-d1"]
