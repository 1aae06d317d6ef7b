"""Turnkey MS-CMRSeg reproduction runbook: raw download -> prep -> train ->
evaluate -> paper table (the port's counterpart of the repository's
``tools/reproduce.py``: the same stages and argv, with ``tools.X`` ->
``pointcloududa_torch.prep.X`` and the JAX package's CLIs ->
``pointcloududa_torch.cli.*``; the train and evaluate stages run on the card
unless ``main(argv, device="cpu")`` is called from Python).

  python -m pointcloududa_torch.prep.reproduce --data-root <root> \
      [--train-args '-aug2 -d1 -d2 -d4'] [--stage S] [--print-only] [--check]

The reference publishes its headline quality numbers as a Dice table
(BASELINE.md; the reference's ``src/evaluate_mscmrseg.py:249-256``) but no
end-to-end recipe. This script IS that recipe: run it
with ``--data-root`` pointing at the raw MS-CMRSeg 2019 download and it
executes every stage in order; run any single stage with ``--stage``; run
``--print-only`` to see the exact commands; run ``--check`` (no data needed)
to dry-run the complete chain end-to-end on a fabricated mini dataset.

Expected raw layout under --data-root (the reference's, SURVEY.md §3.5):
  raw_data/dataset/patient{1..45}_C0.nii.gz       bSSFP images (source)
  raw_data/dataset/patient{1..45}_LGE.nii.gz      LGE images (target)
  raw_data/labels/patient{1..45}_C0_manual.nii.gz bSSFP labels
  raw_data/labels/lge_test_gt/patient{6..45}_LGE_manual.nii.gz  LGE GT
                                                  (evaluation only)

Split conventions (the reference ships only the resulting csvs, not the
splitter; these reproduce their sizes): source train = bSSFP patients
1..40, source val (testA) = 41..45; target train (trainB) = LGE 6..45
(the patients with lge_test_gt masks — the adapter needs mask/vertex
files per id, and the masks feed only the logged chamfer metric / vertex
GT, never a training loss, so the UDA setting is preserved); target val
(testB) = LGE 41..45; final evaluation = LGE 6..45 vs lge_test_gt.

Paper hyperparameters (reference ``src/README.md:4,30-37``):
  train: -aug2 -bs 16 -ns 2000 -e 400 -d1 -d2 -d4 (the D1+D2 row of the
  BASELINE table uses heavy aug instead: no -aug2, -d1 -d2).

Expected result (BASELINE.md): val-LGE Dice 0.834 (heavy aug, no UDA),
0.845 (+D2), 0.849 (+D1+D2), 0.822 (+D1+D2+D4, aug2).
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np

from pointcloududa_torch.prep.runbook import drive, find_best_checkpoint, parse_train_args


PREP, CLI = "pointcloududa_torch.prep.", "pointcloududa_torch.cli."


def build_stages(root: str, workdir: str, *, pats=(1, 46), val_pats=(41, 46),
                 eval_pats=(6, 46), crop: int = 224, train_args=None,
                 epochs: int = 400):
    """The full command chain as (name, module, argv) triples: the
    repository's ``tools/reproduce.py`` stages with the port's modules."""
    d = lambda *p: os.path.join(root, *p)  # noqa: E731
    t = train_args or ["-d1", "-d2"]
    lo, hi = pats
    vlo, vhi = val_pats
    stages = []

    def prep(modality, out, labels=False, labels_subdir="", pat=pats):
        argv = ["png", "--modality", modality, "--input", root,
                "--out", d("processed", out), "--pat", str(pat[0]), str(pat[1]),
                "--crop", str(crop)]
        if labels:
            argv += ["--labels"]
            if labels_subdir:
                argv += ["--labels-subdir", labels_subdir]
        return ("prep:" + out, PREP + "prepare_mscmrseg", argv)

    # 1. NIfTI -> per-slice PNGs (images + decodable {0,85,212,255} masks)
    stages += [
        prep("bssfp", "trainA", pat=(lo, vlo)),
        prep("bssfp", "trainAmask", labels=True, pat=(lo, vlo)),
        prep("bssfp", "testA", pat=(vlo, vhi)),
        prep("bssfp", "testAmask", labels=True, pat=(vlo, vhi)),
        # target-train = the LGE patients with lge_test_gt masks (eval_pats;
        # the masks feed only the logged chamfer metric / vertex GT, never a
        # loss). The adapter requires mask+vertex files for every trainB id,
        # so images and masks must cover the SAME patient range; target-val
        # (testB, trainB_orig dirs) is the val_pats slice of that range.
        prep("lge", "trainB", pat=eval_pats),
        prep("lge", "trainBmask", labels=True, labels_subdir="lge_test_gt",
             pat=eval_pats),
        # target-valid ("testB" csv) lives in trainB_orig dirs — the
        # adapter's directory contract (data/mscmrseg.py:55-61)
        prep("lge", "trainB_orig", pat=(vlo, vhi)),
        prep("lge", "trainBmask_orig", labels=True, labels_subdir="lge_test_gt",
             pat=(vlo, vhi)),
    ]
    # (csv name, image dir, mask dir) per the adapter's directory contract
    # (data/mscmrseg.py:55-61) — note trainB_orig's mask dir is
    # trainBmask_orig, not trainB_origmask
    splits = (("aug_trainA", "trainA", "trainAmask"),
              ("testA", "testA", "testAmask"),
              ("aug_trainB", "trainB", "trainBmask"),
              ("testB", "trainB_orig", "trainBmask_orig"))
    # 2. datalists
    for csv, sub, _ in splits:
        stages.append((
            f"datalist:{csv}", PREP + "create_datalist",
            ["--dir", d("processed", sub), "--out", d(csv + ".csv")],
        ))
    # 3. point-cloud GT (300x3 vertex npys from the mask PNGs)
    for _, sub, masksub in splits:
        stages.append((
            f"pointclouds:{sub}", PREP + "make_pointclouds",
            ["--masks", d("processed", masksub), "--out",
             d("vertices", sub), "--seed", "0"],
        ))
    # 4. offline rotation augmentation (_r1/_r2 ids; reference input_aug)
    for split in ("trainA", "trainB"):
        stages.append((
            f"rotate:{split}", PREP + "prepare_mscmrseg",
            ["rotate", "--csv", d(f"aug_{split}.csv"),
             "--out-csv", d(f"aug_{split}.csv"),
             "--img-dir", d("processed", split),
             "--mask-dir", d("processed", split + "mask"),
             "--vert-dir", d("vertices", split)],
        ))
    # 5. UDA training (paper hyperparameters; heavy aug is the CLI default)
    stages.append((
        "train", CLI + "train_mscmrseg",
        ["-bs", "16", "-ns", "2000", "-e", str(epochs), *t,
         "-data_dir", root, "-workdir", workdir,
         "-logdir", os.path.join(workdir, "runs")],
    ))
    # 6. evaluation (Dice/HD/ASD vs raw LGE GT, reference parity chain)
    stages.append((
        "evaluate", CLI + "evaluate_mscmrseg",
        ["-model_dir", workdir, "-from_name", "-klc",
         "-data_dir", root, "-pat_lo", str(eval_pats[0]),
         "-pat_hi", str(eval_pats[1]),
         "-csv", os.path.join(workdir, "per_patient.csv")],
    ))
    return stages


def run_stage(module: str, argv: list, workdir: str, device=None):
    """Run one stage in this process; the CLIs on ``device`` (None: the card)."""
    import importlib

    mod = importlib.import_module(module)
    if module == CLI + "evaluate_mscmrseg":
        # -from_name needs the checkpoint file, not the directory
        i = argv.index("-model_dir") + 1
        argv = list(argv)
        argv[i] = find_best_checkpoint(argv[i])
    if module.startswith(CLI):
        mod.main(argv, device=device)
    else:
        mod.main(argv)


# ---------------------------------------------------------------- --check --

def _fabricate_raw(root: str, n_pat: int = 3, size: int = 40, n_slices: int = 3):
    """Tiny raw MS-CMRSeg layout: structured fake anatomy so the label chain
    ({0,200,500,600} -> PNG {0,85,212,255} -> class ids) is exercised."""
    from pointcloududa_torch.utils.nifti import save_nii

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "raw_data", "dataset"), exist_ok=True)
    os.makedirs(os.path.join(root, "raw_data", "labels", "lge_test_gt"), exist_ok=True)
    for pat in range(1, n_pat + 1):
        img = rng.integers(0, 255, size=(size, size, n_slices)).astype(np.int16)
        gt = np.zeros((size, size, n_slices), np.int16)
        o = pat  # vary structure position per patient
        gt[10 + o:20 + o, 10:20, :] = 200
        gt[14 + o:18 + o, 12:17, :] = 500
        gt[20 + o:24 + o, 20:26, :] = 600
        d = lambda *p: os.path.join(root, "raw_data", *p)  # noqa: E731
        save_nii(d("dataset", f"patient{pat}_C0.nii.gz"), img)
        save_nii(d("dataset", f"patient{pat}_LGE.nii.gz"), img[::-1].copy())
        save_nii(d("labels", f"patient{pat}_C0_manual.nii.gz"), gt)
        save_nii(d("labels", "lge_test_gt", f"patient{pat}_LGE_manual.nii.gz"), gt)


def check(tmpdir: str, device=None):
    """Dry-run the COMPLETE chain on fabricated data with a shrunken model,
    its train and evaluate stages on ``device``. Asserts every stage's
    artifacts; finishes in seconds on the CPU."""
    import pointcloududa_torch.config as config_mod

    crop = 32
    root = os.path.join(tmpdir, "input_aug")
    workdir = os.path.join(tmpdir, "weights")
    _fabricate_raw(root)

    # shrink the model the same way the test-suite fixtures do: the CLIs
    # resolve their config through config.mscmrseg_default at call time
    real = config_mod.mscmrseg_default
    tiny = dict(filters=4, n_block=2, crop_size=crop, fc_inch=0)

    def tiny_default(**kw):
        kw.update(tiny)
        return real(**kw)

    config_mod.mscmrseg_default = tiny_default
    try:
        stages = build_stages(
            root, workdir, pats=(1, 4), val_pats=(3, 4), eval_pats=(1, 4),
            crop=crop, train_args=["-d1", "-d2", "-aug"], epochs=1)
        # shrink the schedule
        for name, mod, argv in stages:
            if name == "train":
                for flag, v in (("-bs", "2"), ("-ns", "4"), ("-dtype", "float32"),
                                ("-workers", "0")):
                    if flag in argv:
                        argv[argv.index(flag) + 1] = v
                    else:
                        argv += [flag, v]
            if name == "evaluate":
                argv += ["-nf", "4", "-dtype", "float32", "-bs", "2"]
            print(f"== [{name}] python -m {mod} " + " ".join(argv), flush=True)
            run_stage(mod, argv, workdir, device=device)
        # artifact assertions
        expect = [
            os.path.join(root, "processed", "trainA", "pat_1_bSSFP_0.png"),
            os.path.join(root, "processed", "trainBmask", "pat_1_lge_0.png"),
            os.path.join(root, "aug_trainA.csv"),
            os.path.join(root, "vertices", "trainB", "pat_1_lge_0.npy"),
            os.path.join(root, "processed", "trainA", "pat_1_bSSFP_0_r1.png"),
            os.path.join(workdir, "per_patient.csv"),
        ]
        for p in expect:
            assert os.path.exists(p), f"missing artifact: {p}"
        rows = open(os.path.join(workdir, "per_patient.csv")).read().splitlines()
        assert len(rows) >= 2, rows
        print(f"reproduce --check OK: all {len(stages)} stages ran; "
              f"{len(rows) - 1} per-patient rows in {workdir}/per_patient.csv")
    finally:
        config_mod.mscmrseg_default = real


def main(argv=None, device=None):
    """The runbook's command line; ``device=None`` runs the train and
    evaluate stages on the card (raising without one), ``device="cpu"`` on
    the CPU."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default="./input_aug",
                   help="root containing raw_data/ (outputs are written here too)")
    p.add_argument("--workdir", default="./weights_reproduce")
    p.add_argument("--stage", default="", help="run only stages whose name contains this")
    p.add_argument("--print-only", action="store_true", help="print commands, run nothing")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--train-args", default=None,
                   help="UDA flags for the train stage — one shell-quoted "
                   "string, e.g. --train-args '-aug2 -d1 -d2 -d4' "
                   "(default: '-d1 -d2', the heavy-aug 0.849 row)")
    p.add_argument("--check", action="store_true",
                   help="fabricate a mini dataset and dry-run the whole chain")
    args = p.parse_args(argv)

    if args.check:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            check(td, device)
        return

    stages = build_stages(args.data_root, args.workdir,
                          train_args=parse_train_args(args.train_args, ["-d1", "-d2"]),
                          epochs=args.epochs)
    drive(stages, functools.partial(run_stage, device=device), args.workdir, args.stage, args.print_only)
    if not args.print_only and (not args.stage or "evaluate" in args.stage):
        print("done — compare the printed table with BASELINE.md "
              "(heavy-aug+D1+D2 expectation: val-LGE Dice ~0.849)")


if __name__ == "__main__":
    main()
