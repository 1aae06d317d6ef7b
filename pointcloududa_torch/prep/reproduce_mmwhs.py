"""Turnkey MM-WHS (MR -> CT) reproduction runbook: raw PnP-AdaNet release ->
prep -> point clouds -> train -> CT-volume evaluation -> paper table (the
port's counterpart of the repository's ``tools/reproduce_mmwhs.py``: the same
stages and argv, with ``tools.X`` -> ``pointcloududa_torch.prep.X`` and the
JAX package's CLIs -> ``pointcloududa_torch.cli.*``; the train and evaluate
stages run on the card unless ``main(argv, device="cpu")`` is called from
Python).

  python -m pointcloududa_torch.prep.reproduce_mmwhs --data-root <root> \
      [--train-args '...'] [--stage S] [--print-only] [--check]

MM-WHS twin of ``prep/reproduce.py``. The reference publishes its MM-WHS
headline as a Dice ladder (BASELINE.md rows 0.185 no-UDA .. 0.595 D2+D4;
the reference's ``src/evaluate_mmwhs.py:219-225``) plus a one-line train
command (the reference's ``src/README.md:24``) but no end-to-end recipe.
Run with ``--data-root`` at the PnP-AdaNet release download; ``--stage`` for
one stage; ``--print-only`` to list commands; ``--check`` (no data needed)
to dry-run the complete chain on a fabricated mini dataset.

Expected raw layout under --data-root (the release's, SURVEY.md §3.5):
  <root>/{ct,mr}_{train,val}_list.csv                       datalists (ship
                                                            with the release)
  <root>/PnpAda_release_data/train_n_val/<split>_tfs/<id>   TFRecord slices
  <root>/PnpAda_release_data/test_ct_image_n_labels/
      image_ct_{1003,1008,1014,1019}.nii.gz                 CT test volumes
      gth_ct_{1003,1008,1014,1019}.nii.gz                   CT test GT

Paper hyperparameters (reference ``src/README.md:24``):
  -bs 16 -ns 1000 -e 400 -d1 -d2 -d4 -offdecay -lr_fix 2e-4 -lr 2e-4
  -d1lr 1e-4 -d2lr 5e-5 -d4lr 1e-4 -dr 1 -ft -extd4 -softmax
(per-row LR overrides for the other ladder entries: README.md:30-37 table.)

Expected result (BASELINE.md): CT test Dice 0.595 (D2+D4), 0.565 (D1+D2+D4),
0.313 (D2 alone) — the D2-vs-D2+D4 gap is the paper's headline.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np

from pointcloududa_torch.prep.runbook import drive, find_best_checkpoint, parse_train_args

PREP, CLI = "pointcloududa_torch.prep.", "pointcloududa_torch.cli."

SPLITS = ("ct_train", "ct_val", "mr_train", "mr_val")
PAPER_TRAIN = ["-bs", "16", "-ns", "1000", "-e", "400", "-d1", "-d2", "-d4",
               "-offdecay", "-lr_fix", "2e-4", "-lr", "2e-4", "-d1lr", "1e-4",
               "-d2lr", "5e-5", "-d4lr", "1e-4", "-dr", "1", "-ft", "-extd4",
               "-softmax"]


def build_stages(root: str, workdir: str, *, train_args=None, pat_ids=None):
    """The full command chain as (name, module, argv) triples: the
    repository's ``tools/reproduce_mmwhs.py`` stages with the port's modules."""
    stages = []
    # 1. TFRecords -> per-slice img/mask .npy (pure-python parser, no TF)
    stages.append(("prep", PREP + "prepare_mmwhs",
                   ["--input", root, "--splits", *SPLITS]))
    # 2. point-cloud GT (300x3 vertex npys from the mask npys). Training
    #    streams regenerate clouds from warped masks when -aug is on, but
    #    validation always loads these files when the point head is on,
    #    and so do un-augmented train streams (data/build.py:92-98).
    for split in SPLITS:
        base = os.path.join(root, "PnpAda_release_data", split)
        stages.append((f"pointclouds:{split}", PREP + "make_pointclouds",
                       ["--masks", os.path.join(base, "mask"),
                        "--out", os.path.join(base, "vertices"),
                        "--seed", "0"]))
    # 3. UDA training (paper hyperparameters; auto-evaluates the best
    #    checkpoint unless -skip_final_eval)
    stages.append(("train", CLI + "train_mmwhs",
                   [*(train_args or PAPER_TRAIN), "-data_dir", root,
                    "-workdir", workdir,
                    "-logdir", os.path.join(workdir, "runs")]))
    # 4. standalone evaluation (the reference's separate entry point)
    ev = ["-weight_dir", workdir, "-from_name", "-data_dir", root,
          "-save", "-csv", os.path.join(workdir, "per_patient.csv")]
    if pat_ids:
        ev += ["-pat_ids", *[str(p) for p in pat_ids]]
    stages.append(("evaluate", CLI + "evaluate_mmwhs", ev))
    return stages


def run_stage(module: str, argv: list, workdir: str, device=None):
    """Run one stage in this process; the CLIs on ``device`` (None: the card)."""
    import importlib

    mod = importlib.import_module(module)
    if module == CLI + "evaluate_mmwhs":
        i = argv.index("-weight_dir") + 1
        argv = list(argv)
        argv[i] = find_best_checkpoint(argv[i])
    if module.startswith(CLI):
        mod.main(argv, device=device)
    else:
        mod.main(argv)


# ---------------------------------------------------------------- --check --

def _fabricate_raw(root: str, side: int = 32, n_slices: int = 6):
    """Tiny raw PnP-AdaNet layout: TFRecord slices (exercising the real
    parser) + CT test NIfTI volumes, with structured 5-class fake anatomy."""
    from pointcloududa_torch.utils.nifti import save_nii
    from pointcloududa_torch.utils.tfrecord import write_example, write_tfrecord

    rng = np.random.default_rng(0)
    for split in SPLITS:
        ids = []
        tf_dir = os.path.join(root, "PnpAda_release_data", "train_n_val",
                              f"{split}_tfs")
        os.makedirs(tf_dir, exist_ok=True)
        for i in range(n_slices):
            _id = f"{split}_slice{i}.tfrecords"
            ids.append(_id)
            img = rng.normal(size=(side, side, 3)).astype("<f4")
            lab = np.zeros((side, side), "<f4")
            o = i % 4
            lab[6 + o:20 + o, 6:20] = 1 + (i % 4)
            lab3 = np.repeat(lab[..., None], 3, axis=-1).astype("<f4")
            write_tfrecord(os.path.join(tf_dir, _id),
                           [write_example({"data_vol": img.tobytes(),
                                           "label_vol": lab3.tobytes()})])
        with open(os.path.join(root, f"{split}_list.csv"), "w") as f:
            f.write("img\n" + "\n".join(ids) + "\n")
    test_dir = os.path.join(root, "PnpAda_release_data",
                            "test_ct_image_n_labels")
    os.makedirs(test_dir, exist_ok=True)
    for pat in (1003,):
        vol = rng.normal(size=(side, side, 4)).astype(np.float32)
        gt = np.zeros((side, side, 4), np.int16)
        gt[8:22, 8:22, :] = 2
        gt[12:18, 12:18, :] = 4
        save_nii(os.path.join(test_dir, f"image_ct_{pat}.nii.gz"), vol)
        save_nii(os.path.join(test_dir, f"gth_ct_{pat}.nii.gz"), gt)


def check(tmpdir: str, device=None):
    """Dry-run the COMPLETE chain on fabricated data with a shrunken model,
    its train and evaluate stages on ``device``. Asserts every stage's
    artifacts; finishes in seconds on the CPU."""
    import pointcloududa_torch.config as config_mod

    root = os.path.join(tmpdir, "input")
    workdir = os.path.join(tmpdir, "weights")
    _fabricate_raw(root)

    real = config_mod.mmwhs_default
    tiny = dict(filters=4, n_block=2, crop_size=32, fc_inch=9)

    def tiny_default(**kw):
        kw.update(tiny)
        return real(**kw)

    config_mod.mmwhs_default = tiny_default
    try:
        train_args = [*PAPER_TRAIN, "-skip_final_eval"]
        for flag, v in (("-bs", "2"), ("-ns", "4"), ("-e", "1")):
            train_args[train_args.index(flag) + 1] = v
        train_args += ["-dtype", "float32", "-workers", "0"]
        stages = build_stages(root, workdir, train_args=train_args,
                              pat_ids=[1003])
        for name, mod, argv in stages:
            if name == "evaluate":
                argv += ["-nf", "4", "-dtype", "float32", "-bs", "2"]
            print(f"== [{name}] python -m {mod} " + " ".join(argv), flush=True)
            run_stage(mod, argv, workdir, device=device)
        rel = os.path.join(root, "PnpAda_release_data")
        expect = [
            os.path.join(rel, "mr_train", "img",
                         "mr_train_slice0.tfrecords.npy"),
            os.path.join(rel, "ct_val", "mask",
                         "ct_val_slice0.tfrecords.npy"),
            os.path.join(rel, "ct_train", "vertices",
                         "ct_train_slice0.tfrecords.npy"),
            os.path.join(workdir, "per_patient.csv"),
        ]
        for p in expect:
            assert os.path.exists(p), f"missing artifact: {p}"
        rows = open(os.path.join(workdir, "per_patient.csv")).read().splitlines()
        assert len(rows) >= 2, rows
        print(f"reproduce_mmwhs --check OK: all {len(stages)} stages ran; "
              f"{len(rows) - 1} per-patient rows in {workdir}/per_patient.csv")
    finally:
        config_mod.mmwhs_default = real


def main(argv=None, device=None):
    """The runbook's command line; ``device=None`` runs the train and
    evaluate stages on the card (raising without one), ``device="cpu"`` on
    the CPU."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default="./input",
                   help="root containing PnpAda_release_data/ and *_list.csv")
    p.add_argument("--workdir", default="./weights_reproduce_mmwhs")
    p.add_argument("--stage", default="", help="run only stages whose name contains this")
    p.add_argument("--print-only", action="store_true", help="print commands, run nothing")
    p.add_argument("--train-args", default=None,
                   help="override the paper train flags entirely — one "
                   "shell-quoted string, e.g. --train-args '-bs 16 -d2 -d4 "
                   "-softmax'")
    p.add_argument("--check", action="store_true",
                   help="fabricate a mini dataset and dry-run the whole chain")
    args = p.parse_args(argv)

    if args.check:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            check(td, device)
        return

    stages = build_stages(args.data_root, args.workdir,
                          train_args=parse_train_args(args.train_args, PAPER_TRAIN))
    drive(stages, functools.partial(run_stage, device=device), args.workdir, args.stage, args.print_only)
    if not args.print_only and (not args.stage or "evaluate" in args.stage):
        print("done — compare the printed table with BASELINE.md "
              "(D1+D2+D4 expectation: CT test Dice ~0.565; D2+D4: ~0.595)")


if __name__ == "__main__":
    main()
