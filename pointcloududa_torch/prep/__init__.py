"""The offline data layer and the reproduction runbooks: raw MS-CMRSeg NIfTI
volumes and MM-WHS TFRecords -> per-slice PNG / ``.npy`` files, datalists,
point-cloud ground truth and the offline ``_r1``/``_r2`` rotations, then the
port's training and evaluation CLIs. Each module keeps the file name and the
command line of its counterpart under the repository's ``tools/`` and writes
the same files, with numpy, scipy and the port's own helpers (no OpenCV):

- ``prepare_mscmrseg``: ``png`` / ``npy`` / ``rotate`` subcommands;
- ``prepare_mmwhs``: TFRecord slices -> img/mask ``.npy``;
- ``make_pointclouds``: mask files -> (300, 3) vertex ``.npy``;
- ``create_datalist``: a directory of slices -> a one-column CSV;
- ``reproduce`` (MS-CMRSeg) and ``reproduce_mmwhs``: every stage in order,
  over ``runbook.drive``; ``--check`` runs the whole chain on a fabricated
  mini dataset.

Run a module with ``python -m pointcloududa_torch.prep.<module> ...``. The
runbooks' train and evaluate stages run on the card unless ``main(argv,
device="cpu")`` is called from Python.
"""
