"""Create CSV datalists (layer L1) by scanning processed data directories
(the port's counterpart of the repository's ``tools/create_datalist.py``).

The reference README references a ``create_datalist.py`` that does not exist
in its repo (doc drift, SURVEY.md §1); this provides the real thing: scan a
directory of processed slices and write the single-column ``img`` csv the
loaders consume.

  # MS-CMRSeg: ids are png basenames
  python -m pointcloududa_torch.prep.create_datalist \
      --dir ./input_aug/processed/trainA --out ./input_aug/aug_trainA.csv
  # MM-WHS: ids are npy basenames under img/ (one extension level stripped,
  # so "x.tfrecords.npy" yields the id "x.tfrecords" the loaders expect)
  python -m pointcloududa_torch.prep.create_datalist \
      --dir ./input/PnpAda_release_data/ct_train/img --out ./input/ct_train_list.csv
"""

import argparse
import glob
import os

from pointcloududa_torch.data.manifest import write_ids


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--pattern", default="*")
    args = p.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.dir, args.pattern)))
    # strip exactly one extension level: "x.png" -> "x",
    # "x.tfrecords.npy" -> "x.tfrecords" (the id format the loaders expect)
    ids = [os.path.splitext(os.path.basename(path))[0] for path in paths]
    if not ids:
        raise SystemExit(f"no files matched in {args.dir}")
    write_ids(args.out, ids)
    print(f"wrote {len(ids)} ids to {args.out}")


if __name__ == "__main__":
    main()
