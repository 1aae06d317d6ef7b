"""MM-WHS offline prep: PnP-AdaNet TFRecords -> img/mask ``.npy`` slices
(the port's counterpart of the repository's ``tools/prepare_mmwhs.py``).

Equivalent of reference ``src/utils/tf_to_numpy.py:40-64`` without the
TensorFlow dependency (pure-python TFRecord/Example parsing,
``utils/tfrecord.py``): each record holds ``data_vol``/``label_vol`` as raw
little-endian float32 of shape (256, 256, 3); the mask keeps only channel 0
(``tf_to_numpy.py:36``).

Usage:
  python -m pointcloududa_torch.prep.prepare_mmwhs --input ./input \
      [--splits ct_train ct_val mr_train mr_val]
Expects ``<input>/<split>_list.csv`` and
``<input>/PnpAda_release_data/train_n_val/<split>_tfs/<id>``.
"""

import argparse
import os

import numpy as np

from pointcloududa_torch.data.manifest import load_ids
from pointcloududa_torch.utils.tfrecord import read_examples


def decode_slice(tfrecord_path: str):
    """The release's records are 256x256x3 (``tf_to_numpy.py:40-64``); the
    side is inferred from the payload length so fabricated mini records
    (``prep/reproduce_mmwhs.py --check``) decode through the same path."""
    ex = next(iter(read_examples(tfrecord_path)))
    data = np.frombuffer(ex["data_vol"][0], dtype="<f4")
    label = np.frombuffer(ex["label_vol"][0], dtype="<f4")
    side = int(round((data.size / 3) ** 0.5))
    if side * side * 3 != data.size or label.size != data.size:
        raise ValueError(
            f"{tfrecord_path}: expected matching square HxWx3 payloads, got "
            f"data_vol={data.size} label_vol={label.size} floats"
        )
    data = data.reshape(side, side, 3)
    label = label.reshape(side, side, 3)
    return data, label[..., 0:1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default="./input")
    p.add_argument("--splits", nargs="+", default=["ct_train", "ct_val", "mr_train", "mr_val"])
    args = p.parse_args(argv)

    for split in args.splits:
        ids = load_ids(os.path.join(args.input, f"{split}_list.csv"))
        out_base = os.path.join(args.input, "PnpAda_release_data", split)
        os.makedirs(os.path.join(out_base, "img"), exist_ok=True)
        os.makedirs(os.path.join(out_base, "mask"), exist_ok=True)
        for i, _id in enumerate(ids):
            if i % 100 == 0:
                print(split, i, _id)
            out_img = os.path.join(out_base, "img", f"{_id}.npy")
            if os.path.exists(out_img):
                continue
            src = os.path.join(args.input, "PnpAda_release_data/train_n_val", f"{split}_tfs", _id)
            img, mask = decode_slice(src)
            np.save(out_img, img)
            np.save(os.path.join(out_base, "mask", f"{_id}.npy"), mask)
        print(f"**************** {split} finished ****************")


if __name__ == "__main__":
    main()
