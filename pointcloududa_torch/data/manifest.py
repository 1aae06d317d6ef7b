"""CSV datalists (layer L1 of SURVEY.md §1; the port's own copy of the JAX
package's ``data/manifest.py``).

The reference stores slice ids in single-column csv files (``img``) under
``input/`` (MM-WHS) and ``input_aug/`` (MS-CMRSeg), loaded by
``ImageProcessor.split_data`` (``src/data_generator_mscmrseg.py:169-177``).
"""

from __future__ import annotations

import os
from typing import List


def load_ids(csv_path: str, column: str = "img") -> List[str]:
    """Read the id column of a datalist csv.

    Accepts files with or without pandas installed; the reference format is
    a header line followed by one id per row.
    """
    if not os.path.exists(csv_path):
        raise FileNotFoundError(csv_path)
    try:
        import pandas as pd

        return [str(v) for v in pd.read_csv(csv_path)[column].values]
    except ImportError:
        with open(csv_path) as f:
            header = f.readline().strip().split(",")
            col = header.index(column)
            return [line.strip().split(",")[col] for line in f if line.strip()]


def write_ids(csv_path: str, ids: List[str], column: str = "img") -> None:
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "w") as f:
        f.write(column + "\n")
        for i in ids:
            f.write(str(i) + "\n")
