"""Scalar metric logging: live TensorBoard + JSONL (the port's own copy of the
JAX package's ``utils/logging.py``).

The reference dumps all per-epoch series to TensorBoard only AFTER training
completes (``src/train_mscmrseg.py:594-641``); here the writer is live
(flushed per epoch) and additionally appends machine-readable JSONL so runs
are greppable without TensorBoard. TensorBoard is optional: where the
``tensorboard`` package is not installed only the JSONL file is written.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, logdir: str, comment: str = ""):
        self.logdir = os.path.join(logdir, comment) if comment else logdir
        os.makedirs(self.logdir, exist_ok=True)
        self._jsonl = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=self.logdir)

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
