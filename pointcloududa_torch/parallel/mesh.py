"""Host-side batch padding (the port's own copy of ``pad_batch`` from the JAX
package's ``parallel/mesh.py``; numpy only). The device mesh, sharding and
multi-process helpers of that module belong to data parallelism, which is
not ported yet."""

from __future__ import annotations

import numpy as np


def pad_batch(batch: dict, multiple: int, target: int = 0) -> dict:
    """Pad the leading (batch) dim of a dict-of-arrays to ``target`` (or the
    next multiple of ``multiple``), attaching a ``"sample_mask"`` of 1s for
    real samples and 0s for the pad.

    Pad rows wrap around the batch's own samples (``x[i % n]``) so train-mode
    BatchNorm sees plausible values; every loss/metric reduction in the step
    functions excludes the pad via the mask (``losses.masked_mean``),
    preserving the reference's short-tail-batch means
    (``src/data_generator_mscmrseg.py:281-291``).
    """
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    n = next(iter(arrays.values())).shape[0]
    t = max(target, -(-n // multiple) * multiple)
    if n == t:
        return batch
    idx = np.arange(t) % n
    out = {k: v[idx] for k, v in arrays.items()}
    base = arrays.get("sample_mask", np.ones(n, np.float32))
    out["sample_mask"] = np.where(np.arange(t) < n, base[idx], 0.0).astype(np.float32)
    return out
