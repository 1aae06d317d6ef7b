"""Batch padding for static shapes (the data-parallel rest of the JAX
package's ``parallel`` is not ported yet)."""

from pointcloududa_torch.parallel.mesh import pad_batch

__all__ = ["pad_batch"]
