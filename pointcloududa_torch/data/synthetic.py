"""Synthetic train and eval batches (numpy, NHWC), shared with the JAX
package (``pointcloududa_tpu/data/synthetic.py``, numpy only), so both
packages step on the same arrays."""

from pointcloududa_tpu.data.synthetic import synthetic_batch, synthetic_eval_batch  # noqa: F401
