"""The run configuration: ``UDAConfig`` and the MS-CMRSeg preset, shared with
the JAX package (``pointcloududa_tpu/config.py``, which imports only the
standard library), so one config object drives both packages."""

from pointcloududa_tpu.config import UDAConfig, mscmrseg_default  # noqa: F401
