"""pointcloududa_torch — the PyTorch and CUDA port of ``pointcloududa_tpu``
for NVIDIA Hopper (H100).

The layout mirrors the JAX package, so each module's counterpart is easy to
find:

- ``ops``    : losses, and the hand-written CUDA kernels with their wrappers
               (Chamfer nearest neighbour and backward, BN batch statistics).
- ``models`` : ``nn.Module`` twins of the generator, D1/D2 and D4, named with
               the reference's ``state_dict`` key layout.
- ``train``  : train state, optimisers, and the 5-phase UDA train step.
- ``utils``  : the kernel builder (``native``) and the JAX weight bridge.
- ``csrc``   : CUDA C++ sources for ``sm_90a``.
- ``config``, ``data.synthetic`` : the run configuration and synthetic
               batches, re-exported from the JAX package's jax-free modules
               (``pointcloududa_tpu.config``, ``pointcloududa_tpu.data.synthetic``).

This package imports ``torch`` and never JAX.
"""
