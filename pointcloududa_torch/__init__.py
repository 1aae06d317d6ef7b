"""pointcloududa_torch — the PyTorch and CUDA port of ``pointcloududa_tpu``
for NVIDIA Hopper (H100).

The layout mirrors the JAX package, so each module's counterpart is easy to
find:

- ``ops``    : losses; the hand-written CUDA kernels with their wrappers
               (``chamfer_kernel``: the Chamfer forward in one launch, the
               one-direction nearest-neighbour search and the backward;
               ``bn_kernel``: BN batch statistics; ``fps_kernel``:
               farthest-point sampling); ``pointcloud_device`` (mask -> point
               cloud on the device); ``augment`` (the light augmentation
               family).
- ``models`` : ``nn.Module`` twins of the generator, D1/D2 and D4, named with
               the reference's ``state_dict`` key layout.
- ``train``  : train state, optimisers, the 5-phase UDA train step, and the
               device preprocess (``loop.make_device_preprocess``).
- ``utils``  : the kernel build (``native``), the default device
               (``device``), device timing (``timing``) and the JAX weight
               bridge (``weights``).
- ``tools``  : measurement scripts that run on the card.
- ``csrc``   : CUDA C++ sources for ``sm_90a``.
- ``config``, ``data.synthetic`` : the run configuration and synthetic
               batches: the port's own copies of the JAX package's jax-free
               modules (copied, not imported; a test holds them equal).

This package imports ``torch``, never JAX and nothing of the JAX package.
Its entry points run on the current CUDA device unless the caller passes
``device="cpu"``.
"""
