"""The benchmark's plain reference: the training iteration of the port
(device preprocess and the 5-phase step) in plain PyTorch, without the
port's CUDA kernels.

Most modules are frozen copies of the port's plain code (their docstrings say
of which file); the kernels' places are taken by their plain versions
(``bn.py``, ``fps.py``, ``losses.chamfer_loss``), and the data-parallel
collectives are left out (one process). Nothing here imports
``pointcloududa_torch``, ``pointcloududa_tpu`` or JAX
(``perfbench/tests/test_imports.py`` holds it so), so a later change to the
program does not move the yardstick.
"""
