"""Evidence that training with the port learns: convergence smokes and
quality gates on synthetic tasks made from a seed, so no download is needed.
Each module is the counterpart of a piece of the JAX package's own evidence
and keeps its flags, task code, step counts, probes and bars:

- ``smoke_train``: supervised convergence (``tools/smoke_train.py``): Dice
  >= 0.85 at step 80 at bs 16, 224^2, bfloat16;
- ``smoke_uda``: the triple-adversary step, D4 with ``--d4``, for 150 steps
  (``tools/smoke_uda.py``): every metric finite, source Dice >= 0.5;
- ``calibrate_d4``: the D4 calibration task and its arms
  (``tools/calibrate_d4.py``: ``make_shift_batch``, ``run_arm``, ``main``);
- ``quality_gates``: the protocols of the two slow gates,
  ``tests/test_uda_quality_gate.py`` (D1+D2 beats no UDA on target Dice)
  and ``tests/test_d4_quality_gate.py`` (D2+D4 beats D2 alone).

Run one with ``python -m pointcloududa_torch.smoke.<module> [flags]`` on the
card, or ``main(argv, device="cpu")`` from Python for the CPU. On the card
every run goes through the hand-written kernels, as a training run does.
"""
