"""The whole step's share of the chip's peak: the step's model FLOPs
(``counting.step_flops``) over the mean iteration time of the window's
untraced iterations times the published bf16 dense peak (989 TFLOP/s)."""

from perfbench import counting


def read(run):
    if not run.untraced_iter_ms or run.cfg.compute_dtype != "bfloat16":
        return None
    seconds = sum(run.untraced_iter_ms) / len(run.untraced_iter_ms) / 1e3
    return 100.0 * run.step_flops / (seconds * counting.PEAK_BF16_FLOPS)
