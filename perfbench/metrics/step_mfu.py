"""The whole step's share of the chip's peak: the step's model FLOPs
(``counting.step_flops``) over the mean iteration time of the window's
untraced iterations times the published dense peak of the configuration's
compute precision: 989 TFLOP/s for bfloat16 on the tensor cores, 67 TFLOP/s
for float32 outside them (the benchmark runs float32 with TF32 off)."""

from perfbench import counting

PEAKS = {"bfloat16": counting.PEAK_BF16_FLOPS, "float32": counting.PEAK_F32_FLOPS}


def read(run):
    if not run.untraced_iter_ms or run.cfg.compute_dtype not in PEAKS:
        return None
    seconds = sum(run.untraced_iter_ms) / len(run.untraced_iter_ms) / 1e3
    return 100.0 * run.step_flops / (seconds * PEAKS[run.cfg.compute_dtype])
