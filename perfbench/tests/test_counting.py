"""The benchmark's FLOP count of a step equals what
``torch.utils.flop_counter.FlopCounterMode`` counts on the port's step, at a
small size of each configuration; the units of ``step_mfu`` check out."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counting, harness, spec
from perfbench.tests.conftest import SHRINK


@pytest.mark.parametrize("cell", ["mscmrseg-d124.aug2", "mmwhs-d124.noaug"])
def test_step_flops_equal_the_flop_counter_on_the_ports_step(cell):
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step

    cfg, _ = harness.configs(spec.resolve(cell), 0, dict(SHRINK, crop_size=96, n_block=4, fc_inch=1))
    st = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    with FlopCounterMode(display=False) as fc:
        step(st, synthetic_batch(cfg, cfg.bs, seed=1))
    assert fc.get_total_flops() == counting.step_flops(cfg)


@pytest.mark.parametrize("side", [0, 1], ids=["port_config", "reference_config"])
def test_full_size_step_flops(side):
    """The counts of the U-Net cells, the same from the port's configuration
    and from the reference's (which the harness counts from)."""
    got = {c: counting.step_flops(harness.configs(spec.resolve(c), 0)[side]) for c in ("mscmrseg-d124.aug2", "mmwhs-d124.noaug")}
    assert got == {"mscmrseg-d124.aug2": 3439439547776.0, "mmwhs-d124.noaug": 4554278905216.0}


@pytest.mark.parametrize("dtype,peak", [("float32", counting.PEAK_F32_FLOPS), ("bfloat16", counting.PEAK_BF16_FLOPS)])
def test_step_mfu_reads_100_on_a_chip_at_its_peak(dtype, peak):
    cfg, _ = harness.configs(spec.resolve("mscmrseg-d124.aug2"), 0, {"compute_dtype": dtype})
    flops = counting.step_flops(cfg)
    ms = 1e3 * flops / peak
    run = SimpleNamespace(cfg=cfg, step_flops=flops, untraced_iter_ms=[ms, ms])
    assert spec.reader("step_mfu")(run) == pytest.approx(100.0)


def test_kernel_work_and_bounds():
    nbytes, ops = counting.bn_stats_work((16, 32, 224, 224), 2, backward=False)
    assert nbytes == 16 * 32 * 224 * 224 * 2 + 2 * 32 * 4 and ops == 3 * 16 * 32 * 224 * 224
    t, which = counting.bound_s(nbytes, ops)
    assert which == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    nbytes, ops = counting.fps_work(16, 196608, 300, 16 * 27552)
    t, which = counting.bound_s(nbytes, ops)
    assert which == "operations" and 1.9e-5 < t < 2.0e-5  # PERF.md's 0.0197 ms


def test_roofline_readers_stay_within_their_bounds_time():
    cfg = dataclasses.replace(harness.configs(spec.resolve("mmwhs-d124.light-fps"), 0)[0])
    full = (cfg.bs, cfg.filters, cfg.crop_size, cfg.crop_size)
    nb, ops = counting.bn_stats_work((16, 32, 256, 256), 2, False)
    exact = counting.bound_s(nb, ops)[0] * 1e9
    fwd = "void stats_forward_kernel<__nv_bfloat16, 8>(...)"
    forward = spec.reader_module("kernels.roofline.bn_stats").RECORD[0]
    run = SimpleNamespace(cfg=cfg, fps_valid=[16 * 27552.0], fps_shapes=[(16, 196608, 300)],
                          recorded=[(forward, ((full, "bfloat16"),)), (forward, (((16, 64, 128, 128), "bfloat16"),))],
                          trace={"kernel_times": [("bench.kernel.fps.0", "fps_kernel", 0.6e6)],
                                 # the second is not at the level with the largest input
                                 "iter_kernels": [[(fwd, 2 * exact), ("fps_kernel", 0.6e6), (fwd, 1.0)]]})
    assert spec.reader("kernels.roofline.bn_stats")(run) == pytest.approx(50.0)
    assert 2.0 < spec.reader("kernels.roofline.fps")(run) < 5.0
