"""The plain reference against ``pointcloududa_torch`` on the CPU at a small
size: the same preprocess output from the same raw batch and generators,
and the same three training steps from the same weights, within the cells'
limits."""

import pytest
import torch

from perfbench import correctness, harness, spec
from perfbench.feed import make_pool
from perfbench.reference.iteration import ReferenceRun
from perfbench.tests.conftest import SHRINK, small_cell
from perfbench.weights import make_weights

CELLS = ["mscmrseg-d124.aug2", "mscmrseg-d124.heavy", "mmwhs-d124.light-fps", "mmwhs-d124.noaug"]
BN = spec.reader_module("kernels.roofline.bn_stats")


@pytest.mark.parametrize("name", CELLS)
def test_the_preprocess_equals_the_ports(name):
    from pointcloududa_torch.train.loop import make_device_preprocess

    cell, raw_size = small_cell(name)
    cfg, ref_cfg = harness.configs(cell, 7, SHRINK)
    raw = make_pool(dict(workload=cfg.workload, bs=cfg.bs, raw_size=raw_size, channels=cfg.in_channels,
                         n_class=cfg.n_class, points=300), dict(cell.traffic, pool_batches=1), 7)[0]
    port = make_device_preprocess(cfg, train=True, device_augment=True, device="cpu")
    ref = ReferenceRun(ref_cfg, make_weights(ref_cfg, 7, "cpu"), "cpu")
    gen, host = torch.Generator().manual_seed(cfg.seed + 17), torch.Generator().manual_seed(cfg.seed + 19)
    for _ in range(2):  # the second call continues both generators
        want = ref.preprocess(raw)
        got = port(gen, raw, with_vert_t=True, host_generator=host)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["mscmrseg-d124.aug2", "mmwhs-d124.light-fps"])
def test_three_steps_agree_with_the_ports(name):
    cell, raw_size = small_cell(name)
    built = harness.first_steps(cell, 11, "cpu", shrink=SHRINK, raw_size=raw_size)
    ref, ref_stage = correctness.reference_readings(built["ref_cfg"], make_weights(built["ref_cfg"], 11, "cpu"),
                                                    built["pool"][:3], "cpu")
    built["trainer"].writer.close()
    built["tmp"].cleanup()
    stage = built["stage"]
    assert set(stage["calls"]) == {"forward_fused", "side_grad", "stats_forward", "stats_backward"}
    numbers = correctness.check_numbers(built["prog"], stage, ref, ref_stage, "cpu", calls=stage["calls"])
    assert correctness.judge(numbers, cell.limits), numbers
    # on the CPU the port's kernels take their plain versions: every stage is the reference's to the bit
    assert all(numbers[k] == 0.0 for k in correctness.STAGE_CHECKS), numbers
    assert numbers["loss_gap"] < 1e-6 and numbers["disc_grad_gap"] < 1e-4
    # the plain Chamfer route of the port rounds differently from the loss the reference copies
    assert numbers["point_loss_gap"] < 1e-5


def test_the_kernels_plain_copies_equal_the_ports():
    from perfbench.reference import bn, losses
    from pointcloududa_torch.ops import bn_kernel, chamfer_kernel

    g = torch.Generator().manual_seed(3)
    x, y = 255 * torch.rand(2, 40, 3, generator=g), 255 * torch.rand(2, 30, 3, generator=g)
    want = chamfer_kernel.forward_fused_plain(x, y)
    got = losses.chamfer_parts(x, y)
    assert torch.equal(got[0], want[0]) and all(torch.equal(a.int(), b) for a, b in zip(got[1:], want[1:]))
    upstream = torch.tensor([0.7])
    assert torch.equal(losses.chamfer_side_grad(x, y, got[1], got[2], upstream),
                       chamfer_kernel.side_grad_plain(x, y, want[1], want[2], upstream))
    a = torch.rand(4, 3, 5, 5, generator=g).to(torch.bfloat16)
    gm, gq = torch.rand(3, generator=g), torch.rand(3, generator=g)
    assert torch.equal(bn.stats_backward_plain(a, gm, gq), bn_kernel.stats_backward_plain(a, gm, gq))


def test_set_up_records_the_bn_calls_of_the_first_step_in_order():
    """The sequence ``kernels.roofline.bn_stats`` matches a traced
    iteration's BN-statistics kernels to: each BatchNorm's forward call at
    its level's shape, then the backward calls, full resolution in both,
    which is the level the reader takes."""
    cell, raw_size = small_cell("mscmrseg-d124.aug2")
    built = harness.first_steps(cell, 11, "cpu", shrink=SHRINK, raw_size=raw_size)
    built["trainer"].writer.close()
    built["tmp"].cleanup()
    cfg, seq = built["cfg"], BN.calls(built["recorded"])
    calls = [(kind, shape, dtype) for (kind, dtype), shape in seq]
    levels = {(cfg.bs, cfg.filters * 2**i, cfg.crop_size // 2**i, cfg.crop_size // 2**i) for i in range(cfg.n_block)}
    kinds = [k for k, _, _ in calls]
    assert kinds.count("bn_fwd") == kinds.count("bn_bwd") > 0
    assert kinds.index("bn_bwd") == kinds.count("bn_fwd")  # every forward before the backward pass
    assert {s for _, s, _ in calls} == levels
    assert {d for _, _, d in calls} == {cfg.compute_dtype}
    full = (cfg.bs, cfg.filters, cfg.crop_size, cfg.crop_size)
    assert {k for k, s, _ in calls if s == full} == {"bn_fwd", "bn_bwd"}
    assert BN.level(seq) == {full}


@pytest.mark.parametrize("name,full", [("mscmrseg-d124.aug2", (16, 32, 224, 224)),
                                       ("mmwhs-d124.noaug", (16, 32, 256, 256))])
def test_the_bn_rooflines_level_at_the_cells_size(name, full, monkeypatch):
    """At the cells' own size (the port's generator on the meta device, its
    BN wrappers' plain versions in their place), the level with the largest
    input among the recorded calls is the full-resolution one."""
    from pointcloududa_torch.ops import bn_kernel
    from pointcloududa_torch.train.state import build_generator

    from perfbench import tracing

    monkeypatch.setattr(bn_kernel, "stats_forward", bn_kernel.stats_forward_plain)
    monkeypatch.setattr(bn_kernel, "stats_backward", bn_kernel.stats_backward_plain)
    cell = spec.resolve(name)
    cfg = harness.configs(cell, 0)[0]
    with torch.device("meta"):
        gen = build_generator(cfg)
        x = torch.empty((cfg.bs, cfg.crop_size, cfg.crop_size, cfg.in_channels))
    calls = tracing.Calls(spec.recorded_functions(cell))
    try:
        gen(x, None)[0].sum().backward()
    finally:
        calls.restore()
    seq = BN.calls(calls.calls)
    assert len(seq) == 32 and BN.level(seq) == {full}
