"""The launch plans of the BN-statistics kernels (``ops/bn_kernel.py``:
``forward_plan``, ``backward_plan``), pure Python, on the CPU.

For every case the forward's blocks cover each element of a channel exactly
once, a 16-byte vector is used only where it is legal (and wherever it is),
the cluster (the grid is (cluster, C)) is 1, 2, 4 or 8 blocks, and the main
path's plans fit one wave by the plan's own rule. The index walks of the
two kernels (``csrc/bn_stats.cu``: a thread's first group by one division,
then (plane, position) or (channel, position) carried forward from step to
step) are transcribed here on small shapes and must reach every element
once, with its own channel. What the kernels compute is held against the
plain versions on the card (``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pointcloududa_torch.ops import bn_kernel as bk
from pointcloududa_torch.utils import native

# every BatchNorm input of the generator at bs 16 (chip_smoke.py: BN_SHAPES), as (outer, C, inner)
MAIN_PATH = [(16, 32 << k, (size >> k) ** 2) for size in (224, 256) for k in range(4)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (outer, C, inner, aligned): inner 63 and 1 (the (rows, C) layout), one channel, the most channels,
# per-channel counts that no cluster x vector x THREADS divides, a misaligned start
ODD = {
    "inner-63": (4, 24, 63, True),
    "rows": (1000, 32, 1, True),
    "one-channel": (16, 1, 224 * 224, True),
    "most-channels": (2, 65535, 3, True),
    "ragged": (3, 5, 1000 * 7, True),
    "ragged-vectors": (7, 3, 8 * 1001, True),
    "misaligned": (16, 32, 56 * 56, False),
}
CASES = [pytest.param(o, c, i, True, id=f"main-{o}x{c}x{i}") for o, c, i in MAIN_PATH]
CASES += [pytest.param(*v, id=k) for k, v in ODD.items()]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("outer,c,inner,aligned", CASES)
def test_forward_plan_covers_each_channel_once(outer, c, inner, aligned, dtype):
    plan = bk.forward_plan(outer, c, inner, dtype, aligned)
    width = 16 // dtype.itemsize
    assert plan.vec == (width if aligned and inner % width == 0 else 1)
    assert inner % plan.vec == 0 and plan.groups * plan.vec == outer * inner
    assert plan.cluster in (1, 2, 4, 8)
    ranges = plan.ranges()
    assert len(ranges) == plan.cluster and ranges[0][0] == 0 and ranges[-1][1] == plan.groups
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo <= hi for lo, hi in ranges)
    if plan.cluster > 1:  # a split channel gives a block at least one group a thread, the last one what is left
        assert plan.chunk >= bk.THREADS and all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("outer,c,inner,aligned", CASES)
def test_backward_plan(outer, c, inner, aligned, dtype):
    plan = bk.backward_plan(outer, c, inner, dtype, aligned)
    width = 16 // dtype.itemsize
    assert plan.vec == (width if aligned and inner % width == 0 else 1)
    total = outer * c * inner // plan.vec
    assert 1 <= plan.blocks <= bk.MAX_BACKWARD_BLOCKS
    # one round of BACKWARD_UNROLL vectors a thread, and no block without a full first vector row
    assert plan.blocks * bk.THREADS * bk.BACKWARD_UNROLL >= total
    assert (plan.blocks - 1) * bk.THREADS * bk.BACKWARD_UNROLL < total


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("outer,c,inner", MAIN_PATH, ids=[f"{o}x{c}x{i}" for o, c, i in MAIN_PATH])
def test_main_path_forward_fits_one_wave(outer, c, inner, dtype):
    """C x S blocks at most FORWARD_BLOCKS_PER_SM an SM of the H100's 132,
    with 16-byte loads: S = 8, 4, 2, 1 at 32, 64, 128, 256 channels."""
    plan = bk.forward_plan(outer, c, inner, dtype, True)
    assert plan.vec == 16 // dtype.itemsize
    assert c * plan.cluster <= bk.FORWARD_BLOCKS_PER_SM * bk.H100_SMS
    assert plan.cluster == 256 // c
    # twice the SMs: the plan would take a larger cluster than 8 at 32 channels, the cap holds it
    assert 2 * c * plan.cluster > bk.FORWARD_BLOCKS_PER_SM * bk.H100_SMS or plan.cluster == native.MAX_CLUSTER


def test_forward_plan_follows_the_sm_count_and_a_forced_cluster():
    assert bk.forward_plan(16, 32, 224 * 224, torch.bfloat16, True, sms=66).cluster == 4
    assert bk.forward_plan(16, 32, 224 * 224, torch.bfloat16, True, sms=1000).cluster == 8
    plan = bk.forward_plan(16, 32, 224 * 224, torch.bfloat16, True, cluster=2)
    assert plan.cluster == 2 and plan.ranges()[-1][1] == plan.groups
    tiny = bk.forward_plan(2, 3, 5, torch.float32, True)  # fewer groups than a block's threads: one block
    assert tiny == bk.ForwardPlan(1, 1, 10, 10)


def _forward_walk(outer, c_dim, inner, plan):
    """Element offsets that the forward's threads read, channel by channel:
    ``stats_forward_kernel``'s walk transcribed (first group by division,
    then kThreads groups a step carried as (planes, position))."""
    inner_v, vec, threads = inner // plan.vec, plan.vec, bk.THREADS
    plane = c_dim * inner_v * vec
    step_o, step_i = divmod(threads, inner_v)
    step, wrap = step_o * plane + step_i * vec, plane - inner_v * vec
    seen = {c: [] for c in range(c_dim)}
    for c in range(c_dim):
        for begin, end in plan.ranges():
            for t in range(threads):
                g = begin + t
                if g >= end:
                    continue
                o, i = divmod(g, inner_v)
                off = (o * c_dim + c) * inner_v * vec + i * vec
                while g < end:
                    seen[c].extend(range(off, off + vec))
                    off, i, g = off + step, i + step_i, g + threads
                    if i >= inner_v:
                        i, off = i - inner_v, off + wrap
    return seen


def _backward_walk(outer, c_dim, inner, plan):
    """(element offset, channel the thread holds for it) of every element the
    backward writes: ``stats_backward_kernel``'s walk transcribed (the
    channel carried with the position, no division after the first)."""
    inner_v, vec = inner // plan.vec, plan.vec
    total_v, stride = outer * c_dim * inner_v, plan.blocks * bk.THREADS
    step_p, step_i = divmod(stride, inner_v)
    step_c = step_p % c_dim
    out = []
    for g in range(min(stride, total_v)):
        p0, i = divmod(g, inner_v)
        c = p0 % c_dim
        while g < total_v:
            out.extend((e, c) for e in range(g * vec, g * vec + vec))
            g, i, c = g + stride, i + step_i, c + step_c
            if i >= inner_v:
                i, c = i - inner_v, c + 1
            if c >= c_dim:
                c -= c_dim
    return out


WALKS = [(3, 5, 37 * 41, True), (2, 7, 64, True), (4, 24, 63, True), (40, 3, 1, True), (16, 1, 8 * 300, True),
         (5, 2, 8 * 200, False), (2, 3, 8 * 2000, True)]


@pytest.mark.parametrize("cluster", [None, 1, 2, 8])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("outer,c,inner,aligned", WALKS, ids=[f"{o}x{c}x{i}{'' if a else '-misaligned'}" for o, c, i, a in WALKS])
def test_forward_walk_reads_each_element_of_its_channel_once(outer, c, inner, aligned, dtype, cluster):
    plan = bk.forward_plan(outer, c, inner, dtype, aligned, cluster=cluster)
    chan = np.arange(outer * c * inner).reshape(outer, c, inner)
    for ch, offsets in _forward_walk(outer, c, inner, plan).items():
        assert sorted(offsets) == sorted(chan[:, ch].ravel().tolist())


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("outer,c,inner,aligned", WALKS, ids=[f"{o}x{c}x{i}{'' if a else '-misaligned'}" for o, c, i, a in WALKS])
def test_backward_walk_writes_each_element_once_with_its_channel(outer, c, inner, aligned, dtype):
    for blocks in (bk.backward_plan(outer, c, inner, dtype, aligned).blocks, 1, 3):
        plan = bk.BackwardPlan(bk.backward_plan(outer, c, inner, dtype, aligned).vec, blocks)
        pairs = _backward_walk(outer, c, inner, plan)
        assert sorted(e for e, _ in pairs) == list(range(outer * c * inner))
        assert all(ch == (e // inner) % c for e, ch in pairs)
