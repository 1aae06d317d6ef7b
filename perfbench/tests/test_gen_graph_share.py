"""The reader of ``step.gen_graph_share``: the share of the window's
unprofiled iterations whose generator phases were replayed from their CUDA
graph, from the program's spans; ``None`` on a program without the span (the
parent of the change that added it) or without an iteration."""

import pytest

from perfbench import spec


@pytest.fixture
def read():
    return spec.reader("step.gen_graph_share")


def _iterations(replayed):
    from pointcloududa_torch.utils import timer

    timer.reset_spans()
    turn, replay = timer.trace_annotation(timer.ITERATION, iteration=True), timer.trace_annotation(timer.GEN_REPLAY)
    for r in replayed:
        with turn:
            if r:
                with replay:
                    pass


@pytest.mark.parametrize("replayed,share", [((True, True, False, True), 75.0), ((True,) * 3, 100.0), ((False,) * 2, 0.0)])
def test_the_share_counts_replays_over_iterations(read, replayed, share):
    _iterations(replayed)
    assert read(None) == pytest.approx(share)


def test_the_share_reads_the_generator_phases_alone(read):
    """A replay of phases 3-5 is no replay of phases 1-2."""
    from pointcloududa_torch.utils import timer

    timer.reset_spans()
    turn, disc = timer.trace_annotation(timer.ITERATION, iteration=True), timer.trace_annotation(timer.DISC_REPLAY)
    for _ in range(2):
        with turn, disc:
            pass
    assert read(None) == 0.0


def test_none_without_the_span_or_an_iteration(read, monkeypatch):
    from pointcloududa_torch.utils import timer

    _iterations(())
    assert read(None) is None
    _iterations((True,))
    monkeypatch.setattr(timer, "SPAN_NAMES", tuple(n for n in timer.SPAN_NAMES if n != timer.GEN_REPLAY))
    assert read(None) is None
    monkeypatch.delattr(timer, "GEN_REPLAY")
    assert read(None) is None
