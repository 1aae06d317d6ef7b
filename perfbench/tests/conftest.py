"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, one torch thread a worker, and the small configuration every run here
uses (the cells' own sizes run only on the card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# 2 encoder blocks at 32x32: bottleneck 8x8, so the point head's k6 VALID conv leaves 3x3 = 9
SHRINK = dict(crop_size=32, n_block=2, fc_inch=9, filters=8, bs=4)
RAW = {"mscmrseg": 40, "mmwhs": 32}


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small_cell(name: str):
    """The cell ``name`` with a short warm-up and traced slice."""
    from perfbench import spec

    cell = spec.resolve(name)
    cell.traffic = dict(cell.traffic, warmup_iters=1, trace_iters=2)
    return cell, RAW[cell.config["uda_config"]["workload"]]
