"""One short run of a cell on the card, as its command line runs it (marker
``cuda``: skips without a card; on the card: ``python -m pytest
perfbench/tests/test_card.py``)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(card, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mmwhs-d124.light-fps", "--seed",
                          str(3_000_000_000 + trace), "--seconds", "5", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
