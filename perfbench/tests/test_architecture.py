"""A generator architecture added as a file and nothing else
(``tests/archs/tiny_vit.py``, put where ``reference/arch`` looks), under a
configuration whose ``uda_config`` names it: the reference's config, the
initial weights, the step's FLOP count (equal to ``FlopCounterMode`` on the
reference's step) and a reference step all work, the control's rounding
reaches its attention products, an unknown architecture fails before
set-up, and a leaf that no rule covers raises."""

import json
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counting, harness, spec
from perfbench.feed import make_pool
from perfbench.reference import arch, numerics
from perfbench.reference.iteration import ReferenceRun
from perfbench.tests.conftest import RAW, SHRINK
from perfbench.weights import make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "mscmrseg-d124.aug2"


@pytest.fixture
def tiny(monkeypatch):
    """The lookup's directory is the test's own, which holds ``tiny_vit.py``."""
    monkeypatch.setattr(arch, "DIR", os.path.join(HERE, "archs"))
    return arch.load("tiny_vit")


def _cell(tmp_path, name: str):
    """``CELL`` with its configuration's file copied to one that sets ``arch``."""
    bench = spec.load_benchmark()
    src = next(c for c in bench["configs"] if c["name"] == "mscmrseg-d124")
    with open(os.path.join(spec.ROOT, src["file"])) as f:
        config = json.load(f)
    config["name"] = f"{src['name']}-{name}"
    config["uda_config"] = dict(config["uda_config"], arch=name)
    path = tmp_path / f"{config['name']}.json"
    path.write_text(json.dumps(config))
    bench["configs"].append(dict(src, name=config["name"], file=str(path)))
    next(w for w in bench["workloads"] if w["name"] == CELL)["config"] = config["name"]
    return spec.resolve(CELL, bench)


def _ref_cfg(tmp_path, seed=3_000_000_017):
    return harness.reference_config(_cell(tmp_path, "tiny_vit"), seed, SHRINK)


def _batch(cell, ref_cfg, run, seed):
    raw = make_pool(dict(workload=ref_cfg.workload, bs=ref_cfg.bs, raw_size=RAW[ref_cfg.workload],
                         channels=ref_cfg.in_channels, n_class=ref_cfg.n_class, points=300),
                    dict(cell.traffic, pool_batches=1), seed)[0]
    return run.preprocess(raw)


def test_the_architecture_file_is_all_a_configuration_needs(tiny, tmp_path):
    cell = _cell(tmp_path, "tiny_vit")
    ref_cfg = harness.reference_config(cell, 5, SHRINK)
    assert ref_cfg.arch == "tiny_vit" and ref_cfg.d1 and ref_cfg.d2 and ref_cfg.d4
    weights = make_weights(ref_cfg, 5, "cpu")
    gen = weights["gen"]
    assert set(gen) >= {"embeddings.patch.weight", "embeddings.position", "attention.qkv.weight",
                        "attention.norm.weight", "norm.running_var", "pointNet.final_fc.weight"}
    # the architecture's rules before the base rules: He's normal for the standardised conv, N(0, 0.02) position
    fan_in = math.prod(gen["embeddings.patch.weight"].shape[1:])
    assert gen["embeddings.patch.weight"].std().item() == pytest.approx(math.sqrt(2.0 / fan_in), rel=0.2)
    assert gen["embeddings.position"].std().item() == pytest.approx(0.02, rel=0.2)
    assert torch.equal(gen["attention.norm.weight"], torch.ones_like(gen["attention.norm.weight"]))
    assert torch.equal(gen["embeddings.norm.bias"], torch.zeros_like(gen["embeddings.norm.bias"]))

    run = ReferenceRun(ref_cfg, weights, "cpu")
    batch = _batch(cell, ref_cfg, run, 5)
    with FlopCounterMode(display=False) as fc:
        metrics = run.step_on(batch)
    assert fc.get_total_flops() == counting.step_flops(ref_cfg)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert metrics["ver_s_loss"] > 0  # the point head trained through the step


def test_the_control_reaches_the_attention_products(tiny, tmp_path):
    ref_cfg = _ref_cfg(tmp_path)
    run = ReferenceRun(ref_cfg, make_weights(ref_cfg, 1, "cpu"), "cpu", operand_round=numerics.tf32)
    rounded = [m for m in run.models[0].modules() if isinstance(m, (numerics.Product, numerics.Conv2d))]
    assert {type(m) for m in rounded} == {numerics.Product, numerics.Conv2d, tiny.StdConv2d}
    assert all(m.operand_round is numerics.tf32 for m in rounded)
    plain = ReferenceRun(ref_cfg, make_weights(ref_cfg, 1, "cpu"), "cpu")
    x = torch.rand(2, ref_cfg.crop_size, ref_cfg.crop_size, ref_cfg.in_channels, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert not torch.equal(run.models[0](x)[0], plain.models[0](x)[0])


def test_an_unknown_architecture_fails_before_set_up(tmp_path):
    with pytest.raises(spec.UnknownName, match="no_such_arch.py"):
        _cell(tmp_path, "no_such_arch")
    cell = spec.resolve(CELL)
    cell.config = dict(cell.config, uda_config=dict(cell.config["uda_config"], arch="no_such_arch"))
    with pytest.raises(arch.UnknownArch, match="no_such_arch.py"):
        harness.configs(cell, 0)


def test_a_leaf_no_rule_covers_raises(tiny, tmp_path, monkeypatch):
    ref_cfg = _ref_cfg(tmp_path)
    monkeypatch.setattr(tiny, "INIT_RULES", [r for r in tiny.INIT_RULES if r[0] is not tiny.Embeddings])
    with pytest.raises(ValueError, match="gen.embeddings.position"):
        make_weights(ref_cfg, 1, "cpu")
