"""The harness finds every cell's configuration, traffic, metric readers and
limits by name, refuses a name it lacks, and ``BENCHMARK.json`` keeps the
contract's shape."""

import json
import os
import re

import pytest

from perfbench import correctness, spec
from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    assert c.config["name"] == c.config_name and c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "train_slices_per_s"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    for k in correctness.CHECKS:
        assert k in c.limits and (c.limits[k] is None or c.limits[k] >= 0)
    assert any(c.limits[k] is not None for k in correctness.CHECKS)


@pytest.mark.parametrize("field,value", [("workload", "no-such-cell"), ("config", "no-such-config"),
                                         ("traffic", "no-such-mix")])
def test_an_unknown_name_is_refused(field, value):
    bench = json.loads(json.dumps(BENCH))
    w = bench["workloads"][0]
    name = w["name"]
    if field == "workload":
        name = value
    else:
        w[field] = value
    with pytest.raises(spec.UnknownName):
        spec.resolve(name, bench)


def test_a_metric_without_a_reader_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "no.such_metric", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "step", "moves": "train_slices_per_s"})
    with pytest.raises(spec.UnknownName):
        spec.resolve(bench["workloads"][0]["name"], bench)


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and m["layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
