"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``perfbench/traffic/<mix>.json``;
the configuration's ``arch`` (the U-Net where it names none) names its
generator, ``perfbench/reference/arch/<arch>.py``; every metric it reports
has a reader, ``perfbench/metrics/<metric>.py``; the limits that decide
``correct`` are ``perfbench/limits/<cell>.json``. A new cell, mix, metric or
architecture is new files: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

from perfbench.reference import arch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class UnknownName(ValueError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json metric entries this cell reports
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise UnknownName(f"{what}: no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(metric: str) -> str:
    return os.path.join(HERE, "metrics", f"{metric}.py")


def resolve(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` with its configuration, traffic, metrics and
    limits; raises ``UnknownName`` for a name ``BENCHMARK.json`` lacks or a
    file that is not there."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise UnknownName(f"no workload {workload!r} in BENCHMARK.json (known: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise UnknownName(f"workload {workload!r} names the configuration {w['config']!r}, which BENCHMARK.json lacks")
    cfg = _json(os.path.join(ROOT, configs[w["config"]]["file"]), f"configuration {w['config']!r}")
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"), f"traffic {w['traffic']!r}")
    try:
        arch.check({**cfg["uda_config"], **traffic.get("uda_config", {})}.get("arch", "unet"))
    except arch.UnknownArch as e:
        raise UnknownName(f"configuration {w['config']!r}: {e}") from None
    cell = Cell(workload, int(w["chips"]), w["config"], cfg, w["traffic"], traffic,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                _json(os.path.join(HERE, "limits", f"{workload}.json"), f"limits of {workload!r}"))
    for m in cell.end_to_end + cell.per_layer:
        if not os.path.isfile(reader_path(m["name"])):
            raise UnknownName(f"metric {m['name']!r}: no reader perfbench/metrics/{m['name']}.py")
    return cell


def reader_module(metric: str):
    """The module ``perfbench/metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                  reader_path(metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
    return reader_module(metric).read


def recorded_functions(cell: Cell) -> list:
    """The program's functions whose calls set-up's first step records for
    the cell's readers: the union, in the readers' order, of the dotted names
    (``package.module.function``) each reader lists in its ``RECORD``."""
    names: list = []
    for m in cell.end_to_end + cell.per_layer:
        for name in getattr(reader_module(m["name"]), "RECORD", ()):
            if name not in names:
                names.append(name)
    return names
