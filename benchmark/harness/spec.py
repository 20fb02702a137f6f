"""The benchmark's description, found by name.

``BENCHMARK.json`` at the root of the checkout lists configurations,
cells and metrics.  Everything that belongs to one of them is a file of
its own under ``benchmark/``:

* ``configs/<config>.json``: the configuration (the file its entry names);
* ``traffic/<mix>.json``: a traffic mix, read by the driver its ``kind``
  names (``harness/<kind>.py``);
* ``cells/<cell>.json``: a cell's limits for ``correct`` and its traced
  window;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_json() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of the per-layer metric ``name``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    cell: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def limits(self) -> Dict[str, float]:
        return dict(self.cell["limits"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a name it does not list."""
    bench = bench if bench is not None else benchmark_json()
    (work,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=work["chips"], config_name=conf["name"],
                config=_load_json(os.path.join(ROOT, conf["file"])),
                traffic_name=work["traffic"],
                traffic=_load_json(os.path.join(
                    HERE, "traffic", f"{work['traffic']}.json")),
                cell=_load_json(os.path.join(HERE, "cells", f"{name}.json")),
                end_to_end=e2e, per_layer=layer)
