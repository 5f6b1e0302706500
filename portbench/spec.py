"""What a cell is, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. Everything that belongs to
one of them sits in a file of its own under ``portbench/``:

- ``configs/<config>.json``: the settings the batch command runs with;
- ``traffic/<traffic>.json``: the mix the generator reads (``traffic.py``);
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader with ``read(run)`` that returns the
  metric's value, or None when it finds nothing to read.

A cell or a metric is added by adding files and entries; no file that is
there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files from
    ``bench_dir``; KeyError when no cell has that name."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"], traffic_name=entry["traffic"],
        config=_json(os.path.join(bench_dir, "configs",
                                  entry["config"] + ".json")),
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   entry["traffic"] + ".json")),
        limits=_json(os.path.join(bench_dir, "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, name, names)])


def reader(name: str, bench_dir: str = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
