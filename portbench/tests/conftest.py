"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells added, the way a later change adds one (new files and new
entries only)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# large enough that the control (TF32) fails the real cells' limits
TINY = {"why": "small families for the CPU tests", "families": 3,
        "M": {"log_uniform": [1000, 2000]}, "N": {"uniform": [60, 80]},
        "size_seed": 3, "q": 21, "mutation": 0.3, "founder_every": 32,
        "gzip_level": 6, "cli": {"prefetch": True, "top_k": None}}
# each tiny cell is judged by the limits of the real cell of its config
TINY_CELLS = {"tiny-frob": ("gdca-frob", "frob-mid"),
              "tiny-di": ("gdca-di", "di-wide")}


def add_tiny_cells(root: str) -> None:
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "traffic", "tiny.json"), "w") as fh:
        json.dump(TINY, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, (config, real) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "CPU tests"})
        shutil.copy(os.path.join(bench_dir, "limits", real + ".json"),
                    os.path.join(bench_dir, "limits", name + ".json"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and portbench/ with the tiny cells; returns
    its root."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    add_tiny_cells(root)
    return root
