"""Cells, configurations, mixes and metrics are found by name: a new one
is new files and new entries, and no file that was there changes."""

import hashlib
import json
import os

import pytest

from conftest import ROOT
from portbench import harness, spec

T0 = 0.0


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_benchmark_names_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.config["settings"]["dtype"] == "float32"
        assert {"missing", "pairs_off", "score_err"} <= set(cell.limits)
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("settings,options", [
    ({"min_separation": 3}, {"top_k": 10}),
    ({"mesh": "2,2"}, {"cache": True, "prefetch": False}),
], ids=["top_k", "mesh_cache"])
def test_new_cell_config_mix_and_metric_are_files_and_entries(
        bench_copy, settings, options):
    before = _digests(bench_copy)
    bench_dir = os.path.join(bench_copy, "portbench")
    cfg = json.load(open(os.path.join(bench_dir, "configs",
                                      "gdca-frob.json")))
    cfg["settings"].update(settings)
    with open(os.path.join(bench_dir, "configs", "sep3.json"), "w") as fh:
        json.dump(cfg, fh)
    mix = json.load(open(os.path.join(bench_dir, "traffic", "tiny.json")))
    mix["cli"].update(options)
    with open(os.path.join(bench_dir, "traffic", "tiny-top10.json"),
              "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench_dir, "limits", "sep3-top10.json"),
              "w") as fh:
        json.dump({"missing": 0, "pairs_off": 0, "score_err": 1e-3}, fh)
    with open(os.path.join(bench_dir, "metrics", "calls.count.py"),
              "w") as fh:
        fh.write("def read(run):\n    return len(run.calls)\n")
    with open(os.path.join(bench_copy, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "sep3", "source": "test",
                             "file": "portbench/configs/sep3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sep3-top10", "config": "sep3",
                               "traffic": "tiny-top10", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls.count", "unit": "1",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["sep3-top10"]})
    with open(os.path.join(bench_copy, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    result, _ = harness.run_cell(bench_copy, "sep3-top10", 3, 0.2, False,
                                 "cpu", T0, bench_dir=bench_dir)
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls.count"]["value"] >= 1
    assert {"family_s", "setup_s", "calls.count"} <= set(result["metrics"])
    after = _digests(bench_copy)
    assert {k: after[k] for k in before} == before
