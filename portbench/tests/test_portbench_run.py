"""The command on a machine without a card, and the harness's CPU path
loads no JAX module."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "di-wide",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


# run.py as the driver starts it, with the card's look answered yes, so
# that the run goes past it to the program
NO_PROGRAM = r"""
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ["portbench/run.py", "--workload", "di-wide", "--seed",
            str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"]
runpy.run_path("portbench/run.py", run_name="__main__")
"""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    str(tmp_path / "portbench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", NO_PROGRAM],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "No module named 'gaussdca_tpu_torch'" in out.stderr, \
        out.stderr[-2000:]


CPU_RUN = r"""
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import add_tiny_cells
from portbench import harness
add_tiny_cells({copy!r})
res, lines = harness.run_cell({copy!r}, "tiny-frob", 11, 0.3, {trace},
                              "cpu", time.perf_counter(),
                              bench_dir={copy!r} + "/portbench")
print(json.dumps({{"correct": res["correct"],
                  "bad": harness.forbidden_modules(),
                  "torch_port": "gaussdca_tpu_torch" in sys.modules}}))
"""


def test_cpu_path_loads_no_jax(tmp_path):
    for trace in (False, True):
        copy = str(tmp_path / f"checkout{int(trace)}")
        shutil.copytree(os.path.join(ROOT, "portbench"),
                        os.path.join(copy, "portbench"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
        code = CPU_RUN.format(root=ROOT, tests=os.path.dirname(__file__),
                              copy=copy, trace=trace)
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.splitlines()[-1])
        assert got == {"correct": True, "bad": [], "torch_port": True}
