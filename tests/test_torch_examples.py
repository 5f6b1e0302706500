"""PyTorch port: the two examples run as scripts on the CPU.

- ``examples/multichip_torch.py --device cpu`` on the small golden
  family: ``gdca(path)`` and ``gdca(path, mesh=...)`` over eight CPU
  shards agree;
- ``examples/recover_contacts_torch.py --device cpu --dtype float64``
  recovers every planted pair.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_multichip_example_agrees(golden_dir):
    out = _run("multichip_torch.py",
               os.path.join(golden_dir, "small.fasta.gz"), "--device", "cpu")
    assert out[0].startswith("devices: 8  M=106 N=53 q=21")
    assert out[1].startswith("top-5 (sharded): [(11, 35, ")
    assert out[-1] == ("single-chip == sharded (to f32 summation order): "
                       "True")


@pytest.mark.parametrize("score", ["frob", "DI"])
def test_recover_contacts_example(score):
    out = _run("recover_contacts_torch.py", "--score", score, "--seqs",
               "800", "--cols", "40", "--pairs", "5", "--device", "cpu",
               "--dtype", "float64")
    assert out[-1].startswith("recovered 5/5 planted pairs (theta=0.200")
