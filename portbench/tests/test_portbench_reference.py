"""The plain reference against the four golden rankings of tests/data,
with the golden tests' semantics: the same pair set, and each pair's
score within 1e-6 relative of the printed value."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from portbench.reference import reference_ranking, reference_scores

GOLDEN = os.path.join(ROOT, "tests", "data")
DEFAULTS = {"score": "frob", "pseudocount": 0.8, "theta": "auto",
            "max_gap_fraction": 0.9, "min_separation": 5,
            "remove_dups": False}
CASES = [
    ("small.fasta.gz", "small.FNRout.txt", {}, 1176),
    ("small.fasta.gz", "small.DIRout.txt",
     {"score": "DI", "pseudocount": 0.2, "remove_dups": True}, 1176),
    ("small.fasta.gz", "small.DIRout2.txt",
     {"score": "DI", "pseudocount": 0.2, "theta": 0.0,
      "max_gap_fraction": 0.8, "min_separation": 4}, 1225),
    ("large.fasta.gz", "large.DIRout.txt",
     {"score": "DI", "pseudocount": 0.2, "remove_dups": True}, 78210),
]


def _golden(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            i, j, x = line.split()
            assert (int(i), int(j)) not in out
            out[(int(i), int(j))] = float(x)
    return out


@pytest.mark.parametrize("fasta,golden,settings,pairs", CASES,
                         ids=[c[1] for c in CASES])
def test_reference_reproduces_golden(fasta, golden, settings, pairs):
    st = dict(DEFAULTS, **settings)
    S, facts = reference_scores(os.path.join(GOLDEN, fasta), st)
    i, j, s = reference_ranking(S, st["min_separation"])
    assert len(s) == pairs and np.all(np.diff(s) <= 0)
    got = {(int(a), int(b)): x for a, b, x in zip(i, j, s)}
    want = _golden(os.path.join(GOLDEN, golden))
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-6,
                               atol=1e-12)
    if settings.get("theta") == 0.0:
        assert facts["meff"] == pytest.approx(facts["M"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference, portbench.reference.gdca; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gaussdca_tpu', 'gaussdca_tpu_torch'}; "
            "print(sorted(bad))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    from portbench.reference.gdca import to_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    # ties go to the even mantissa; below half a step rounds down
    want = [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]
    assert to_tf32(x).tolist() == want
