"""PyTorch port: planted covarying pairs must dominate the ranking (CPU,
f64), the method's own check, independent of the golden files; the
port's twin of ``tests/test_recovery.py``, through
``examples/recover_contacts_torch.py``.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
from recover_contacts import synth_msa as jax_synth_msa  # noqa: E402
from recover_contacts_torch import recover, synth_msa  # noqa: E402

SYNTH = dict(M=800, N=40, n_pairs=5, copy_p=0.9, seed=3)


def test_synth_msa_is_the_jax_examples():
    Z, planted = synth_msa(**SYNTH)
    Zj, planted_j = jax_synth_msa(**SYNTH)
    assert Z.dtype == Zj.dtype
    np.testing.assert_array_equal(Z, Zj)
    assert planted == planted_j and len(planted) == 5


@pytest.mark.parametrize("score", ["frob", "DI"])
def test_planted_pairs_recovered(score):
    """frob (pc 0.8) and DI (pc 0.2), theta 0.2: every planted pair is in
    the top 5."""
    Z, planted = synth_msa(**SYNTH)
    res, top, hits = recover(Z, planted, score, device="cpu",
                             dtype="float64")
    assert res.theta == 0.2
    assert hits == len(planted), (
        f"recovered only {hits}/{len(planted)}: top={sorted(top)} "
        f"planted={planted}")


def test_recovery_with_phylogenetic_redundancy():
    """Planted pairs still surface when near-duplicate (phylogenetically
    clustered) sequences dominate the MSA, the regime reweighting exists
    for (the JAX package's test of the same name, auto-theta, pc 0.8)."""
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.interop import msa_from_arrays

    rng = np.random.default_rng(11)
    q, N = 21, 40
    n_founders, copies = 40, 20
    founders = rng.integers(1, q + 1, size=(n_founders, N), dtype=np.int8)
    pairs = [(3, 11), (8, 20), (15, 33)]
    for (i, j) in pairs:
        perm = rng.permutation(q) + 1
        founders[:, j - 1] = perm[founders[:, i - 1] - 1]
    rows = []
    for f in founders:
        for _ in range(copies):
            child = f.copy()
            mut = rng.random(N) < 0.02
            child[mut] = rng.integers(1, q + 1, size=mut.sum())
            rows.append(child)
    Z = np.stack(rows)
    msa = msa_from_arrays(Z, q, [f"s{k}" for k in range(len(Z))])
    res = api.gdca_from_msa(msa, GDCAConfig(pseudocount=0.8,
                                            dtype="float64", device="cpu"))
    # reweighting collapses each cluster: Meff far below M
    assert res.meff < len(Z) / 4
    top = {(i, j) for i, j, _ in res.ranking[:len(pairs)]}
    assert all(p in top for p in pairs), (res.ranking[:5], pairs, res.meff)
