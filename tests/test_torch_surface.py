"""PyTorch port: the reweighting kernels on the golden alignments and
``gdca()``'s ``top_k`` against the JAX package and the golden files (CPU,
f64).

- the golden alignments through every distance kernel's plain version
  (``row_stats_asym``, ``row_stats_full``, ``row_stats_sym_e8`` as
  ``row_stats_fn`` of ``compute_weights_streaming``, and the dense
  ``compute_weights``): W, Meff and theta equal to the default path's;
- ``top_k`` against the head of the full ranking, the golden files and
  the JAX ``top_k_device``, on one device and through a mesh.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.score import rank as jrank
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch import gdca
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.ops import distance
from gaussdca_tpu_torch.parallel.mesh import Mesh
from gaussdca_tpu_torch.score import rank as trank
from gaussdca_tpu_torch.stats import reweight

F64 = torch.float64

GOLDEN = {
    "small.FNRout.txt": ("small.fasta.gz", dict()),
    "small.DIRout.txt": ("small.fasta.gz",
                         dict(pseudocount=0.2, score="DI", remove_dups=True)),
    "small.DIRout2.txt": ("small.fasta.gz",
                          dict(pseudocount=0.2, score="DI", theta=0.0,
                               max_gap_fraction=0.8, min_separation=4)),
}


def _todict(R):
    return {(i, j): x for i, j, x in R}


def _load_golden(path):
    want = {}
    for line in open(path):
        i, j, x = line.split()
        want[(int(i), int(j))] = float(x)
    return want


_WEIGHTS = {
    "row_stats_asym": lambda Z, th, q: reweight.compute_weights_streaming(
        Z, th, q, dtype=F64, row_stats_fn=distance.row_stats_asym),
    "row_stats_full": lambda Z, th, q: reweight.compute_weights_streaming(
        Z, th, q, dtype=F64, row_stats_fn=distance.row_stats_full),
    "row_stats_sym_e8": lambda Z, th, q: reweight.compute_weights_streaming(
        Z, th, q, dtype=F64, row_stats_fn=distance.row_stats_sym_e8),
    "match_counts": lambda Z, th, q: reweight.compute_weights(
        Z, th, dtype=F64, q=q),
}


@pytest.mark.parametrize("name", ["small.fasta.gz", "large.fasta.gz"])
@pytest.mark.parametrize("kernel", sorted(_WEIGHTS))
def test_golden_weights_on_every_distance_kernel(golden_dir, name, kernel):
    """Each kernel's plain version gives the default path's W, Meff and
    theta exactly on a real alignment, at auto-theta and at 0.2."""
    msa = fasta.read_fasta_alignment(os.path.join(golden_dir, name), 0.9)
    Z = torch.as_tensor(msa.tokens)
    for theta in ("auto", 0.2):
        W0, Meff0, th0 = reweight.compute_weights_streaming(
            Z, theta, msa.q, dtype=F64)
        W1, Meff1, th1 = _WEIGHTS[kernel](Z, theta, msa.q)
        assert torch.equal(W1, W0)
        assert float(Meff1) == float(Meff0) and float(th1) == float(th0)


def _small_msa(golden_dir):
    return fasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9)


@pytest.mark.parametrize("golden", sorted(GOLDEN))
def test_top_k_matches_golden_head(golden_dir, golden):
    """``gdca(..., top_k=50)`` gives the golden ranking's head: the same
    pairs, ties at the cut aside, at the golden gate (the small files: the
    large DI run takes over a minute on the CPU)."""
    fa, kw = GOLDEN[golden]
    want = _load_golden(os.path.join(golden_dir, golden))
    head = gdca(os.path.join(golden_dir, fa), dtype=F64, device="cpu",
                top_k=50, **kw)
    assert len(head) == 50
    ranked = sorted(want.items(), key=lambda t: -t[1])
    cut = ranked[49][1]
    sure = {p for p, x in ranked[:50] if x != cut}
    assert sure <= set(_todict(head.ranking))
    for i, j, s in head.ranking:
        assert s == pytest.approx(want[(i, j)], rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("score,pc,solve_min_dim", [
    ("frob", 0.8, 4096), ("DI", 0.2, 8)])
def test_mesh_top_k_matches_one_device(golden_dir, score, pc,
                                       solve_min_dim):
    """``top_k`` through a 2 x 2 CPU mesh (replicated and storage-sharded
    solve) against the one-device full ranking's head."""
    msa = _small_msa(golden_dir)
    cfg = GDCAConfig(score=score, pseudocount=pc, dtype=F64, device="cpu",
                     solve_min_dim=solve_min_dim)
    base = tapi.gdca_from_msa(msa, cfg)
    mesh = Mesh(["cpu"] * 4, (2, 2))
    head = tapi.gdca_from_msa(msa, cfg, top_k=30, mesh=mesh)
    assert len(head) == 30
    want = _todict(base.ranking[:60])
    for i, j, s in head.ranking:
        assert s == pytest.approx(want[(i, j)], rel=1e-9)


def test_gdca_convenience_kwargs(golden_dir):
    """gdca() takes ``top_k``: on one device the selection is the full
    ranking's head itself."""
    path = os.path.join(golden_dir, "small.fasta.gz")
    full = gdca(path, dtype=F64, device="cpu")
    head = gdca(path, dtype=F64, device="cpu", top_k=25)
    assert head.ranking == full.ranking[:25]
    assert head.theta == full.theta and head.meff == full.meff


@pytest.mark.parametrize("N,m,k", [(30, 5, 40), (12, 3, 1000), (8, 9, 5),
                                   (20, 1, 190)])
def test_top_k_device_matches_jax(N, m, k):
    rng = np.random.default_rng(N * m + k)
    S = rng.random((N, N))
    S = (S + S.T) / 2
    got = trank.top_k_device(torch.as_tensor(S), m, k)
    want = jrank.top_k_device(jnp.asarray(S), m, k)
    assert got == want
    assert got == trank.compute_ranking(S, m)[:len(got)]
    if got:
        assert got == jrank.top_k_ranking(S, m, k)


def test_top_k_keeps_the_non_finite_guard():
    S = torch.full((10, 10), float("nan"), dtype=F64)
    with pytest.raises(ArithmeticError, match="positive definite"):
        tapi._checked_ranking(S, 2, 5)
    with pytest.raises(ArithmeticError, match="positive definite"):
        tapi._checked_ranking(S, 2)
